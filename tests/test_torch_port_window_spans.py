"""The window kernel's packed and banded forms on the CPU, against the JAX
package (``JAX_PLATFORMS=cpu``, the Pallas kernels in interpret mode), bit
for bit in f32 and bf16.

- ``window_gather_banded_ref(..., unsort=True)``, with and without the
  observation's epilogue keywords (liveness; pooled minimap, self cell and
  minimap channels), against JAX ``window_gather_banded`` followed by the
  JAX observation's banded route (magent_tpu/core/observe.py:378-401: the
  epilogue in band order in f32, a second rounding, the row gather back to
  slot order); and ``window_gather_banded`` itself, which takes the plain
  version on CPU tensors.
- Battle forced onto the banded route (``VMEM_IMAGE_BUDGET = 1`` in both
  packages; the JAX package's kernel route in interpret mode): minimap
  views, self mark and the bf16 double rounding equal the JAX package's
  views, before and after a step, with 10% dead agents.
- A numpy twin of ``window_gather_kernel``'s packed (``window_gather4``)
  and banded forms in ``magent_tpu_torch/csrc/window_gather.cu``, written
  branch for branch like ``tests/test_torch_port_gather_split.py``'s twin
  of the unpacked form: the per-value table (offset, mask, minimap mask,
  minimap cell), each span's per-agent records (image offset or -1, the
  env image's end, liveness, self cell, the env's minimap offset), a
  lane's values picking between two agents' records by select (wide
  windows) or stepping agent by agent (narrow ones), the row test against
  the env image's end, and the epilogue with the banded form's first
  rounding.  Replayed over ``gather_spans`` in the split ``gather_split``
  picks and in spans of one warp tile (which cross agents and envs), held
  against the Pallas kernels: ``window_gather4`` in its forms, and the
  banded kernel in band order (dummy rows, rows past the image) and in
  slot order with the observation's epilogue.  The CUDA kernel itself is
  held against its plain versions on the card (tests/test_torch_port_gpu.py,
  chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.core import observe as jobserve
from magent_tpu.ops import window_gather as jwg

from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.ops import window_gather as twg

from _torch_port_cases import (Pair, arrays_of, biased_actions, jax_state,
                               key_pair, perturb, port_state)
from test_torch_port_gather_split import H100_SMS, _f32_quotient

DTYPES = {"f32": (torch.float32, jnp.float32, torch.int32, np.int32),
          "bf16": (torch.bfloat16, jnp.bfloat16, torch.int16, np.uint16)}
FORMS = ("none", "liveness", "minimap")
# (vh, vw, C): pursuit's predator window, 10 x 50 (wide in f32 and bf16),
# and a 3 x 15 one (E = 45: the stepping branch in either dtype)
WINDOWS = {"wide": (10, 10, 5), "narrow": (3, 3, 5)}
B = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bits_equal(got, want, dtype, tag=""):
    """``got`` a torch tensor, ``want`` a JAX or numpy array of the same
    dtype: the same bits, sign bits of zeros included."""
    t_dt, j_dt, t_bits, n_bits = DTYPES[dtype]
    want = np.asarray(want)
    assert got.dtype == t_dt and want.dtype == j_dt, (tag, got.dtype,
                                                       want.dtype)
    assert tuple(got.shape) == want.shape, (tag, got.shape, want.shape)
    np.testing.assert_array_equal(
        got.view(t_bits).numpy().view(n_bits), want.view(n_bits),
        err_msg=tag)


def _case(seed, vh, vw, C, N, map_size=24, bottom=False):
    """A signed image over the padded geometry of a ``map_size`` map (the
    mask's zeros give -0.0 where it is negative), unpacked top-left cells
    of in-map agents (with ``bottom``, every fifth one on the image's
    second-to-last row: its window reaches past the image), a mask with
    zeros, and the epilogue's operands: liveness (20% dead), pooled
    minimaps over two channels, the channels, self cells."""
    rng = np.random.RandomState(seed)
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(map_size, map_size, C,
                                                      vh, vw)
    img = rng.uniform(-0.5, 1.0, size=(B, Hp, lanes)).astype(np.float32)
    ys = rng.randint(0, map_size, size=(B, N)) + pad_y - vh // 2
    xs = rng.randint(0, map_size, size=(B, N)) + pad_x - vw // 2
    if bottom:
        ys[:, ::5] = Hp - 2
    mask = (rng.uniform(size=(vh, vw * C)) < 0.7).astype(np.float32)
    ch = np.zeros(C, np.float32)
    ch[[2, C - 1]] = 1.0
    return dict(
        img=img, pos=(ys * Wp + xs).astype(np.int32), mask=mask,
        act=(rng.uniform(size=(B, N)) < 0.8).astype(np.int32),
        mm=(rng.uniform(size=(B, vh, vw, C)) * ch).astype(np.float32),
        mm_maskc=ch, self_cell=rng.randint(0, vh * vw, size=(B, N)).astype(
            np.int32), kw=dict(vh=vh, vw=vw, C=C, Wp=Wp))


# ------------------------------------------------------ the JAX references
def _jax_route(out_b, inv, act, mm, self_cell, mm_maskc, obs_dtype):
    """The JAX observation's banded route after its kernel
    (magent_tpu/core/observe.py:378-401), on the band-ordered windows
    ``out_b`` [B, n_pad, vh, vwc] (``obs_dtype``) and ``inv``: the epilogue
    in band order, ``astype(obs_dtype)``, the row gather to slot order."""
    Bn, n_pad_b, vh, vwc = out_b.shape
    C = mm_maskc.shape[0] if mm is not None else None
    bidx = jnp.arange(Bn)[:, None]
    act_b = jnp.zeros((Bn, n_pad_b), jnp.float32).at[bidx, inv].set(
        jnp.asarray(act).astype(jnp.float32))
    if mm is not None:
        vw = vwc // C
        out_b = out_b.reshape(Bn, n_pad_b, vh, vw, C)
        sc_b = jnp.zeros((Bn, n_pad_b), jnp.int32).at[bidx, inv].set(
            jnp.asarray(self_cell))
        self_mark_b = jax.nn.one_hot(sc_b, vh * vw, dtype=jnp.float32)
        out_b = (out_b + jnp.asarray(mm)[:, None]
                 + self_mark_b.reshape(Bn, n_pad_b, vh, vw)[..., None]
                 * jnp.asarray(mm_maskc)[None, None, None, None, :])
        out_b = out_b.reshape(Bn, n_pad_b, vh, vwc)
    out_b = out_b * act_b[:, :, None, None]
    out_b = out_b.astype(obs_dtype).reshape(Bn, n_pad_b, vh * vwc)
    view = jnp.take_along_axis(out_b, inv[:, :, None], axis=1)
    return view.reshape(Bn, inv.shape[1], vh, vwc)


def _jax_banded(c, form, jdtype, chunk, band_rows):
    """JAX window_gather_banded in interpret mode, then the observation's
    route with the form's epilogue (``none``: the function's own
    ``unsort=True``)."""
    args = (jnp.asarray(c["img"]), jnp.asarray(c["pos"]),
            jnp.asarray(c["mask"]))
    band = dict(c["kw"], chunk=chunk, band_rows=band_rows, interpret=True,
                out_dtype=jdtype)
    if form == "none":
        return jwg.window_gather_banded(*args, **band)
    out_b, inv = jwg.window_gather_banded(*args, **band, unsort=False)
    minimap = form == "minimap"
    return _jax_route(out_b, inv, c["act"], c["mm"] if minimap else None,
                      c["self_cell"], c["mm_maskc"], jdtype)


def _port_epi(c, form):
    ops = {}
    if form != "none":
        ops["act"] = _t(c["act"])
    if form == "minimap":
        ops.update(mm=_t(c["mm"]), self_cell=_t(c["self_cell"]),
                   mm_maskc=_t(c["mm_maskc"]))
    return ops


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk,band_rows", [(8, 16), (40, 32)])
def test_banded_ref_epilogue_matches_jax_route(form, dtype, chunk,
                                               band_rows):
    """``window_gather_banded_ref(..., unsort=True)`` and the entry point
    on CPU tensors, with the form's epilogue keywords, equal the JAX
    kernel followed by the JAX observation's banded route, bit for bit;
    windows on the image's second-to-last row reach past it."""
    c = _case(chunk + band_rows, 7, 7, 5, 37, bottom=True)
    t_dt, j_dt = DTYPES[dtype][:2]
    want = _jax_banded(c, form, j_dt, chunk, band_rows)
    args = (_t(c["img"]), _t(c["pos"]), _t(c["mask"]))
    for fn in (twg.window_gather_banded_ref, twg.window_gather_banded):
        got = fn(*args, **c["kw"], chunk=chunk, band_rows=band_rows,
                 out_dtype=t_dt, **_port_epi(c, form))
        assert_bits_equal(got, want, dtype, "%s %s" % (fn.__name__, form))
    assert bool((got != 0).any())


def test_banded_epilogue_arguments_checked():
    c = _case(0, 3, 3, 5, 4)
    args = (_t(c["img"]), _t(c["pos"]), _t(c["mask"]))
    epi = _port_epi(c, "minimap")
    with pytest.raises(ValueError, match="come together"):
        twg.window_gather_banded(*args, **c["kw"], act=epi["act"],
                                 mm=epi["mm"])
    with pytest.raises(ValueError, match="comes with act"):
        twg.window_gather_banded(*args, **c["kw"], **{
            k: v for k, v in epi.items() if k != "act"})
    with pytest.raises(ValueError, match="unsort=True"):
        twg.window_gather_banded(*args, **c["kw"], act=epi["act"],
                                 unsort=False)


# ------------------------------------------- battle on the banded route
@pytest.fixture(scope="module")
def battle_pair():
    return Pair("battle", 24, [12, 12], 2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_battle_banded_views_match_jax(battle_pair, dtype, monkeypatch):
    """Battle (minimap on) with both packages' image budget shrunk to 1
    byte: the port's banded route (the windows, then the minimap, self mark
    and liveness epilogue per value, rounded at the kernel's store and
    again after the epilogue) equals the JAX package's banded kernel route
    in interpret mode, views bit for bit and features exactly, on a
    perturbed state with 10% dead agents and after a step."""
    monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 1)
    monkeypatch.setattr(jobserve, "VMEM_IMAGE_BUDGET", 1)
    pair = battle_pair
    assert pair.spec.minimap_mode
    t_dt, j_dt = DTYPES[dtype][:2]
    t_obs = [tobserve.make_observe(pair.spec, g, obs_dtype=t_dt)
             for g in range(2)]
    j_obs = [jobserve.make_observe(pair.jv.spec, g, interpret=True,
                                   obs_dtype=j_dt) for g in range(2)]
    assert [o.route for o in t_obs] == ["window_gather_banded"] * 2
    assert all(o.uses_banded for o in j_obs)
    j_obs = [jax.jit(o) for o in j_obs]
    jkey, _ = key_pair(9)
    arrays = perturb(arrays_of(pair.reset(jkey)), pair.spec, 9,
                     dead_frac=0.1)
    js, ts = jax_state(arrays), port_state(arrays)
    for tag in ("reset", "step"):
        for g in range(2):
            (tv, tf), (jv, jf) = t_obs[g](ts), j_obs[g](js)
            assert_bits_equal(tv, jv, dtype, "%s group %d" % (tag, g))
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            assert bool((tv != 0).any())
        actions = biased_actions(pair.spec, 2, 9)
        js = pair.step(js, jnp.asarray(actions))
        ts = pair.tv.step(ts, torch.from_numpy(actions))


# ----------------------------------------------------- the kernel's twin
def _twin(c, *, form, packed, out_dtype, per, pos=None):
    """window_gather_kernel's packed or banded form in numpy, branch for
    branch, over ``pos`` (default ``c["pos"]``; packed: ``tl * 1024 +
    self_cell``) with ``form``'s epilogue -> [B, N, vh, vwc] in
    ``out_dtype``."""
    img, mask = c["img"], c["mask"]
    vh, vw, C, Wp = (c["kw"][k] for k in ("vh", "vw", "C", "Wp"))
    pos = c["pos"] if pos is None else pos
    Bn, Hp, lanes = img.shape
    N = pos.shape[1]
    vwc = vw * C
    E = vh * vwc
    kvec = twg.vec_width(out_dtype)
    tile_len = 32 * kvec
    flat_img = img.reshape(-1)
    flat_mask = mask.reshape(-1)
    mm_on, act_on = form == "minimap", form != "none"
    # the per-value table: offset, mask; minimap mask and cell
    e = np.arange(E)
    r = _f32_quotient(e, np.float32(1) / np.float32(vwc))
    cc = e - r * vwc
    r, cc = np.where(cc < 0, r - 1, np.where(cc >= vwc, r + 1, r)), \
        np.where(cc < 0, cc + vwc, np.where(cc >= vwc, cc - vwc, cc))
    off = r * lanes + cc
    q = cc // C
    cell = r * vw + q
    if packed:
        tab_mmm = np.tile(c["mm_maskc"], (vh, vw)).reshape(-1)[e]
    else:
        tab_mmm = c["mm_maskc"][cc - q * C]
    mm_flat = c["mm"].reshape(-1)
    # every agent's record
    p = pos.reshape(-1).astype(np.int64)
    b = np.arange(Bn * N) // N
    tl = p >> 10 if packed else p
    yy = tl // Wp
    xx = tl - yy * Wp
    rows_in = yy + vh <= Hp if packed else yy < Hp
    ok = (p >= 0) & rows_in & (xx * C + vwc <= lanes)
    base = np.where(ok, b * Hp * lanes + yy * lanes + xx * C, -1)
    limit = (b + 1) * Hp * lanes
    none = np.zeros(Bn * N, np.int64)  # operands of an epilogue not run
    live = c["act"].reshape(-1).astype(np.float32) if act_on else none
    selfc = p & 1023 if packed else (c["self_cell"].reshape(-1) if mm_on
                                     else none)
    mmo = b * E
    wide = E > 32 * (kvec - 1)

    def rounded(v):
        return torch.from_numpy(v).to(out_dtype).to(torch.float32).numpy()

    out = np.empty(Bn * N * E, np.float32)
    for start, end in twg.gather_spans(Bn, N, E, out_dtype, per):
        a0 = start // E
        w0 = start - a0 * E
        ga = a0 + np.arange(per * kvec // E + 3)
        real = ga < Bn * N
        gi = np.minimum(ga, Bn * N - 1)
        s_base = np.where(real, base[gi], -1)
        s_limit = np.where(real, limit[gi], 0)
        s_act = np.where(real, live[gi], np.float32(0))
        s_self = np.where(real, selfc[gi], -1)
        s_mm = np.where(real, mmo[gi], 0)

        def value(ak, wk):
            bse = s_base[ak]
            okv = bse >= 0
            if not packed:  # rows past the image: the env image's end
                okv = okv & (bse + off[wk] < s_limit[ak])
            val = flat_img[np.where(okv, bse + off[wk], 0)]
            v = np.where(okv, val * flat_mask[wk], np.float32(0))
            if not packed and act_on:  # the kernel's store, before the
                v = rounded(v)         # observation's epilogue
            if mm_on:
                v = v + mm_flat[s_mm[ak] + wk]
                v = v + np.where(cell[wk] == s_self[ak], tab_mmm[wk],
                                 np.float32(0))
            if act_on:
                v = v * s_act[ak]
            return v

        n_tiles = -(-(end - start) // tile_len)
        x = w0 + (np.arange(n_tiles)[:, None] * tile_len
                  + np.arange(32)[None, :])  # [tile, lane]
        a = _f32_quotient(x, np.float32(1) / np.float32(E))
        a += (x - a * E >= E).astype(np.int64) - (x - a * E < 0)
        w = x - a * E
        vals = np.empty((n_tiles, kvec, 32), np.float32)
        for k in range(kvec):
            if wide:  # two agents' records, picked per value
                nxt = w + 32 * k >= E
                vals[:, k] = value(np.where(nxt, a + 1, a),
                                   w + 32 * k - np.where(nxt, E, 0))
            else:
                if k:
                    w = w + 32
                    while (w >= E).any():  # the next agent's window
                        step = w >= E
                        w = np.where(step, w - E, w)
                        a = np.where(step, a + 1, a)
                vals[:, k] = value(a, w)
        out[start:end] = vals.reshape(-1)[:end - start]
    return torch.from_numpy(out).reshape(Bn, N, vh, vwc).to(out_dtype)


def _pers(out_dtype, N, E):
    """The split gather_split picks for B envs of N windows of E values,
    and one warp tile per span."""
    return (twg.gather_split(B, N, E, out_dtype, H100_SMS), 32)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [1, 3, 37])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_packed_twin_matches_jax(form, dtype, N, window):
    """The packed form (``window_gather4``) over a signed image with each
    epilogue: equal to the Pallas replica kernel in interpret mode (its
    no-epilogue windows times ``act`` for the liveness form, which the JAX
    kernel fuses only with the minimap), bit for bit; N = 1 and 3 put
    several envs in a span."""
    vh, vw, C = WINDOWS[window]
    c = _case(N * 7 + vh, vh, vw, C, N)
    t_dt, j_dt = DTYPES[dtype][:2]
    packed = c["pos"] * 1024 + c["self_cell"]
    j_ops = {}
    if form == "minimap":
        j_ops = dict(mm_img=jnp.asarray(c["mm"].reshape(B, vh, vw * C)),
                     mm_mask=jnp.asarray(np.tile(c["mm_maskc"], (vh, vw))),
                     act=jnp.asarray(c["act"]))
    want = jwg.window_gather4(jnp.asarray(c["img"]), jnp.asarray(packed),
                              jnp.asarray(c["mask"]), **j_ops, chunk=8,
                              interpret=True, out_dtype=j_dt, **c["kw"])
    if form == "liveness":
        want = want * jnp.asarray(c["act"], j_dt)[..., None, None]
    E = vh * vw * C
    for per in _pers(t_dt, N, E):
        got = _twin(c, form=form, packed=True, out_dtype=t_dt, per=per,
                    pos=packed)
        assert_bits_equal(got, want, dtype, "per %d" % per)
    assert bool((got == 0).logical_and(got.signbit()).any()) or \
        form != "none"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [3, 37])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_banded_twin_band_order_matches_jax(dtype, N, window):
    """The banded form over the band table's positions (the ``unsort=False``
    form): dummy rows at their band's first row, windows of the last band
    and of the image's second-to-last row reaching past the image: equal to
    the Pallas banded kernel's band-ordered windows, bit for bit."""
    vh, vw, C = WINDOWS[window]
    c = _case(N * 11 + vh, vh, vw, C, N, bottom=True)
    t_dt, j_dt = DTYPES[dtype][:2]
    want, inv = jwg.window_gather_banded(
        jnp.asarray(c["img"]), jnp.asarray(c["pos"]), jnp.asarray(c["mask"]),
        **c["kw"], chunk=8, band_rows=16, interpret=True, out_dtype=j_dt,
        unsort=False)
    Hp = c["img"].shape[1]
    pos_pad = twg.banded_tables(_t(c["pos"]), Wp=c["kw"]["Wp"], band_rows=16,
                                n_bands=-(-Hp // 16), chunk=8)[0].numpy()
    n_pad = pos_pad.shape[1]
    E = vh * vw * C
    for per in _pers(t_dt, n_pad, E):
        got = _twin(c, form="none", packed=False, out_dtype=t_dt, per=per,
                    pos=pos_pad)
        assert_bits_equal(got, want, dtype, "per %d" % per)
    # some windows lose rows to the image's end
    assert int(((pos_pad // c["kw"]["Wp"]) + vh > Hp).sum()) > 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [1, 3, 37])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_banded_twin_slot_order_matches_jax(form, dtype, N, window):
    """The banded form over slot-order positions with each epilogue (the
    observation's: rounded to the output dtype before it): equal to the
    Pallas banded kernel followed by the JAX observation's banded route,
    bit for bit; windows reach past the image's last row."""
    vh, vw, C = WINDOWS[window]
    c = _case(N * 13 + vh, vh, vw, C, N, bottom=True)
    t_dt, j_dt = DTYPES[dtype][:2]
    want = _jax_banded(c, form, j_dt, 8, 16)
    E = vh * vw * C
    for per in _pers(t_dt, N, E):
        got = _twin(c, form=form, packed=False, out_dtype=t_dt, per=per)
        assert_bits_equal(got, want, dtype, "per %d" % per)
