"""Plain versions of the port's rect kernels and of the fused-epilogue window
gather against the JAX package: ``occupant_rect``, ``rect_first_overlap``
and ``window_gather4``, each held against the Pallas kernel in interpret
mode and its ``*_xla`` reference on the same numpy-seeded inputs.  The
port's wrappers take their plain versions on CPU tensors, so they are held
too; the CUDA kernels are held against the plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).

Tolerances: every int result exact; hp sums exact (bodies are disjoint, so
at most one term is non-zero); windows exact, the minimap epilogue against
the JAX side at atol 1e-6 (MINIMAP_ATOL)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import attack_prefix as jap
from magent_tpu.ops import window_gather as jwg

from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.ops import window_gather as twg

from _torch_port_cases import MINIMAP_ATOL

B = 2
# body sizes by max_body: 2 is pursuit's (2x2 predators, 1x1 prey), 3 the
# mixed config of tests/test_gridless.py:362 (2x2 blocks, 1x3 snakes)
SIZES = {2: [(2, 2), (1, 1)], 3: [(2, 2), (1, 3), (1, 1)]}
# (A, max_body): A ragged over the kernel's 128-slot tiles
CASES = [(97, 2), (300, 2), (97, 3), (300, 3)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bodies(A, MB, seed):
    """Disjoint body rects of A slots on a map with room for them, a sixth
    dead (empty rect kept at its coordinates, as the engine gates them);
    two dead slots share coordinates, so empty rects coincide."""
    rng = np.random.RandomState(seed)
    S = int(np.sqrt(A * 6)) + 4
    x = np.zeros((B, A), np.int32)
    y = np.zeros((B, A), np.int32)
    bw = np.zeros((B, A), np.int32)
    bh = np.zeros((B, A), np.int32)
    for b in range(B):
        taken = np.zeros((S, S), bool)
        for a in range(A):
            w, h = SIZES[MB][rng.randint(len(SIZES[MB]))]
            while True:
                xx, yy = rng.randint(1, S - w), rng.randint(1, S - h)
                if not taken[yy:yy + h, xx:xx + w].any():
                    break
            taken[yy:yy + h, xx:xx + w] = True
            x[b, a], y[b, a], bw[b, a], bh[b, a] = xx, yy, w, h
    dead = rng.uniform(size=(B, A)) < 1 / 6
    dead[:, :2] = True
    x[:, 1], y[:, 1] = x[:, 0], y[:, 0]
    bw = np.where(dead, 0, bw).astype(np.int32)
    bh = np.where(dead, 0, bh).astype(np.int32)
    return rng, S, x, y, bw, bh


def _moved_rects(rng, x, y, bw, bh, keep=0.8):
    """Each body's rect moved by a delta in [-2, 2]^2 (the move phase's
    target rects); the rest are non-queries: RECT_PAD with an empty rect.
    Slots 0 and 1 query empty rects at slot 0's (dead) coordinates."""
    q = rng.uniform(size=x.shape) < keep
    q[:, :2] = False
    dx = rng.randint(-2, 3, size=x.shape)
    dy = rng.randint(-2, 3, size=x.shape)
    qx = np.where(q, x + dx, tap.RECT_PAD).astype(np.int32)
    qy = np.where(q, y + dy, tap.RECT_PAD).astype(np.int32)
    qx[:, :2], qy[:, :2] = x[:, :1], y[:, :1]
    tbw = np.where(q, np.maximum(bw, 1), 0).astype(np.int32)
    tbh = np.where(q, np.maximum(bh, 1), 0).astype(np.int32)
    return qx, qy, tbw, tbh


@pytest.mark.parametrize("A,MB", CASES)
@pytest.mark.parametrize("exclude_self", [False, True])
def test_occupant_rect_matches_jax(A, MB, exclude_self):
    rng, S, x, y, bw, bh = _bodies(A, MB, A + MB)
    hp = rng.uniform(0.1, 1.0, size=(B, A)).astype(np.float32)
    # query cells: in or near bodies (every fourth one inside its own body,
    # which exclude_self must skip), a fifth non-queries
    qx = rng.randint(0, S, size=(B, A)).astype(np.int32)
    qy = rng.randint(0, S, size=(B, A)).astype(np.int32)
    own = rng.uniform(size=(B, A)) < 0.25
    qx = np.where(own, x, qx).astype(np.int32)
    qy = np.where(own, y, qy).astype(np.int32)
    pad = rng.uniform(size=(B, A)) < 0.2
    qx = np.where(pad, tap.RECT_PAD, qx).astype(np.int32)
    qy = np.where(pad, tap.RECT_PAD, qy).astype(np.int32)
    args = (qx, qy, x, y, bw, bh, hp)
    ref = tap.occupant_rect_ref(*map(_t, args), exclude_self=exclude_self)
    wrapped = tap.occupant_rect(*map(_t, args), exclude_self=exclude_self)
    for b in range(B):
        jargs = [jnp.asarray(a[b]) for a in args]
        for want_t, want_h in (
                jap.occupant_rect_tpu(*jargs, exclude_self=exclude_self,
                                      interpret=True),
                jap.occupant_rect_xla(*jargs, exclude_self=exclude_self)):
            for tgt, hp_t in (ref, wrapped):
                assert tgt.dtype == torch.int32 and hp_t.dtype == torch.float32
                np.testing.assert_array_equal(tgt[b].numpy(), np.asarray(want_t))
                np.testing.assert_array_equal(hp_t[b].numpy(), np.asarray(want_h))
    tgt = ref[0].numpy()
    assert (tgt >= 0).sum() > A // 8 and (tgt < 0).sum() > 0
    if exclude_self:
        assert (tgt != np.arange(A)).all()


@pytest.mark.parametrize("A,MB", CASES)
@pytest.mark.parametrize("gate", ["exclude_self", "lower_only"])
def test_rect_first_overlap_matches_jax(A, MB, gate):
    """Blocking (moved rects against the current bodies, exclude_self) and
    claims (moved rects against one another, lower_only), as the engine
    calls them."""
    rng, S, x, y, bw, bh = _bodies(A, MB, 7 * A + MB)
    qx, qy, tbw, tbh = _moved_rects(rng, x, y, bw, bh)
    if gate == "exclude_self":
        args = (qx, qy, tbw, tbh, x, y, bw, bh)
    else:
        args = (qx, qy, tbw, tbh) * 2
    ref = tap.rect_first_overlap_ref(*map(_t, args), max_body=MB, gate=gate)
    wrapped = tap.rect_first_overlap(*map(_t, args), max_body=MB, gate=gate)
    for b in range(B):
        jargs = [jnp.asarray(a[b]) for a in args]
        for want in (jap.rect_first_overlap_tpu(*jargs, max_body=MB,
                                                gate=gate, interpret=True),
                     jap.rect_first_overlap_xla(*jargs, MB, gate)):
            for got in (ref, wrapped):
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    got = ref.numpy()
    hit = got < tap.RECT_NONE
    assert hit.sum() > A // 16 and (~hit).sum() > 0
    # the coinciding empty rects of slots 0 and 1 (queries and bodies)
    # overlap nothing and are overlapped by nothing
    assert (got[:, :2] == tap.RECT_NONE).all()
    assert not np.isin(got, [0, 1]).any()
    if gate == "lower_only":
        assert (got[hit] < np.broadcast_to(np.arange(A), got.shape)[hit]).all()


def test_rect_first_overlap_checks_its_static_arguments():
    z = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="gate"):
        tap.rect_first_overlap(*(z,) * 8, max_body=2, gate="upper")
    big = z[:, :1].expand(1, tap.RECT_NONE // 9 + 1)
    with pytest.raises(ValueError, match="stride"):
        tap.rect_first_overlap(*(big,) * 8, max_body=3, gate="lower_only")


def _window_case(seed, vh=9, vw=9, C=7, N=41, map_size=20):
    """A padded image, packed positions ``tl * 1024 + self_cell`` of in-map
    agents, a circular mask, pooled minimaps in two channels, liveness."""
    from magent_tpu_torch.ranges import circle_range

    rng = np.random.RandomState(seed)
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(map_size, map_size, C,
                                                      vh, vw)
    img = rng.uniform(size=(B, Hp, lanes)).astype(np.float32)
    x0, y0 = -(vw // 2), -(vh // 2)
    xs = rng.randint(0, map_size, size=(B, N)) + x0 + pad_x
    ys = rng.randint(0, map_size, size=(B, N)) + y0 + pad_y
    self_cell = rng.randint(0, vh * vw, size=(B, N))
    pos = ((ys * Wp + xs) * 1024 + self_cell).astype(np.int32)
    rmask = circle_range(vh // 2, 0.0, vw % 2).mask.astype(np.float32)
    mask = np.repeat(rmask, C, axis=1)
    mm_ch = np.zeros(C, np.float32)
    mm_ch[[2, C - 1]] = 1.0
    mm_mask = np.tile(mm_ch, (vh, vw))
    mm_img = (rng.uniform(size=(B, vh, vw * C)) * mm_mask).astype(np.float32)
    act = (rng.uniform(size=(B, N)) < 0.8).astype(np.int32)
    return dict(img=img, pos=pos, mask=mask, mm_img=mm_img, mm_mask=mm_mask,
                act=act, kw=dict(vh=vh, vw=vw, C=C, Wp=Wp))


@pytest.mark.parametrize("form", ["none", "act", "minimap"])
@pytest.mark.parametrize("geometry", [(9, 9, 7), (10, 10, 5)])
def test_window_gather4_matches_jax(form, geometry):
    """The three epilogue forms: no epilogue, liveness alone (the JAX kernel
    applies ``act`` only with the minimap, so its no-epilogue windows times
    ``act`` are the reference), and minimap + self mark + liveness."""
    vh, vw, C = geometry
    c = _window_case(vh * vw + C, vh=vh, vw=vw, C=C)
    kw = c["kw"]
    ops = {"none": {}, "act": {"act": c["act"]},
           "minimap": {k: c[k] for k in ("mm_img", "mm_mask", "act")}}[form]
    t_ops = {k: _t(v) for k, v in ops.items()}
    args = (_t(c["img"]), _t(c["pos"]), _t(c["mask"]))
    got_ref = twg.window_gather4_ref(*args, **t_ops, **kw).numpy()
    got = twg.window_gather4(*args, **t_ops, **kw).numpy()
    j_ops = {k: jnp.asarray(v) for k, v in ops.items()
             if form == "minimap"}
    want = np.asarray(jwg.window_gather4(
        jnp.asarray(c["img"]), jnp.asarray(c["pos"]), jnp.asarray(c["mask"]),
        **j_ops, chunk=8, interpret=True, **kw))
    if form == "act":
        want = want * c["act"][..., None, None].astype(np.float32)
    assert got.shape == want.shape == (B, c["pos"].shape[1], vh, vw * C)
    np.testing.assert_array_equal(got, got_ref)
    mm = c["mm_mask"][None, None] > 0
    if form == "minimap":
        np.testing.assert_allclose(np.where(mm, got, 0), np.where(mm, want, 0),
                                   atol=MINIMAP_ATOL, rtol=0)
        np.testing.assert_array_equal(np.where(mm, 0, got), np.where(mm, 0, want))
        # the self mark: +1 at each agent's own pooled cell
        pos = c["pos"]
        b, n = np.nonzero(c["act"])
        cell = pos[b, n] & 1023
        r, col = cell // vw, (cell % vw) * C + 2
        assert (got[b, n, r, col] >= 1.0).all()
    else:
        np.testing.assert_array_equal(got, want)
    plain = twg.window_gather_ref(args[0], args[1] >> 10, args[2], **kw).numpy()
    if form != "minimap":
        live = c["act"][..., None, None] if form == "act" else 1
        np.testing.assert_array_equal(got, plain * live)


def test_window_gather4_checks_its_operands():
    c = _window_case(0)
    args = (_t(c["img"]), _t(c["pos"]), _t(c["mask"]))
    with pytest.raises(ValueError, match="come together"):
        twg.window_gather4(*args, mm_img=_t(c["mm_img"]), **c["kw"])
    with pytest.raises(ValueError, match="comes with act"):
        twg.window_gather4(*args, mm_img=_t(c["mm_img"]),
                           mm_mask=_t(c["mm_mask"]), **c["kw"])
    with pytest.raises(ValueError, match="10-bit"):
        twg.window_gather4(*args, vh=33, vw=33, C=1, Wp=c["kw"]["Wp"])
    # an image past 2**21 cells (never read: the check is on its shape)
    kw = dict(c["kw"], Wp=1 << 11)
    big = torch.zeros((B, 1, 1)).expand(B, (1 << 10) + 1, kw["Wp"] * kw["C"])
    with pytest.raises(ValueError, match="21 bits"):
        twg.window_gather4(big, *args[1:], **kw)
