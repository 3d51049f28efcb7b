"""bf16 views of the port (``out_dtype`` / ``obs_dtype``) against the JAX
package, bit for bit.

The three window kernels' bf16 forms against the Pallas kernels in
interpret mode with ``out_dtype=jnp.bfloat16`` (env counts and agent counts
that are not multiples of the chunk); ``make_observe(..., obs_dtype=bf16)``
on battle (the roll route), pursuit map 64 (``window_gather4``), a
banded pursuit world (``VMEM_IMAGE_BUDGET`` shrunk to 1 in both packages)
and a minimap config with 9 x 63 windows whose image fits the budget but
not four times over (the budget shrunk in both packages: ``window_gather``
and the epilogue, two roundings, where the replica kernel would round
once) against ``magent_tpu.core.observe.make_observe(..., interpret=True,
obs_dtype=jnp.bfloat16)``: off the TPU the JAX package's ``VecGridWorld``
takes its XLA gather and rounds once, and only the interpret-mode kernel
route rounds where the TPU does.  Features stay f32 and equal.  Also
``VecGridWorld``'s positional order (``obs_dtype`` fifth, as in the JAX
package) and ``action_spaces``."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magent_tpu
from magent_tpu.core import observe as jobserve
from magent_tpu.ops import window_gather as jwg
from magent_tpu.parallel import VecGridWorld as JVec

import magent_tpu_torch
from magent_tpu_torch.builtin.config import pursuit as tpursuit
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.ops import window_gather as twg
from magent_tpu_torch.parallel import VecGridWorld as TVec

from _torch_port_cases import (CONFIGS, Pair, arrays_of, jax_state, key_pair,
                               perturb, port_state)
from test_torch_port_rect_kernels import _window_case
from test_torch_port_seg_kernels import _banded_case

B = 3  # not a multiple of anything the kernels split by
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bf16_equal(got, want, tag=""):
    """``got`` a torch bf16 tensor, ``want`` a JAX bf16 array: the same
    values (``torch.equal``) and the same bits."""
    want = np.asarray(want)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16, (
        tag, got.dtype, want.dtype)
    want_t = torch.from_numpy(want.view(np.uint16).astype(np.int32)).to(
        torch.int16).view(BF16)
    assert torch.equal(got, want_t), tag
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want.view(np.uint16), err_msg=tag)


def _battle_case(seed, N=37):
    """Battle's 13x13x7 window over a map-20 padded image: a random image,
    unpacked top-left cells of in-map agents, the circle mask."""
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch import spec as tspec

    spec = tspec.compile_spec(battle.get_config(20), [15, 15])
    C = spec.n_channel
    vr = spec.groups[0].type.view_range
    vh, vw = vr.height, vr.width
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(20, 20, C, vh, vw)
    rng = np.random.RandomState(seed)
    img = rng.uniform(size=(B, Hp, lanes)).astype(np.float32)
    xs = rng.randint(0, 20, size=(B, N)) + vr.x1 + pad_x
    ys = rng.randint(0, 20, size=(B, N)) + vr.y1 + pad_y
    pos = (ys * Wp + xs).astype(np.int32)
    mask = np.repeat(vr.mask.astype(np.float32), C, axis=1)
    return img, pos, mask, dict(vh=vh, vw=vw, C=C, Wp=Wp)


@pytest.mark.parametrize("N", [37, 8])
def test_window_gather_bf16_matches_jax(N):
    img, pos, mask, kw = _battle_case(N, N=N)
    want = jwg.window_gather(jnp.asarray(img), jnp.asarray(pos) * 1024,
                             jnp.asarray(mask), chunk=8, interpret=True,
                             out_dtype=jnp.bfloat16, **kw)
    args = (_t(img), _t(pos), _t(mask))
    for fn in (twg.window_gather_ref, twg.window_gather):
        got = fn(*args, **kw, out_dtype=BF16)
        assert got.shape == (B, N, kw["vh"], kw["vw"] * kw["C"])
        assert_bf16_equal(got, want, fn.__name__)
    # the f32 form is unchanged, and bf16 is it rounded
    f32 = twg.window_gather(*args, **kw)
    assert f32.dtype == torch.float32
    assert torch.equal(f32.to(BF16), twg.window_gather(*args, **kw,
                                                       out_dtype=BF16))


@pytest.mark.parametrize("form", ["none", "act", "minimap"])
@pytest.mark.parametrize("geometry", [(9, 9, 7), (13, 13, 5)])
def test_window_gather4_bf16_matches_jax(form, geometry):
    """No epilogue, liveness alone (the JAX kernel applies ``act`` only with
    the minimap: its bf16 windows times ``act`` are the reference, exact
    for 0/1), and minimap + self mark + liveness, rounded once."""
    vh, vw, C = geometry
    c = _window_case(vh * vw + C, vh=vh, vw=vw, C=C)
    kw = c["kw"]
    ops = {"none": {}, "act": {"act": c["act"]},
           "minimap": {k: c[k] for k in ("mm_img", "mm_mask", "act")}}[form]
    j_ops = {k: jnp.asarray(v) for k, v in ops.items() if form == "minimap"}
    want = jwg.window_gather4(
        jnp.asarray(c["img"]), jnp.asarray(c["pos"]), jnp.asarray(c["mask"]),
        **j_ops, chunk=8, interpret=True, out_dtype=jnp.bfloat16, **kw)
    if form == "act":
        want = want * jnp.asarray(c["act"], jnp.bfloat16)[..., None, None]
    args = (_t(c["img"]), _t(c["pos"]), _t(c["mask"]))
    t_ops = {k: _t(v) for k, v in ops.items()}
    for fn in (twg.window_gather4_ref, twg.window_gather4):
        got = fn(*args, **t_ops, **kw, out_dtype=BF16)
        assert_bf16_equal(got, want, "%s %s" % (fn.__name__, form))


@pytest.mark.parametrize("chunk,band_rows", [(8, 16), (40, 32)])
def test_window_gather_banded_bf16_matches_jax(chunk, band_rows):
    """Band order (dummy rows included) and slot order, bf16."""
    img, pos, mask, kw = _banded_case(chunk + band_rows, B=B)
    band = dict(chunk=chunk, band_rows=band_rows)
    j_out, j_inv = jwg.window_gather_banded(
        jnp.asarray(img), jnp.asarray(pos), jnp.asarray(mask), **kw, **band,
        interpret=True, unsort=False, out_dtype=jnp.bfloat16)
    j_view = jwg.window_gather_banded(
        jnp.asarray(img), jnp.asarray(pos), jnp.asarray(mask), **kw, **band,
        interpret=True, out_dtype=jnp.bfloat16)
    args = (_t(img), _t(pos), _t(mask))
    for fn in (twg.window_gather_banded_ref, twg.window_gather_banded):
        out, inv = fn(*args, **kw, **band, unsort=False, out_dtype=BF16)
        np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
        assert_bf16_equal(out, j_out, fn.__name__ + " band order")
        assert_bf16_equal(fn(*args, **kw, **band, out_dtype=BF16), j_view,
                          fn.__name__ + " slot order")


def test_out_dtype_is_f32_or_bf16():
    img, pos, mask, kw = _battle_case(0, N=4)
    args = (_t(img), _t(pos), _t(mask))
    for fn, a in ((twg.window_gather, args),
                  (twg.window_gather_ref, args),
                  (twg.window_gather4, (args[0], args[1] * 1024, args[2])),
                  (twg.window_gather_banded, args)):
        with pytest.raises(ValueError, match="out_dtype"):
            fn(*a, **kw, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="out_dtype"):
        tobserve.make_observe(TVec(CONFIGS["battle"][0](20), [4, 4], 1,
                                   device="cpu").spec, 0,
                              obs_dtype=torch.float64)


# ------------------------------------------------------------- observations
def _pursuit_pair(map_size, n_envs):
    placements, _ = tpursuit.layout(map_size, seed=11)
    return Pair("pursuit", map_size, [len(p) for p in placements], n_envs,
                placements=placements)


def _observe_both(pair, seed, route):
    """Both packages' bf16 observe of every group on one perturbed state;
    the port's on its own route and the JAX package's through its kernels
    in interpret mode.  -> [(port (view, feat), JAX (view, feat))]."""
    jkey, _ = key_pair(seed)
    arrays = perturb(arrays_of(pair.reset(jkey)), pair.spec, seed,
                     dead_frac=0.2)
    rng = np.random.RandomState(seed)
    arrays["last_reward"] = rng.normal(
        size=arrays["last_reward"].shape).astype(np.float32)
    js, ts = jax_state(arrays), port_state(arrays)
    out = []
    for g in range(pair.spec.n_groups):
        t_obs = tobserve.make_observe(pair.spec, g, obs_dtype=BF16)
        assert t_obs.route == route
        j_obs = jobserve.make_observe(pair.jv.spec, g, interpret=True,
                                      obs_dtype=jnp.bfloat16)
        out.append((t_obs(ts), jax.jit(j_obs)(js)))
    return out


def _narrow_battle(magent):
    """Battle with a view range of 4 in package ``magent``: 9 x 9 x 7
    windows (63 lanes, within the replica kernel's 13 rows and 65 lanes)
    and the minimap -> ``map_size -> Config``."""
    def get_config(map_size):
        gw = magent.gridworld
        cfg = gw.Config()
        cfg.set({"map_width": map_size, "map_height": map_size,
                 "minimap_mode": True, "embedding_size": 10})
        small = cfg.register_agent_type("small", {
            "width": 1, "length": 1, "hp": 10, "speed": 2,
            "view_range": gw.CircleRange(4),
            "attack_range": gw.CircleRange(1.5), "damage": 2,
            "step_recover": 0.1})
        cfg.add_group(small)
        cfg.add_group(small)
        return cfg
    return get_config


def _narrow_battle_pair():
    return Pair((_narrow_battle(magent_tpu_torch), _narrow_battle(magent_tpu)),
                20, [10, 14], B)


def _budget_between(pair):
    """An image budget that the image fits once but not four times over:
    both packages take ``window_gather`` and the epilogue (two roundings)
    where the replica kernel would round once."""
    Hp, _, lanes = tobserve.make_grids(pair.spec).geometry[:3]
    return 2 * Hp * lanes * 4


ROUTES = {
    # battle: 13 x 91 windows take the roll kernel, then the minimap
    # epilogue in f32 (two roundings)
    "battle": (lambda: Pair("battle", 20, [10, 14], B), "window_gather",
               None),
    # pursuit map 64: the replica kernel, liveness fused (one rounding)
    "pursuit64": (lambda: _pursuit_pair(64, 2), "window_gather4", None),
    # a pursuit world past the (shrunk) image budget: the banded kernel
    "pursuit_banded": (lambda: _pursuit_pair(40, 2), "window_gather_banded",
                       lambda pair: 1),
    # a minimap config with replica-sized windows whose image passes a
    # quarter of the (shrunk) budget: the roll kernel and the epilogue
    "minimap_replica_budget": (_narrow_battle_pair, "window_gather",
                               _budget_between),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_make_observe_bf16_matches_jax(case, monkeypatch):
    make_pair, route, budget = ROUTES[case]
    pair = make_pair()
    if budget is not None:
        monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", budget(pair))
        monkeypatch.setattr(jobserve, "VMEM_IMAGE_BUDGET", budget(pair))
    for seed in (0, 1):
        for g, ((tv, tf), (jv, jf)) in enumerate(_observe_both(pair, seed,
                                                               route)):
            tag = "%s seed %d group %d" % (case, seed, g)
            assert tv.shape == tuple(jv.shape), tag
            assert_bf16_equal(tv, jv, tag)
            assert tf.dtype == torch.float32 and jf.dtype == jnp.float32
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf),
                                          err_msg=tag)
            assert bool((tv != 0).any()), tag


@pytest.mark.parametrize("case", ["battle", "pursuit64"])
def test_vec_env_bf16_views_are_f32_rounded(case):
    """``VecGridWorld(..., obs_dtype=bf16).observe_all``: the f32 views
    rounded, features unchanged (battle's second rounding meets a minimap
    add of 0 outside the minimap channels, whose image is 0)."""
    if case == "battle":
        cfg, caps, kw = CONFIGS["battle"][0](20), [10, 14], {}
    else:
        placements, _ = tpursuit.layout(64, seed=11)
        cfg, caps = CONFIGS["pursuit"][0](64), [len(p) for p in placements]
        kw = dict(placements=placements)
    v32, v16 = (TVec(cfg, caps, 2, obs_dtype=dt, device="cpu", **kw)
                for dt in (None, BF16))
    _, tkey = key_pair(3)
    state = v32.reset(tkey)
    for (w32, f32), (w16, f16) in zip(v32.observe_all(state),
                                      v16.observe_all(state)):
        assert w32.dtype == torch.float32 and w16.dtype == BF16
        assert torch.equal(w16, w32.to(BF16))
        assert torch.equal(f16, f32)


def test_positional_order_matches_jax():
    """``(config, caps, n_envs, placements, obs_dtype, walls)``, then the
    port's ``device`` and ``mesh``: a fifth positional argument is the
    view dtype in both packages."""
    j = list(inspect.signature(JVec.__init__).parameters)
    t = list(inspect.signature(TVec.__init__).parameters)
    assert t[:len(j)] == j and t[len(j):] == ["device", "mesh"]
    venv = TVec(CONFIGS["battle"][0](20), [4, 4], 1, None, BF16, None, "cpu")
    _, tkey = key_pair(0)
    view, _ = venv.observe(venv.reset(tkey), 0)
    assert view.dtype == BF16


@pytest.mark.parametrize("name,map_size,caps", [
    ("battle", 24, [4, 4]), ("forest", 16, [5, 7]), ("pursuit", 32, [4, 8])])
def test_action_spaces_match_jax(name, map_size, caps):
    port_cfg, jax_cfg = CONFIGS[name]
    kw = {}
    if name == "pursuit":  # multi-cell bodies need placements
        placements, _ = tpursuit.layout(map_size, seed=3)
        caps = [len(p) for p in placements]
        kw["placements"] = placements
    want = JVec(jax_cfg(map_size), caps, 1, **kw).action_spaces()
    got = TVec(port_cfg(map_size), caps, 1, device="cpu", **kw).action_spaces()
    assert got == want and len(got) == 2
