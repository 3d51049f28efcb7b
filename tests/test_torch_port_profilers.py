"""The port's ``tools.profile_phases``, ``tools.profile_sweep`` and
``tools.profile_micro`` against ``scripts/profile_phases.py``,
``profile_sweep.py`` and ``profile_micro.py`` (loaded with ``importlib``)
on the CPU at a tiny size (module constants monkeypatched in both): every
variant's sink (the summed per-step values that keep a variant's work
alive) equals the JAX variant's over the same steps from the same state
and key, exactly, and the CLI defaults equal the scripts'.  The opt-in
``one_group`` and ``view_only`` too, and ``view_only``'s windows bit for
bit; ``profile_micro``'s primitives: float sums within rtol 1e-5, the
threefry bits exact, ``scatter_set`` by membership (which of the slots
sharing a cell wins is unspecified on both sides)."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magent_tpu_torch.tools import profile_micro, profile_phases, profile_sweep

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import RecordingJax, jax_cli_defaults, jax_script

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 3


def test_cli_defaults_match_the_jax_scripts(monkeypatch):
    jp = jax_script("scripts/profile_phases.py")
    args = vars(profile_phases.cli().parse_args([]))
    assert args.pop("device") is None
    assert args == dict(variants=list(profile_phases.VARIANTS),
                        n_envs=jp.N_ENVS, steps=jp.STEPS, calls=jp.CALLS)
    assert (jp.N_ENVS, jp.STEPS, jp.CALLS) == (16, 64, 3)
    assert (profile_phases.N_PER_GROUP, profile_phases.MAP_SIZE) == (
        jp.N_PER_GROUP, jp.MAP_SIZE)

    seen = jax_cli_defaults(jax_script("scripts/profile_sweep.py"),
                            monkeypatch)
    got = vars(profile_sweep.cli().parse_args([]))
    assert got.pop("device") is None
    assert got == seen

    jm = jax_script("scripts/profile_micro.py")
    assert (profile_micro.B, profile_micro.A, profile_micro.STEPS,
            profile_micro.CALLS) == (jm.B, jm.A, jm.STEPS, jm.CALLS)


class _NoMinimap:
    """A ``battle`` config module whose configs have the minimap off."""

    def __init__(self, module):
        self.module = module

    def get_config(self, map_size):
        cfg = self.module.get_config(map_size)
        cfg.set({"minimap_mode": False})
        return cfg


def _phase_sinks(monkeypatch, variants=(), minimap=True):
    """The JAX profile_phases run on ``variants`` (none: its defaults) at
    battle 2x20 on map 24, B=2, 3 steps per variant, and the port's ->
    (JAX's {name: sink}, the port's {name: (ms, sink)}); ``minimap=False``
    turns battle's minimap off in both."""
    jp = jax_script("scripts/profile_phases.py")
    for mod in (jp, profile_phases):
        monkeypatch.setattr(mod, "N_PER_GROUP", 20)
        monkeypatch.setattr(mod, "MAP_SIZE", 24)
        if not minimap:
            monkeypatch.setattr(mod, "battle", _NoMinimap(mod.battle))
    monkeypatch.setattr(jp, "N_ENVS", 2)
    monkeypatch.setattr(jp, "STEPS", STEPS)
    sinks = {}

    def timed(name, body, state, key):  # the script's timed, one call
        run = jax.jit(lambda s, k: jax.lax.scan(body, (s, k), None,
                                                length=STEPS)[1])
        sinks[name] = float(jnp.sum(run(state, key)))

    monkeypatch.setattr(jp, "timed", timed)
    monkeypatch.setattr(sys, "argv", ["profile_phases.py"] + list(variants))
    jp.main()
    got = profile_phases.main(list(variants) + [
        "--device", "cpu", "--n_envs", "2", "--steps", str(STEPS), "--calls",
        "1"])
    return sinks, got


def test_profile_phases_sinks_match_jax(monkeypatch):
    """Battle 2x20 on map 24, B=2, 3 steps per variant."""
    sinks, got = _phase_sinks(monkeypatch)
    assert sorted(got) == sorted(sinks) == sorted(
        ["full", "obs_only", "step_only", "attack_only", "move_only",
         "rules_only", "grids_only", "grids+render", "obs_nominimap"])
    for name, want in sinks.items():
        assert got[name][1] == want, name


@pytest.mark.parametrize("minimap", [True, False])
def test_profile_phases_opt_in_variants_match_jax(monkeypatch, capsys,
                                                  minimap):
    """``one_group`` and ``view_only`` at the size above.  Battle's 13 x 13
    x 7 windows (minimap on) are past ``window_gather4``'s limit
    (``vw * C`` 91 > 65): both scripts print the skip line and time
    ``one_group`` alone.  With the minimap off (13 x 13 x 5, ``vw * C`` =
    65) both take ``window_gather4``, JAX's Pallas kernel in interpret
    mode."""
    from magent_tpu.ops import window_gather as jwg

    monkeypatch.setattr(jwg, "window_gather4", functools.partial(
        jwg.window_gather4, interpret=True))
    capsys.readouterr()
    sinks, got = _phase_sinks(monkeypatch, profile_phases.OPT_IN,
                              minimap)
    printed = capsys.readouterr().out.splitlines()
    want = ["one_group"] + ([] if minimap else ["view_only"])
    assert sorted(got) == sorted(sinks) == want
    for name in want:
        assert got[name][1] == sinks[name], name
    assert printed.count(profile_phases.VIEW_SKIPPED) == (2 if minimap
                                                          else 0)
    if not minimap:
        _check_view_windows()


def _check_view_windows():
    """The sinks above read each window's masked corner (0): ``view_only``'s
    whole windows on the reset state against the JAX script's (its
    ``window_layout``, ``_render_image`` and ``window_gather4``), bit for
    bit."""
    from magent_tpu.builtin.config import battle as jbattle
    from magent_tpu.core import observe as jobserve
    from magent_tpu.ops import window_gather as jwg
    from magent_tpu.parallel import VecGridWorld as JaxVecGridWorld

    from magent_tpu_torch import random as trandom
    from magent_tpu_torch.core import observe as tobserve

    cfg = _NoMinimap(jbattle).get_config(24)
    jv = JaxVecGridWorld(cfg, [20, 20], n_envs=2)
    state = jax.jit(jv.reset)(jax.random.PRNGKey(0))
    grids_fn = jv._observe1[0].grids_fn
    Hp, Wp, lanes = grids_fn.geometry[:3]
    g = grids_fn(state)
    want = []
    for grp in range(2):
        lo = jobserve.window_layout(jv.spec, grp, grids_fn.geometry)
        want.append(np.asarray(jwg.window_gather4(
            jobserve._render_image(jv.spec, grp, g, lanes),
            lo["pos_fn"](state) * 1024, lo["mask"], vh=lo["vh"],
            vw=lo["vw"], C=jv.spec.n_channel, Wp=Wp, chunk=lo["chunk"],
            interpret=True)))
    tv = profile_phases.build(profile_phases.cli().parse_args(
        ["--n_envs", "2"]), "cpu")
    layouts = [tobserve.window_layout(tv.spec, grp, tv._grids.geometry, "cpu")
               for grp in range(2)]
    got = profile_phases.view_windows(tv, layouts,
                                      tv.reset(trandom.PRNGKey(0)))
    for grp in range(2):
        assert want[grp].sum() > 0
        np.testing.assert_array_equal(got[grp].numpy(), want[grp])


def test_profile_sweep_sinks_match_jax(monkeypatch):
    """The forest sweep at 400 agents over 2 envs (map 63, 20 walls each),
    3 steps per variant."""
    js = jax_script("scripts/profile_sweep.py")
    rec = RecordingJax()
    monkeypatch.setattr(js, "jax", rec)
    argv = ["--agent_number", "400", "--n_envs", "2", "--steps",
            str(STEPS), "--calls", "1"]
    monkeypatch.setattr(sys, "argv", ["profile_sweep.py"] + argv)
    js.main()
    runs = rec.outputs_of("run")
    assert len(runs) == 2 * len(profile_sweep.VARIANTS)
    want = {name: float(runs[2 * i][2])
            for i, name in enumerate(profile_sweep.VARIANTS)}
    got = profile_sweep.main(argv + ["--device", "cpu"])
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name][1] == w, name


def _micro_sizes(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "B", 2)
        monkeypatch.setattr(mod, "A", 512)
        monkeypatch.setattr(mod, "STEPS", STEPS)
        monkeypatch.setattr(mod, "CALLS", 1)


# the JAX script's variants in its order; scatter_set's sink depends on
# which of the slots sharing a cell wins (unspecified on both sides), so
# it is held by test_profile_micro_scatter_set_writes_a_scattered_value
JAX_MICRO = ("rank_prefix", "move_claims", "row_gather", "scatter_max",
             "scatter_set", "rand_bits")
MICRO_EXACT = ("rank_prefix", "move_claims")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normal_matches_jax(seed):
    """``random.normal`` (``row_gather``'s draw) against
    ``jax.random.normal``: the uniform under it is bit for bit, XLA's
    ``erf_inv`` polynomial is evaluated in the same order, and PyTorch's
    ``log1p`` and XLA's fused multiply-adds leave each value within 3 ulp,
    95% of them equal; a batch of keys draws as ``jax.vmap``."""
    def ulps(got, want):
        assert got.dtype == np.float32 and got.shape == want.shape
        return np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))

    rnd = profile_micro.rnd
    d = ulps(rnd.normal(rnd.PRNGKey(seed), (50000,)).numpy(), np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), (50000,))))
    assert d.max() <= 3 and (d == 0).mean() > 0.95
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    d = ulps(rnd.normal(rnd.split(rnd.PRNGKey(seed), 3), (5, 7)).numpy(),
             np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5, 7)))(
                 keys)))
    assert d.max() <= 3


def test_profile_micro_sinks_match_jax(monkeypatch):
    """B=2, A=512, 3 steps: the warm-up call's sink of every variant (the
    kernels' plain versions are the same functions on the CPU) against the
    JAX script's at its defaults: integer sums exact, the float sums of
    ``row_gather``, ``scatter_max`` and ``rand_bits`` within rtol 1e-5
    (other summation orders; ``row_gather``'s normals differ from XLA's by
    an ulp here and there); ``rand_bits``' bits themselves exact."""
    jm = jax_script("scripts/profile_micro.py")
    rec = RecordingJax()
    monkeypatch.setattr(jm, "jax", rec)
    _micro_sizes(monkeypatch, jm, profile_micro)
    monkeypatch.setattr(sys, "argv", ["profile_micro.py"])
    jm.main()
    runs = rec.outputs_of("run")
    assert len(runs) == 2 * len(JAX_MICRO)
    want = {name: float(runs[2 * i][1]) for i, name in enumerate(JAX_MICRO)}
    got = profile_micro.main(["--device", "cpu"])
    assert sorted(got) == sorted(profile_micro.VARIANTS)
    for name, (_, sink) in got.items():
        base = name.replace("_plain", "")
        if base in MICRO_EXACT:
            assert sink == want[base], name
        elif base != "scatter_set":
            assert sink == pytest.approx(want[base], rel=1e-5), name
    assert want["rank_prefix"] > 0 and want["move_claims"] > 0
    # rand_bits: the threefry words, step by step
    jkey, tkey = jax.random.PRNGKey(0), profile_micro.rnd.PRNGKey(0)
    for _ in range(STEPS):
        jkey, k2 = jax.random.split(jkey)
        tkey, bits = profile_micro.rand_bits(tkey)
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(jax.random.bits(k2, (2, 512)),
                                     np.int64))


def test_profile_micro_scatter_set_writes_a_scattered_value(monkeypatch):
    """``scatter_set`` over the JAX script's inputs (B=2, A=512, uniform
    values, slots from PRNGKey(3), drawn equal to JAX's), 3 steps: which of
    the slots sharing a cell wins is unspecified on both sides, so each
    written value is held as one of those scattered to its cell (each
    lane on its own), a cell no slot names as 0, on both sides."""
    _micro_sizes(monkeypatch, profile_micro)
    init, body = profile_micro.variant("scatter_set")
    vals, idx = init(profile_micro.rnd.PRNGKey(0))
    jvals = jax.random.uniform(jax.random.PRNGKey(0), (2, 512, 2))
    jidx = jax.random.randint(jax.random.PRNGKey(3), (2, 512), 0, 512,
                              jnp.int32)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    dup = 0
    for _ in range(STEPS):
        got = profile_micro.scatter_set(vals, idx).numpy()
        jout = np.asarray(jax.vmap(
            lambda v, i: jnp.zeros((513, 2), jnp.float32).at[i].set(v)[:512]
        )(jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy())))
        v, ix = vals.numpy(), idx.numpy()
        for b in range(2):
            for cell in range(512):
                src = v[b, ix[b] == cell]  # [n, 2]
                dup += len(src) > 1
                for out in (got, jout):
                    if len(src) == 0:
                        assert (out[b, cell] == 0).all()
                    else:
                        assert all(out[b, cell, lane] in src[:, lane]
                                   for lane in range(2))
        (vals, idx), _ = body((vals, idx))
    assert dup > 0  # the inputs do have shared cells
