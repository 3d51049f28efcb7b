"""The port's ``tools.profile_phases``, ``tools.profile_sweep`` and
``tools.profile_micro`` against ``scripts/profile_phases.py``,
``profile_sweep.py`` and ``profile_micro.py`` (loaded with ``importlib``)
on the CPU at a tiny size (module constants monkeypatched in both): every
variant's sink (the summed per-step values that keep a variant's work
alive) equals the JAX variant's over the same steps from the same state
and key, exactly, and the CLI defaults equal the scripts'."""

import sys

import jax
import jax.numpy as jnp
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


def test_profile_phases_sinks_match_jax(monkeypatch):
    """Battle 2x20 on map 24, B=2, 3 steps per variant."""
    jp = jax_script("scripts/profile_phases.py")
    for mod in (jp, profile_phases):
        monkeypatch.setattr(mod, "N_PER_GROUP", 20)
        monkeypatch.setattr(mod, "MAP_SIZE", 24)
    monkeypatch.setattr(jp, "N_ENVS", 2)
    monkeypatch.setattr(jp, "STEPS", STEPS)
    sinks = {}

    def timed(name, body, state, key):  # the script's timed, one call
        run = jax.jit(lambda s, k: jax.lax.scan(body, (s, k), None,
                                                length=STEPS)[1])
        sinks[name] = float(jnp.sum(run(state, key)))

    monkeypatch.setattr(jp, "timed", timed)
    monkeypatch.setattr(sys, "argv", ["profile_phases.py"])
    jp.main()
    got = profile_phases.main(["--device", "cpu", "--n_envs", "2",
                               "--steps", str(STEPS), "--calls", "1"])
    assert sorted(got) == sorted(sinks) == sorted(
        ["full", "obs_only", "step_only", "attack_only", "move_only",
         "rules_only", "grids_only", "grids+render", "obs_nominimap"])
    for name, want in sinks.items():
        assert got[name][1] == want, name


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


def test_profile_micro_sinks_match_jax(monkeypatch):
    """B=2, A=512, 3 steps: the warm-up call's sink of ``rank_prefix`` and
    ``move_claims`` (and of their plain versions, the same functions on
    the CPU)."""
    jm = jax_script("scripts/profile_micro.py")
    rec = RecordingJax()
    monkeypatch.setattr(jm, "jax", rec)
    for mod in (jm, profile_micro):
        monkeypatch.setattr(mod, "B", 2)
        monkeypatch.setattr(mod, "A", 512)
        monkeypatch.setattr(mod, "STEPS", STEPS)
        monkeypatch.setattr(mod, "CALLS", 1)
    monkeypatch.setattr(sys, "argv", ["profile_micro.py", "rank_prefix",
                                      "move_claims"])
    jm.main()
    runs = rec.outputs_of("run")
    assert len(runs) == 4
    want = {"rank_prefix": float(runs[0][1]), "move_claims": float(runs[2][1])}
    got = profile_micro.main(["--device", "cpu"])
    assert sorted(got) == sorted(profile_micro.VARIANTS)
    for name, (_, sink) in got.items():
        assert sink == want[name.replace("_plain", "")], name
    assert want["rank_prefix"] > 0 and want["move_claims"] > 0
