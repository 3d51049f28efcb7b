"""The port's benchmark scripts ``tools.bench`` and ``tools.bench_pursuit``
against the JAX scripts (the root ``bench.py``, ``scripts/bench_pursuit.py``,
loaded with ``importlib``) on the CPU: the CLI defaults equal the scripts'
constants and environment defaults, the ``VecGridWorld`` each builds
equals the script's call, and at a small size (module constants
monkeypatched in both) the bench loop's sink and final state equal the
JAX script's jitted scan exactly; bench_pursuit's placements exactly, in
both modes."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

import magent_tpu.parallel as jpar

from magent_tpu_torch.core.state import state_from_numpy
from magent_tpu_torch.tools import bench, bench_pursuit

from _torch_port_cases import arrays_of, assert_states_equal  # noqa: F401
from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import (REPO, RecordingJax, jax_cli_defaults,
                                 jax_script)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_bench_cli_defaults_match_the_jax_script():
    jb = jax_script("bench.py")
    args = vars(bench.cli().parse_args([]))
    assert args.pop("device") is None
    assert args == dict(n_envs=jb.N_ENVS, steps=jb.STEPS_PER_CALL,
                        calls=jb.TIMED_CALLS) == dict(n_envs=16, steps=64,
                                                      calls=3)
    assert (bench.N_PER_GROUP, bench.MAP_SIZE) == (jb.N_PER_GROUP,
                                                   jb.MAP_SIZE)


def test_bench_pursuit_cli_defaults_match_the_jax_script(monkeypatch):
    seen = jax_cli_defaults(jax_script("scripts/bench_pursuit.py"),
                            monkeypatch)
    args = vars(bench_pursuit.cli().parse_args([]))
    assert args.pop("device") is None
    assert args == seen == dict(map_size=1000, n_envs=1, n_step=20,
                                turn=False)


@pytest.mark.parametrize("turn", [False, True])
@pytest.mark.parametrize("map_size", [64, 250])
def test_bench_pursuit_world_matches_jax(turn, map_size):
    """Config, populations and placements (RandomState(5)'s rejection
    sampling) equal the JAX script's."""
    jm = jax_script("scripts/bench_pursuit.py")
    n_pred, n_prey = bench_pursuit.populations(map_size)
    assert (n_pred, n_prey) == (int(map_size * map_size * 0.0125),
                                int(map_size * map_size * 0.025))
    got = bench_pursuit.placements(map_size, n_pred, n_prey, turn)
    want = jm.placements(map_size, n_pred, n_prey, turn)
    assert got == [[[int(v) for v in row] for row in grp] for grp in want]
    if turn:
        assert len({row[2] for row in got[0]}) == 4
    tspec = bench_pursuit.build(argparse.Namespace(
        map_size=map_size, n_envs=1, turn=turn), "cpu").spec
    jspec = jpar.VecGridWorld(
        jm.pursuit_config(map_size, turn), [n_pred, n_prey], n_envs=1,
        placements=want).spec
    assert tspec.turn_mode == jspec.turn_mode == turn
    for g in range(2):
        assert tspec.view_space(g) == jspec.view_space(g)
        assert tspec.feature_size(g) == jspec.feature_size(g)
        assert tspec.groups[g].cap == jspec.groups[g].cap


def _small(monkeypatch, *mods):
    for m in mods:
        monkeypatch.setattr(m, "N_PER_GROUP", 24)
        monkeypatch.setattr(m, "MAP_SIZE", 24)


def test_bench_loop_matches_jax(monkeypatch):
    """Battle 2x24 on map 24, B=3, 4 steps per call, one timed call after
    the warm-up: the port's eager loop against the JAX script's jitted
    scan, both from PRNGKey(0) / PRNGKey(1): the final state of every
    field and the last call's summed sink, exactly."""
    jb = jax_script("bench.py")
    rec = RecordingJax()
    monkeypatch.setattr(jb, "jax", rec)
    _small(monkeypatch, jb, bench)
    monkeypatch.setattr(jb, "N_ENVS", 3)
    monkeypatch.setattr(jb, "STEPS_PER_CALL", 4)
    monkeypatch.setattr(jb, "TIMED_CALLS", 1)
    jb.main()
    runs = rec.outputs_of("run")
    assert len(runs) == 2
    jstate, _, jsink = runs[-1]

    got = bench.main(["--device", "cpu", "--n_envs", "3", "--steps", "4",
                      "--calls", "1"])
    assert_states_equal(got["state"], jstate, "bench final state")
    assert got["sink"] == float(jsink)
    assert set(got["record"]) == {"metric", "value", "unit", "vs_baseline"}
    assert got["record"]["metric"] == "battle_2x1000_agent_steps_per_s"


def test_bench_pursuit_loop_matches_jax(monkeypatch):
    """bench_pursuit's body on a map-48 world (both modes share it): the
    port's ``run`` against the same body scanned in JAX, 3 steps, from one
    state: the state after and the summed sink, exactly."""
    import jax
    import jax.numpy as jnp

    jm = jax_script("scripts/bench_pursuit.py")
    m = 48
    n_pred, n_prey = bench_pursuit.populations(m)
    jv = jpar.VecGridWorld(jm.pursuit_config(m, False), [n_pred, n_prey],
                           n_envs=2,
                           placements=jm.placements(m, n_pred, n_prey,
                                                    False))

    def body(carry, _):  # scripts/bench_pursuit.py:86-95
        state, key = carry
        key, akey = jax.random.split(key)
        s = 0.0
        for view, feat in jv.observe_all(state):
            s = s + jnp.sum(view[:, 0, 0, 0, 0])
        actions = jv.random_actions(akey)
        state, rewards, alive, done = jv.transition(state, actions)
        return (state, key), s + jnp.sum(rewards[:, 0])

    @jax.jit
    def run(state, key):
        (state, key), sink = jax.lax.scan(body, (state, key), None,
                                          length=3)
        return state, key, jnp.sum(sink)

    j0 = jax.jit(jv.reset)(jax.random.PRNGKey(0))
    jstate, _, jsink = run(j0, jax.random.PRNGKey(1))
    from magent_tpu_torch import random as trandom

    venv = bench_pursuit.build(argparse.Namespace(
        map_size=m, n_envs=2, turn=False), "cpu")
    state = state_from_numpy(arrays_of(j0), "cpu")
    state, _, sink = bench_pursuit.run(venv, state,
                                       trandom.PRNGKey(1, "cpu"), 3)
    assert_states_equal(state, jstate, "bench_pursuit state")
    assert float(sink) == float(jsink)
    assert np.isfinite(float(sink))


# every module of ROADMAP item 22, with the arguments its CLI requires
MODULES = [
    ("tools.bench", []), ("tools.bench_train", []),
    ("tools.bench_pursuit", []), ("tools.profile_phases", []),
    ("tools.profile_sweep", []), ("tools.profile_drqn", []),
    ("tools.profile_micro", []), ("tools.profile_banded", []),
    ("tools.fuzz_reference", []), ("tools.fuzz_snake", []),
    ("tools.diff_seg_chip", []), ("tools.search", []),
    ("examples.train_evidence", ["--game", "tiger"]),
    ("examples.eval_checkpoint", ["--savedir",
                                  os.path.join(REPO, "data", "models"),
                                  "--name", "trusty-battle-game-l"]),
    ("examples.tournament", []), ("examples.tournament_pursuit", []),
]


@pytest.mark.parametrize("name,argv", MODULES)
def test_each_module_defaults_to_the_card(monkeypatch, tmp_path, name,
                                          argv):
    """Without ``--device`` each module resolves the card and raises where
    there is none (as on this CPU-only machine), before any work."""
    import importlib

    import torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("magent_tpu_torch." + name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_the_modules_import_no_jax():
    mods = ", ".join("magent_tpu_torch." + n for n, _ in MODULES)
    code = ("import sys, %s; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'magent_tpu.')) or m == 'magent_tpu']; "
            "assert not bad, bad" % mods)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))
