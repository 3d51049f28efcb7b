"""The port's scale scripts and harnesses (``magent_tpu_torch/examples``:
``test_1m``, ``test_mega``, ``test_fps``, ``test_examples``,
``test_against``, ``test_tiger``) on the CPU.

``test_1m`` at 1,000 agents against the JAX script
(``scripts/test/test_1m.py``, loaded with ``importlib``), exactly: the
host loop's world (walls and agents placed by the engine's LCG) and, with
``WARMUP_STEPS`` set to 0 in both scripts and NumPy reseeded, the alive
counts and reward sums of its first 3 steps, and both worlds driven the
same way: both groups' float rewards per step and the positions after
them, exactly; the vectorized mode's layout
(``RandomState(7)``'s rejection sampling, captured from the JAX script's
``VecGridWorld`` call) and 3 lockstep steps from the same keys (alive
flags and rewards per slot).  ``test_mega`` runs at 2,048 agents over 4
envs, f32 and bf16.  The harnesses' commands are checked with
``subprocess.run`` replaced by a stub, so that nothing is launched."""

import importlib.util
import io
import math
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import magent_tpu as jmag
import magent_tpu.parallel as jpar

from magent_tpu_torch import random as trandom
from magent_tpu_torch.examples import (test_1m, test_against, test_examples,
                                       test_fps, test_mega, test_tiger)

from _torch_port_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_AGENTS, N_STEPS = 1000, 3


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_script_" + name, os.path.join(REPO, "scripts", "test",
                                           name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def args_1m(**kw):
    base = dict(n_step=N_STEPS, agent_number=N_AGENTS, num_gpu=0, n_envs=16,
                unroll=1, vectorized=False, fast_rand=False, no_walls=False,
                frame="jax", device="cpu")
    return SimpleNamespace(**dict(base, **kw))


def test_cli_defaults_match_the_jax_script():
    args = vars(test_1m.cli().parse_args([]))
    assert args.pop("device") is None
    assert args == dict(n_step=20, agent_number=1000, num_gpu=0, n_envs=16,
                        unroll=1, vectorized=False, fast_rand=False,
                        no_walls=False, frame="jax")
    mega = vars(test_mega.cli().parse_args([]))
    assert mega == dict(agents=1000000, n_envs=64, steps=16, observe=False,
                        obs_dtype="f32", device=None)


def test_host_world_matches_jax():
    jm = jax_script("test_1m")
    env, groups, _ = test_1m.host_world(args_1m())
    n = N_AGENTS
    jenv = jmag.GridWorld(jm.load_forest(int(math.sqrt(n * 20))))
    jenv.reset()
    jenv.add_walls(method="random", n=n // 10)
    for h in jenv.get_handles():
        jenv.add_agents(h, method="random", n=n // 2)
    np.testing.assert_array_equal(np.asarray(env._get_walls_info()),
                                  np.asarray(jenv._get_walls_info()))
    for h, jh in zip(groups, jenv.get_handles()):
        assert env.get_num(h) == jenv.get_num(jh) == n // 2
        np.testing.assert_array_equal(env.get_pos(h), jenv.get_pos(jh))


def _parse_steps(text):
    steps = re.findall(r"alive=\[(\d+), (\d+)\]  reward_sum=(-?\d+)", text)
    return [([int(a), int(b)], int(r)) for a, b, r in steps]


def _drive(env, groups, actor_cls, n_steps):
    """The host loop's steps on ``env`` with ``actor_cls`` actors (NumPy
    reseeded first) -> (per step: each group's reward array and the alive
    counts; each group's positions after the last step)."""
    actors = [actor_cls(env, h, nm) for h, nm in zip(groups, ("deer",
                                                              "tiger"))]
    np.random.seed(4)
    steps = []
    for _ in range(n_steps):
        for h, actor in zip(groups, actors):
            env.set_action(h, actor.infer_action(env.get_observation(h),
                                                 None))
        env.step()
        steps.append(([np.asarray(env.get_reward(h)) for h in groups],
                      [env.get_num(h) for h in groups]))
        env.clear_dead()
    return steps, [np.asarray(env.get_pos(h)) for h in groups]


def test_host_loop_matches_jax(monkeypatch):
    """The port's ``run_host_loop`` against the JAX script's printed steps
    (alive counts; its ``%.0f`` reward sums), and both worlds driven the
    same way: every step's float reward arrays of both groups (the
    predators' -0.2 attack penalties included) and the reward sums the
    loop keeps, exactly, and the positions after the last step."""
    from magent_tpu.builtin.rule_model import RandomActor as JRandomActor

    from magent_tpu_torch.builtin.rule_model import RandomActor

    jm = jax_script("test_1m")
    monkeypatch.setattr(jm, "WARMUP_STEPS", 0)
    monkeypatch.setattr(test_1m, "WARMUP_STEPS", 0)
    args = args_1m()
    np.random.seed(4)
    out = io.StringIO()
    with redirect_stdout(out):
        jm.run_host_loop(args)
    printed = _parse_steps(out.getvalue())
    np.random.seed(4)
    got = test_1m.run_host_loop(args)
    assert len(printed) == N_STEPS and got["fps"] > 0
    assert [(alive, round(r)) for alive, r in got["steps"]] == printed
    assert got["env"]._step_fn.route.grid

    n = N_AGENTS
    jenv = jmag.GridWorld(jm.load_forest(int(math.sqrt(n * 20))))
    jenv.reset()
    jenv.add_walls(method="random", n=n // 10)
    for h in jenv.get_handles():
        jenv.add_agents(h, method="random", n=n // 2)
    want, want_pos = _drive(jenv, jenv.get_handles(), JRandomActor, N_STEPS)
    env, groups, _ = test_1m.host_world(args)
    mine, pos = _drive(env, groups, RandomActor, N_STEPS)
    reward_sum = 0.0
    for (rewards, alive), (jrewards, jalive), (loop_alive, loop_sum) in zip(
            mine, want, got["steps"]):
        assert alive == jalive == loop_alive
        for r, jr in zip(rewards, jrewards):
            assert r.dtype == jr.dtype
            np.testing.assert_array_equal(r, jr)
        reward_sum += float(sum(jrewards[1]))
        assert loop_sum == reward_sum
    for p, jp in zip(pos, want_pos):
        np.testing.assert_array_equal(p, jp)
    penalties = np.concatenate([r[0] for r, _ in want])
    assert (penalties != 0).any() and (np.concatenate(
        [r[1] for r, _ in want]) != 0).any()


class _Captured(Exception):
    pass


def test_vectorized_matches_jax(monkeypatch):
    jm = jax_script("test_1m")
    seen = {}

    def capture(cfg, caps, n_envs, placements=None, walls=None, **kw):
        seen.update(cfg=cfg, caps=caps, n_envs=n_envs, placements=placements,
                    walls=walls)
        raise _Captured

    monkeypatch.setattr(jpar, "VecGridWorld", capture)
    with pytest.raises(_Captured):
        jm.run_vectorized(args_1m(vectorized=True))
    monkeypatch.undo()
    args = args_1m(vectorized=True)
    map_size, per_env, preds, prey, walls = \
        test_1m.vectorized_placements(args)
    assert seen["caps"] == [len(preds), len(prey)] and per_env == 62
    assert seen["placements"] == [preds, prey] and seen["walls"] == walls
    assert seen["n_envs"] == 16 and len(walls) == per_env // 10 > 0

    jv = jpar.VecGridWorld(seen["cfg"], seen["caps"], n_envs=16,
                           placements=seen["placements"], walls=seen["walls"])
    transition = jax.jit(jv.transition)
    random_actions = jax.jit(jv.random_actions)
    jstate = jax.jit(jv.reset)(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    venv, _, _ = test_1m.vectorized_world(args)
    assert venv.spec.height == map_size
    carry = [venv.reset(trandom.PRNGKey(0, "cpu")), trandom.PRNGKey(1, "cpu")]
    paid = 0.0
    for _ in range(N_STEPS):
        key, akey = jax.random.split(key)
        jstate, jrew, jalive, _ = transition(jstate, random_actions(akey))
        sink, rew, alive = test_1m.sink_step(venv, carry)
        np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        assert torch.isfinite(sink)
        paid += float(np.abs(np.asarray(jrew)).sum())
    assert paid > 0
    np.testing.assert_array_equal(carry[1].numpy(), np.asarray(key))


def test_vectorized_run_reports_fps(capsys):
    out = test_1m.main(["--vectorized", "--agent_number", "256", "--n_envs",
                        "2", "--n_step", "2", "--device", "cpu"])
    assert out["fps"] > 0 and out["per_env"] == 128
    assert "FPS" in capsys.readouterr().out


def test_num_gpu_above_one_raises_citing_sharding():
    """``--num_gpu 2`` now runs, and raises nothing (the name is kept from
    before the port had sharding): the DQN actors' sharded inference,
    which on the CPU's one device caps at the single path."""
    out = test_1m.run_host_loop(args_1m(num_gpu=2, agent_number=200,
                                        n_step=1))
    assert len(out["steps"]) == 1 + test_1m.WARMUP_STEPS
    assert out["fps"] > 0


@pytest.mark.parametrize("obs_dtype", ["f32", "bf16"])
def test_mega_runs_at_2048_agents_over_4_envs(obs_dtype, capsys):
    out = test_mega.main(["--agents", "2048", "--n_envs", "4", "--steps",
                          "2", "--observe", "--obs_dtype", obs_dtype,
                          "--device", "cpu"])
    assert out["per_env"] == 512 and out["map_size"] == 101
    assert out["value"] > 0 and math.isfinite(out["sink"])
    assert "mega_battle_agent_steps_per_s" in capsys.readouterr().out


# ------------------------------------------------------------ harnesses
class _Runs:
    """A stub of ``subprocess.run`` recording each call."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __call__(self, cmd, **kw):
        self.calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, self.rc)


def test_examples_harness_commands(monkeypatch):
    runs = _Runs()
    monkeypatch.setattr(subprocess, "run", runs)
    assert test_examples.main(["--device", "cpu"]) == 0
    jax_candidates = jax_script("test_examples").candidates
    want = [[sys.executable, "-m",
             "magent_tpu_torch.examples." + script[:-3]] + extra
            + ["--backend", backend, "--device", "cpu"]
            for backend in ("jax", "torch")
            for script, extra in jax_candidates]
    assert [c for c, _ in runs.calls] == want
    for _, kw in runs.calls:
        assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    for cmd, _ in runs.calls:  # every named example exists
        importlib.import_module(cmd[2])
    failing = _Runs(rc=1)
    monkeypatch.setattr(subprocess, "run", failing)
    assert test_examples.main(["--backends", "torch"]) == 1
    assert all("--device" not in c for c, _ in failing.calls)


@pytest.mark.parametrize("mod,example", [(test_against, "train_against"),
                                         (test_tiger, "train_tiger")])
def test_sweep_harness_commands(mod, example, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    runs = _Runs()
    monkeypatch.setattr(subprocess, "run", runs)
    mod.main(["3"])
    what = example.split("_")[1]
    assert [c for c, _ in runs.calls] == [
        [sys.executable, "-m", "magent_tpu_torch.examples." + example,
         "--train", "--n_round", "3", "--alg", alg, "--name",
         "%s-%s" % (what, alg)] for alg in ("dqn", "drqn", "a2c")]
    lines = open("test_%s.log" % what).read().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == [
        "log_file: %s-%s.log" % (what, alg) for alg in ("dqn", "drqn", "a2c")]
    assert all(ln.endswith("code: 0") for ln in lines)


def test_fps_harness_commands(monkeypatch):
    runs = _Runs()
    monkeypatch.setattr(subprocess, "run", runs)
    test_fps.main(["--sizes", "1000", "100000", "--budget", "300000",
                   "--vectorized", "--device", "cpu"])
    assert [c for c, _ in runs.calls] == [
        [sys.executable, "-m", "magent_tpu_torch.examples.test_1m",
         "--agent_number", n, "--n_step", s, "--vectorized", "--device",
         "cpu"] for n, s in (("1000", "300"), ("100000", "4"))]
    assert all(kw["check"] for _, kw in runs.calls)
