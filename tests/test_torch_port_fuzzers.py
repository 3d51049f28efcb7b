"""The port's differential and sweep scripts on the CPU:
``tools.fuzz_reference`` and ``tools.fuzz_snake`` against
``scripts/test/fuzz_reference.py`` and ``fuzz_snake.py`` (loaded with
``importlib``): the random draws (``random_config``, ``random_spec``) equal
the JAX scripts' for seeds 0-24, and the port's ``--child port`` traces
equal the JAX scripts' ``--child tpu`` traces for 3 seeds, each leg a
process of its own (the snake needs a fresh process for its glibc
stream), compared by the JAX script's own ``compare`` (bit for bit; hp
rewards, views and minimaps within its 1e-5).  Also: each port fuzzer's
``main`` over port legs (``--against cpu``); ``tools.diff_seg_chip``
bit for bit at a small forest, on the pair kernels and with the
segmented sweeps engaged (``QUAD_MAX_SINGLE`` lowered), its world equal to
the JAX script's; ``tools.search``'s commands with ``subprocess.run``
stubbed."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from magent_tpu_torch import gridworld as tgw
from magent_tpu_torch.tools import diff_seg_chip, fuzz_reference, fuzz_snake
from magent_tpu_torch.tools import search

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import REPO, jax_script

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = range(3)
STEPS = 6


def describe(obj):
    """A comparable form of a config: classes by name, attributes by
    value (ranges, symbols, events and rules included)."""
    if isinstance(obj, dict):
        return {k: describe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [describe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "__dict__"):
        return (type(obj).__name__, describe(vars(obj)))
    return obj


def test_random_config_draws_match_jax():
    import magent_tpu.gridworld as jgw

    jm = jax_script("scripts/test/fuzz_reference.py")
    for seed in range(25):
        rj, rt = random.Random(seed), random.Random(seed)
        jcfg, jmap = jm.random_config(jgw, rj)
        tcfg, tmap = fuzz_reference.random_config(tgw, rt)
        assert tmap == jmap, seed
        assert describe(tcfg) == describe(jcfg), seed
        assert rt.getstate() == rj.getstate(), seed


def test_random_spec_draws_match_jax():
    jm = jax_script("scripts/test/fuzz_snake.py")
    for seed in range(25):
        assert fuzz_snake.random_spec(seed) == jm.random_spec(seed), seed


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO)


def _run_all(cmds):
    """Start every command at once, wait for all; each must exit 0."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(),
                              cwd=REPO) for c in cmds]
    for c, p in zip(cmds, procs):
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (c, err[-2000:])


def test_fuzz_reference_port_traces_match_jax(tmp_path):
    jm = jax_script("scripts/test/fuzz_reference.py")
    script = os.path.join(REPO, "scripts", "test", "fuzz_reference.py")
    cmds = []
    for seed in SEEDS:
        common = ["--seed", str(seed), "--steps", str(STEPS), "--views"]
        cmds.append([sys.executable, script, "--child", "tpu", "--out",
                     str(tmp_path / ("jax%d.npz" % seed))] + common)
        cmds.append([sys.executable, "-m",
                     "magent_tpu_torch.tools.fuzz_reference", "--child",
                     "port", "--device", "cpu", "--out",
                     str(tmp_path / ("port%d.npz" % seed))] + common)
    _run_all(cmds)
    for seed in SEEDS:
        want = jm._flat_to_trace(dict(np.load(tmp_path / ("jax%d.npz"
                                                          % seed))))
        got = fuzz_reference._flat_to_trace(dict(np.load(
            tmp_path / ("port%d.npz" % seed))))
        assert len(got) > 0 and "view0_0" in got[0]
        jm.compare(seed, want, got)


def test_fuzz_snake_port_traces_match_jax(tmp_path):
    jm = jax_script("scripts/test/fuzz_snake.py")
    script = os.path.join(REPO, "scripts", "test", "fuzz_snake.py")
    cmds = []
    for seed in SEEDS:
        spec = json.dumps(jm.random_spec(seed))
        cmds.append([sys.executable, script, "--child", "tpu", "--spec",
                     spec, "--out", str(tmp_path / ("jax%d.npz" % seed))])
        cmds.append([sys.executable, "-m", "magent_tpu_torch.tools.fuzz_snake",
                     "--child", "port", "--device", "cpu", "--spec", spec,
                     "--out", str(tmp_path / ("port%d.npz" % seed))])
    _run_all(cmds)
    for seed in SEEDS:
        want = dict(np.load(tmp_path / ("jax%d.npz" % seed)))
        got = dict(np.load(tmp_path / ("port%d.npz" % seed)))
        assert set(got) == set(want)
        for key, wv in want.items():
            if key.startswith(("rew", "view0", "feat0")):
                np.testing.assert_allclose(got[key], wv, atol=1e-5,
                                           err_msg="seed %d %s" % (seed, key))
            else:
                np.testing.assert_array_equal(got[key], wv,
                                              err_msg="seed %d %s"
                                              % (seed, key))


@pytest.mark.parametrize("mod", [fuzz_reference, fuzz_snake])
def test_fuzzer_main_over_port_legs(mod, capsys):
    argv = ["--against", "cpu", "--device", "cpu", "--seeds", "2"]
    if mod is fuzz_reference:
        argv += ["--steps", "4", "--views"]
    assert mod.main(argv) == 0
    assert "done: 2/2 seeds passed" in capsys.readouterr().out


def test_fuzzer_cli_defaults_match_the_jax_scripts():
    ref = vars(fuzz_reference.cli().parse_args([]))
    assert (ref["reference"], ref["seeds"], ref["start"], ref["steps"]) == (
        "/tmp/refbuild", 25, 0, 8)
    snake = vars(fuzz_snake.cli().parse_args([]))
    assert (snake["reference"], snake["seeds"], snake["start"]) == (
        "/tmp/refbuild", 10, 0)
    assert ref["device"] is None and snake["device"] is None


def test_diff_seg_chip_world_matches_jax():
    jm = jax_script("scripts/test/diff_seg_chip.py")
    for n in (400, 6000):
        want, got = jm.build(n), diff_seg_chip.build(n)
        assert got[1:] == want[1:], n
    args = vars(diff_seg_chip.cli().parse_args([]))
    assert (args["n"], args["steps"], args["device"]) == (6000, 20, None)


@pytest.mark.parametrize("seg", [False, True])
def test_diff_seg_chip_is_bit_for_bit(monkeypatch, seg):
    """A=400 forest, 8 steps: the pair kernels' gridless step, and (with
    ``QUAD_MAX_SINGLE`` lowered to 256) the segmented sweeps, each against
    the grid step."""
    if seg:
        monkeypatch.setattr(diff_seg_chip.ap, "QUAD_MAX_SINGLE", 256)
    out = diff_seg_chip.main(["400", "8", "--device", "cpu"])
    assert out["seg"] is seg and out["steps"] == 8


def test_search_commands(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    ran = []

    class Done:
        returncode = 0

    def run(cmd, env):
        assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
        ran.append(cmd)
        return Done()

    monkeypatch.setattr(search.subprocess, "run", run)
    search.main(["--device", "cpu", "--n_round", "3", "--map_size", "32"])
    assert [c[2:4] for c in ran] == [
        ["magent_tpu_torch.examples.train_tiger", "--train"]] * 3
    for cmd, alg in zip(ran, ["dqn", "drqn", "a2c"]):
        assert cmd[0] == sys.executable and cmd[1] == "-m"
        assert cmd[4:] == ["--n_round", "3", "--map_size", "32", "--alg",
                           alg, "--name", "train_tiger-" + alg, "--device",
                           "cpu"]
    log = (tmp_path / "search.log").read_text().splitlines()
    assert [line.split("\t")[1].strip() for line in log] == [
        "legend: dqn", "legend: drqn", "legend: a2c"]
    defaults = vars(search.cli().parse_args([]))
    assert defaults == dict(script="train_tiger.py", n_round=50, map_size=64,
                            algs=["dqn", "drqn", "a2c"], device=None)
    from magent_tpu_torch.examples import train_tiger
    assert train_tiger.cli().parse_args(ran[0][4:]).alg == "dqn"
