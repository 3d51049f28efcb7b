"""The port's multi-process launcher (``magent_tpu_torch/examples/
launch_multihost.py``) and scaling harness (``examples/test_scaling.py``)
on the CPU, as ``tests/test_multihost.py`` runs the JAX script: gloo CPU
ranks, one device each, every subprocess under its own timeout and each
group on a free port (the launcher picks one).  Plus: a rank that fails
brings the launcher down within seconds, and none of the new modules
loads JAX or the JAX package."""

import json
import os
import subprocess
import sys
import time

import pytest

from magent_tpu_torch.examples import launch_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
RIG = ["--nproc", "2", "--cpu_devices_per_proc", "2", "--map_size", "32",
       "--agents_per_side", "8", "--steps", "8", "--calls", "1"]


def _run(module, argv, timeout=TIMEOUT_S):
    return subprocess.run(
        [sys.executable, "-m", module] + argv, capture_output=True,
        text=True, timeout=timeout, env=launch_multihost.module_env(),
        cwd=REPO)


def _records(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("mode", ["env", "train"])
def test_multiprocess_rig_reports_the_jax_record(mode):
    """2 processes x 2 CPU ranks, map 32, 8 per side, 8 steps, 1 call:
    rank 0's record is the JAX script's (``nproc`` 2, ``n_devices`` 4:
    the global device count, a dp=4 mesh) with a positive throughput."""
    out = _run("magent_tpu_torch.examples.launch_multihost",
               RIG + ["--mode", mode])
    assert out.returncode == 0, out.stderr[-2000:]
    recs = _records(out.stdout)
    assert len(recs) == 1, out.stdout[-2000:]  # rank 0 alone prints
    rec = recs[0]
    assert rec["mode"] == mode and rec["nproc"] == 2
    assert rec["n_devices"] == 4
    assert (rec["dp"], rec["tp"]) == (4, 1)
    assert rec["backend"] == "gloo" and rec["n_envs"] == 8
    assert rec["agent_steps_per_s"] > 0


def test_a_failing_rank_brings_the_launcher_down_within_seconds():
    """``run_ranks``: the first nonzero exit kills the ranks still running
    (here one that would sleep for a minute) and raises; through the CLI,
    ranks that all fail (2000 agents do not fit a 32x32 map) exit
    nonzero."""
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="worker failed"):
        launch_multihost.run_ranks([
            [sys.executable, "-c", "import time; time.sleep(60)"],
            [sys.executable, "-c", "raise SystemExit(3)"]], poll_s=0.05)
    assert time.perf_counter() - t0 < 20
    t0 = time.perf_counter()
    out = _run("magent_tpu_torch.examples.launch_multihost",
               RIG + ["--agents_per_side", "1000"], timeout=120)
    assert out.returncode != 0
    assert "worker failed" in out.stderr
    assert time.perf_counter() - t0 < 60


def test_scaling_virtual_two_prints_points_and_efficiency():
    """``--virtual 2``: one line per point (1 and 2 ranks) and the
    efficiency line, with the JAX script's keys."""
    out = _run("magent_tpu_torch.examples.test_scaling",
               ["--virtual", "2", "--map_size", "32", "--agents_per_env",
                "16", "--envs_per_device", "2", "--steps", "4"])
    assert out.returncode == 0, out.stderr[-2000:]
    recs = _records(out.stdout)
    assert len(recs) == 3, out.stdout[-2000:]
    for n, rec in zip((1, 2), recs):
        assert sorted(rec) == ["agent_steps_per_s", "devices",
                               "env_steps_per_s"]
        assert rec["devices"] == n and rec["env_steps_per_s"] > 0
        assert rec["agent_steps_per_s"] == pytest.approx(
            rec["env_steps_per_s"] * 16)
    eff = recs[2]
    assert eff["metric"] == "scaling_efficiency_1_to_2"
    assert sorted(eff) == ["metric", "unit", "value", "vs_baseline"]
    assert eff["unit"] == "fraction" and eff["value"] > 0


def test_new_modules_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import magent_tpu_torch.parallel.sharding\n"
        "import magent_tpu_torch.examples.launch_multihost\n"
        "import magent_tpu_torch.examples.test_scaling\n"
        "import magent_tpu_torch.examples.train_battle_fused\n"
        "import magent_tpu_torch.examples.test_1m\n"
        "import magent_tpu_torch.builtin.torch_model.dqn\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'magent_tpu' or m.startswith('magent_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = launch_multihost.module_env()
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
