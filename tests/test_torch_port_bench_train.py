"""The port's ``tools.bench_train`` against ``scripts/bench_train.py``
(loaded with ``importlib``) on the CPU: the CLI defaults equal the
script's constants and environment defaults; the ``VecGridWorld`` and the
train-loop factories get the script's arguments for every algorithm (both
sides' calls captured); and at a small size (battle 2x10 on map 20, B=2,
rollout 3, one step per call, f32 views and nets, dqn's minibatch 256;
module constants monkeypatched in both) one warm call of ``dqn`` and of ``drqn`` from the
script's own flax init (carried across with ``params_from_flax``) gives
the script's losses within rtol 1e-5, the tolerance of the trainers'
tests (PERF.md §2).  The factories themselves are held against JAX step
by step by ``tests/test_torch_port_train*.py``, ``_a2c.py`` and
``_drqn.py``."""

import json

import numpy as np
import pytest
import torch

import magent_tpu.parallel as jpar

from magent_tpu_torch.tools import bench_train

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import RecordingJax, jax_script, port_nets_from_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FACTORIES = ("make_dqn_train_loop", "make_dqn_remat_train_loop",
             "make_a2c_train_loop", "make_drqn_train_loop")


def test_cli_defaults_match_the_jax_script():
    jm = jax_script("scripts/bench_train.py")
    args = vars(bench_train.cli().parse_args([]))
    assert args.pop("device") is None
    assert args == dict(
        algs=["dqn", "a2c", "drqn"], n_envs=jm.N_ENVS, rollout=jm.ROLLOUT,
        steps_per_call=jm.STEPS_PER_CALL, obs_dtype="bf16", net_dtype="bf16",
        sample_steps=2, drqn_remat="", drqn_share=1)
    assert (jm.N_ENVS, jm.ROLLOUT, jm.STEPS_PER_CALL) == (16, 8, 4)
    assert (bench_train.N_PER_GROUP, bench_train.MAP_SIZE,
            bench_train.CALLS) == (jm.N_PER_GROUP, jm.MAP_SIZE, jm.CALLS)


class _Built(Exception):
    pass


def _capture_jax(monkeypatch, jm, alg, env=()):
    """The JAX script's VecGridWorld call and factory call for ``alg``
    (the script stops at its factory)."""
    seen = {}
    for k, v in env:
        monkeypatch.setenv(k, v)

    def vec(cfg, caps, n_envs, obs_dtype=None, **kw):
        seen["venv"] = dict(caps=caps, n_envs=n_envs, obs_dtype=obs_dtype)
        return jpar.VecGridWorld(cfg, [10, 10], n_envs=2,
                                 obs_dtype=obs_dtype)

    def factory(name):
        def make(venv, nets, tx, **kw):
            seen["factory"] = (name, kw, [n.dtype for n in nets])
            raise _Built
        return make

    monkeypatch.setattr(jm, "VecGridWorld", vec)
    for name in FACTORIES:
        monkeypatch.setattr(jm, name, factory(name))
    with pytest.raises(_Built):
        jm.bench_alg(alg)
    monkeypatch.undo()
    return seen


def _capture_port(monkeypatch, alg, argv=()):
    seen = {}
    real_vec = bench_train.VecGridWorld

    def vec(cfg, caps, n_envs, obs_dtype=None, device=None, **kw):
        seen["venv"] = dict(caps=caps, n_envs=n_envs, obs_dtype=obs_dtype)
        return real_vec(cfg, [10, 10], n_envs=2, obs_dtype=obs_dtype,
                        device="cpu")

    def factory(name):
        def make(venv, tx, **kw):
            seen["factory"] = (name, kw)
            raise _Built
        return make

    monkeypatch.setattr(bench_train, "VecGridWorld", vec)
    for name in FACTORIES:
        monkeypatch.setattr(bench_train, name, factory(name))
    args = bench_train.cli().parse_args([alg, *argv])
    with pytest.raises(_Built):
        bench_train.build(args, alg, "cpu")
    monkeypatch.undo()
    seen["args"] = args
    return seen


def real_battle(m):
    from magent_tpu_torch.builtin.config import battle
    return battle.get_config(m)


def torch_dtype(jax_dtype):
    """A JAX script's dtype argument (None: f32) as the port's."""
    if jax_dtype is None:
        return torch.float32
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[jax_dtype.__name__]


SWITCHES = [
    ("dqn", (), ()),
    ("dqn_remat", (("BENCH_SAMPLE_STEPS", "3"),), ("--sample_steps", "3")),
    ("a2c", (("BENCH_OBS_DTYPE", "f32"),), ("--obs_dtype", "f32")),
    ("drqn", (), ()),
    ("drqn", (("BENCH_DRQN_REMAT", "none"), ("BENCH_DRQN_SHARE", "0"),
              ("BENCH_NET_DTYPE", "f32")),
     ("--drqn_remat", "none", "--drqn_share", "0", "--net_dtype", "f32")),
    ("drqn", (("BENCH_DRQN_REMAT", "dots"),), ("--drqn_remat", "dots")),
]


@pytest.mark.parametrize("alg,env,argv", SWITCHES)
def test_factory_arguments_match_the_jax_script(monkeypatch, alg, env,
                                                argv):
    """Each environment switch of the JAX script and its argument here
    give the same VecGridWorld and factory keywords."""
    jm = jax_script("scripts/bench_train.py")
    want = _capture_jax(monkeypatch, jm, alg, env)
    got = _capture_port(monkeypatch, alg, argv)
    assert got["venv"]["caps"] == want["venv"]["caps"] == [1000, 1000]
    assert got["venv"]["n_envs"] == want["venv"]["n_envs"] == 16
    assert got["venv"]["obs_dtype"] == torch_dtype(want["venv"]["obs_dtype"])
    jname, jkw = want["factory"][:2]
    name, kw = got["factory"]
    assert name == jname
    assert kw == jkw
    assert (bench_train.DTYPES[got["args"].net_dtype]
            == torch_dtype(want["factory"][2][0]))


def _small(monkeypatch, jm):
    for mod in (jm, bench_train):
        monkeypatch.setattr(mod, "N_PER_GROUP", 10)
        monkeypatch.setattr(mod, "MAP_SIZE", 20)
        monkeypatch.setattr(mod, "CALLS", 1)
    monkeypatch.setattr(jm, "N_ENVS", 2)
    monkeypatch.setattr(jm, "ROLLOUT", 3)
    monkeypatch.setattr(jm, "STEPS_PER_CALL", 1)
    monkeypatch.setenv("BENCH_OBS_DTYPE", "f32")
    monkeypatch.setenv("BENCH_NET_DTYPE", "f32")


SMALL_ARGV = ["--n_envs", "2", "--rollout", "3", "--steps_per_call", "1",
              "--obs_dtype", "f32", "--net_dtype", "f32"]


# dqn's minibatch at the small size: XLA's CPU convolutions take about
# three minutes for each call of the script's 16,384 rows (its factory
# arguments are held above at full size)
SMALL_MINIBATCH = 256


@pytest.mark.parametrize("alg", ["dqn", "drqn"])
def test_one_call_matches_jax(monkeypatch, capsys, alg):
    jm = jax_script("scripts/bench_train.py")
    rec = RecordingJax()
    monkeypatch.setattr(jm, "jax", rec)
    _small(monkeypatch, jm)
    make = jm.make_dqn_train_loop

    def small_minibatch(*a, train_minibatch, **kw):
        assert train_minibatch == 16384
        return make(*a, train_minibatch=SMALL_MINIBATCH, **kw)

    monkeypatch.setattr(jm, "make_dqn_train_loop", small_minibatch)
    jm.bench_alg(alg)
    monkeypatch.setattr(bench_train, "TRAIN_MINIBATCH", SMALL_MINIBATCH)
    printed = capsys.readouterr().out.strip().splitlines()
    loops = [c for c in rec.calls if len(c[1]) >= 6]
    assert len(loops) == 2  # the warm call and CALLS = 1 timed call
    jparams, jmetrics = loops[0][1][0], loops[0][2][-1]

    args = bench_train.cli().parse_args([alg, "--device", "cpu",
                                         *SMALL_ARGV])
    spec = bench_train.VecGridWorld(real_battle(20), [10, 10], 2,
                                    device="cpu").spec
    template = bench_train.fresh_nets(alg, spec, "cpu", torch.float32)
    nets = port_nets_from_flax(template, jparams)
    got = bench_train.bench_alg(args, alg, torch.device("cpu"), nets)
    loss = got["metrics"][0]["loss"].numpy()
    want = np.asarray(jmetrics["loss"])
    assert loss.shape == want.shape == (1, 2)
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    mine = capsys.readouterr().out.strip().splitlines()
    assert [set(json.loads(line)) for line in mine] == [
        set(json.loads(line)) for line in printed]
    assert json.loads(mine[0])["alg"] == json.loads(printed[0])["alg"] == alg


def test_trainer_loop_shares_one_carry_layout(monkeypatch):
    """``trainer_loop``'s carry per algorithm: nets, targets (copies, not
    the same modules), optimizer states, the env state (reset from
    PRNGKey(1)) and DRQN's hiddens."""
    from magent_tpu_torch import random as trandom
    from magent_tpu_torch.parallel import ClipAdam, VecGridWorld

    venv = VecGridWorld(real_battle(20), [6, 6], 2, device="cpu")
    tx = ClipAdam(1e-4, 5.0)
    monkeypatch.setattr(bench_train, "TRAIN_MINIBATCH", 64)
    want = venv.reset(trandom.PRNGKey(1, "cpu"))
    for alg, n in (("dqn", 4), ("dqn_remat", 4), ("a2c", 3), ("drqn", 5)):
        loop, carry = bench_train.trainer_loop(
            alg, venv, tx, torch.float32, rollout_len=3, steps_per_call=1)
        assert len(carry) == n
        assert torch.equal(carry[n - 1 - (alg == "drqn")].x, want.x)
        if alg != "a2c":
            for net, tnet in zip(carry[0], carry[1]):
                assert net is not tnet
                for p, q in zip(net.parameters(), tnet.parameters()):
                    assert torch.equal(p, q)
        out = loop(*carry, *bench_train.trainer_args(
            alg, trandom.PRNGKey(2, "cpu"), 0, steps_per_call=1))
        assert torch.isfinite(out[-1]["loss"]).all()
