"""The port's second backend (``magent_tpu_torch.builtin.th_model``, with its
``mx_model`` alias) against the JAX package's
(``magent_tpu.builtin.torch_model``), on the CPU.

Both are PyTorch on the CPU with the same host NumPy streams, so
everything is exact: the initial ``state_dict`` (the JAX model seeds the
global generator, the port draws the same values from its own generator),
the actions greedy and at eps 0.3, two rounds of sample and ``train()``
(``tests/_torch_model_play.py``'s small battle: losses, values, parameters
and Adam's state), and the ``thdqn``/``tha2c`` checkpoints in both
directions.  The port models play the port's ``GridWorld`` and the JAX
models the JAX one, whose views are equal bit for bit."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import magent_tpu as jmag
from magent_tpu.builtin import torch_model as jth

import magent_tpu_torch as tmag
from magent_tpu_torch.builtin import mx_model, th_model

from _torch_model_play import play
from _torch_port_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 23
KINDS = {
    "dqn": ("DeepQNetwork", dict(batch_size=4, memory_size=256,
                                 target_update=3, train_freq=1)),
    "a2c": ("AdvantageActorCritic", {}),
}


@pytest.fixture(scope="module")
def envs():
    return {"jax": jmag.GridWorld("battle", map_size=16),
            "port": tmag.GridWorld("battle", map_size=16, device="cpu")}


def model_pair(kind, envs, seed=0, **extra):
    cls, kwargs = KINDS[kind]
    kwargs = dict(kwargs, **extra)
    jms, tms = [], []
    for i, (jh, th) in enumerate(zip(envs["jax"].get_handles(),
                                     envs["port"].get_handles())):
        jms.append(getattr(jth, cls)(envs["jax"], jh, "%s-%d" % (kind, i),
                                     seed=seed + i, **kwargs))
        tms.append(getattr(th_model, cls)(envs["port"], th,
                                          "%s-%d" % (kind, i), seed=seed + i,
                                          device="cpu", **kwargs))
    return jms, tms


def assert_state_equal(tm, jm):
    got, want = tm.net.state_dict(), jm.net.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def assert_opt_equal(tm, jm):
    got, want = tm.opt.state_dict(), jm.opt.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert sorted(got["state"]) == sorted(want["state"])
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", list(KINDS))
def test_fresh_nets_equal_jax(kind, seed, envs):
    jms, tms = model_pair(kind, envs, seed=seed)
    for jm, tm in zip(jms, tms):
        assert_state_equal(tm, jm)
        assert tm.device == torch.device("cpu")
    if kind == "dqn":
        for jm, tm in zip(jms, tms):
            tgt, want = tm.target_net.state_dict(), jm.target_net.state_dict()
            assert all(torch.equal(tgt[k], want[k]) for k in want)


@pytest.mark.parametrize("eps", [0.0, 0.3])
@pytest.mark.parametrize("kind", list(KINDS))
def test_infer_action_equals_jax(kind, eps, envs):
    jms, tms = model_pair(kind, envs, seed=3)
    cells = np.random.RandomState(1).permutation(
        [(x, y) for x in range(1, 15) for y in range(1, 15)])
    for env in envs.values():
        env.reset()
        for h, pos in zip(env.get_handles(), (cells[:40], cells[40:80])):
            env.add_agents(h, method="custom", pos=pos.tolist())
    for jm, tm, jh, th in zip(jms, tms, envs["jax"].get_handles(),
                              envs["port"].get_handles()):
        for _ in range(3):
            jobs = envs["jax"].get_observation(jh)
            tobs = envs["port"].get_observation(th)
            np.testing.assert_array_equal(tobs[0], jobs[0])
            want = jm.infer_action(jobs, None, "e_greedy", eps)
            got = tm.infer_action(tobs, None, "e_greedy", eps)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        greedy = tm.infer_action(tobs, None, "greedy")
        np.testing.assert_array_equal(greedy,
                                      jm.infer_action(jobs, None, "greedy"))
    assert tms[0].infer_action((np.zeros((0, 1)), np.zeros((0, 1))),
                               None).shape == (0,)


@pytest.mark.parametrize("kind", list(KINDS))
def test_two_trained_rounds_equal_jax(kind, envs):
    jms, tms = model_pair(kind, envs, seed=11)
    np.random.seed(SEED)
    want = play(jmag, envs["jax"], jms, 0.5)
    np.random.seed(SEED)
    got = play(tmag, envs["port"], tms, 0.5)
    for a, b in zip(got["acts"] + got["rewards"],
                    want["acts"] + want["rewards"]):
        np.testing.assert_array_equal(a, b)
    assert got["train"] == want["train"]
    assert any(np.any(np.hstack(np.asarray(r, dtype=object)).astype(float))
               for r in want["train"])
    for jm, tm in zip(jms, tms):
        assert tm.train_ct == jm.train_ct > 0
        assert_state_equal(tm, jm)
        assert_opt_equal(tm, jm)


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoints_cross_both_ways(kind, envs, tmp_path):
    sub = {"dqn": "thdqn", "a2c": "tha2c"}[kind]
    jms, tms = model_pair(kind, envs, seed=5)
    jms[0].save(str(tmp_path), 2)
    tms[1].load(str(tmp_path), 2, name="%s-0" % kind)
    assert_state_equal(tms[1], jms[0])
    tms[0].save(str(tmp_path / "port"), 4)
    assert os.listdir(tmp_path / "port" / ("%s-0" % kind)) == [sub + "_4.npz"]
    jms[1].load(str(tmp_path / "port"), 4, name="%s-0" % kind)
    assert_state_equal(tms[0], jms[1])
    with np.load(tmp_path / ("%s-0" % kind) / (sub + "_2.npz")) as a, \
            np.load(tmp_path / "port" / ("%s-0" % kind) / (sub + "_4.npz")) as b:
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    tms[1].load_state_arrays(jms[1].state_arrays())
    assert_state_equal(tms[1], jms[1])
    if kind == "dqn":
        tgt = tms[1].target_net.state_dict()
        assert all(torch.equal(tgt[k], v)
                   for k, v in tms[1].net.state_dict().items())


def test_mx_model_aliases_th_model():
    from magent_tpu_torch.builtin.mx_model import a2c, base, dqn

    assert mx_model.DeepQNetwork is th_model.DeepQNetwork
    assert mx_model.AdvantageActorCritic is th_model.AdvantageActorCritic
    assert dqn.TorchDQNNet is th_model.dqn.TorchDQNNet
    assert a2c.TorchA2CNet is th_model.a2c.TorchA2CNet
    assert base.TorchBaseModel is th_model.base.TorchBaseModel
    assert not hasattr(th_model, "DeepRecurrentQNetwork")


def test_default_device_is_the_card(envs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th_model.DeepQNetwork(envs["port"], envs["port"].get_handles()[0],
                              "x", memory_size=8)


def test_imports_load_neither_jax_nor_the_jax_package():
    """The second backend, its alias and every example module import in a
    fresh interpreter without ``jax`` or ``magent_tpu``; constructing a
    fresh net leaves the global torch generator untouched."""
    code = """
import pkgutil, sys, torch
import magent_tpu_torch.builtin.th_model, magent_tpu_torch.builtin.mx_model
import magent_tpu_torch.examples as ex
names = [m.name for m in pkgutil.iter_modules(ex.__path__)]
for n in names:
    __import__("magent_tpu_torch.examples." + n)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "magent_tpu" or m.startswith("magent_tpu.")]
assert not bad, bad
from magent_tpu_torch.builtin.th_model.base import build_net
from magent_tpu_torch.builtin.th_model.dqn import TorchDQNNet
before = torch.random.get_rng_state()
build_net(TorchDQNNet, (13, 13, 7), (34,), 21, seed=3)
assert torch.equal(before, torch.random.get_rng_state())
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 20
