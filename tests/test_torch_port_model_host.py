"""The port's model-layer host code against the JAX package's on the CPU,
from the same NumPy seeds: ``EpisodesBuffer``, ``ReplayBuffer`` (its
wrap-around included), the schedulers, ``rec_round``, ``check_model``
(``tests/test_models.py``'s three cases, with no network access),
``sample_observation`` on the port's ``GridWorld`` and the four rule bots on
equal views; then ``ProcessingModel`` against ``SubprocessModel(device=
"cpu")`` over one round trip, the models' default device, bf16 models
(finite, f32 parameters), and the package surface (the names the JAX
package exports, no JAX loaded).  All exact:
this is host NumPy with the same calls in the same order, and the threefry
draws are bit-equal."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import magent_tpu as jmag
from magent_tpu import utility as jutil
from magent_tpu.builtin import common as jcommon
from magent_tpu.builtin import rule_model as jrule

import magent_tpu_torch as tmag
from magent_tpu_torch import utility as tutil
from magent_tpu_torch.builtin import common as tcommon
from magent_tpu_torch.builtin import rule_model as trule
from magent_tpu_torch.builtin.torch_model import (AdvantageActorCritic,
                                                  DeepQNetwork,
                                                  DeepRecurrentQNetwork)

from _torch_model_play import play
from _torch_port_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = ([[3, 3], [5, 5], [3, 7]], [[10, 10], [12, 12], [10, 8]])


def small_battle(mag, **kw):
    env = mag.GridWorld("battle", map_size=16, **kw)
    env.reset()
    for h, pos in zip(env.get_handles(), POS):
        env.add_agents(h, method="custom", pos=pos)
    return env


def record(util, seed, capacity):
    """Eight steps of 10 ids (ids 3-6 die at step 4) into an
    ``EpisodesBuffer`` of ``capacity`` -> its entries in admission order."""
    rng = np.random.RandomState(seed)
    np.random.seed(seed)
    buf = util.EpisodesBuffer(capacity)
    ids = np.arange(10, dtype=np.int32) * 7
    for t in range(8):
        live = ids if t < 5 else np.concatenate([ids[:3], ids[7:]])
        n = len(live)
        obs = (rng.rand(n, 3, 3, 2).astype(np.float32),
               rng.rand(n, 4).astype(np.float32))
        alive = ~((t == 4) & np.isin(live, ids[3:7]))
        buf.record_step(live, obs, rng.randint(0, 5, n).astype(np.int32),
                        rng.randn(n).astype(np.float32), alive)
    return [(k, e.terminal, np.asarray(e.views), np.asarray(e.features),
             e.actions, e.rewards) for k, e in buf.buffer.items()]


@pytest.mark.parametrize("capacity", [4, 100])
def test_episodes_buffer_matches_jax(capacity):
    got, want = record(tutil, 3, capacity), record(jutil, 3, capacity)
    assert len(got) == len(want) == min(capacity, 10)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(a, b)
    assert any(w[1] for w in want) or capacity < 10


@pytest.mark.parametrize("dtype", [np.float32, np.int32, bool])
def test_replay_buffer_wraps_as_jax(dtype):
    """Batches of 3, 5, 2, 6 and 1 rows into a ring of 7: two of them
    wrap around (split writes)."""
    bufs = [m.ReplayBuffer((7, 2), dtype) for m in (tcommon, jcommon)]
    for b in bufs:
        b.buffer[:] = 0
    rng = np.random.RandomState(0)
    for n in (3, 5, 2, 6, 1):
        data = rng.randint(0, 100, (n, 2)).astype(dtype)
        assert [b.put(data) for b in bufs] == [n, n]
        np.testing.assert_array_equal(bufs[0].buffer, bufs[1].buffer)
        assert bufs[0].head == bufs[1].head
        idx = rng.randint(0, 7, 4)
        np.testing.assert_array_equal(bufs[0].get(idx), bufs[1].get(idx))
    for b in bufs:
        b.clear()
    assert bufs[0].head == bufs[1].head == 0


@pytest.mark.parametrize("name,args", [
    ("exponential_decay", (0, 100, 0.05, 0.5)),
    ("exponential_decay", (37, 100, 0.05, 0.5)),
    ("exponential_decay", (400, 100, 0.05, 2.0)),
    ("linear_decay", (0, 50, 0.1)),
    ("linear_decay", (33, 50, 0.1)),
    ("linear_decay", (90, 50, 0.1)),
    ("piecewise_decay", (-5, [0, 10, 30], [1.0, 0.5, 0.1])),
    ("piecewise_decay", (7, [0, 10, 30], [1.0, 0.5, 0.1])),
    ("piecewise_decay", (10, [0, 10, 30], [1.0, 0.5, 0.1])),
    ("piecewise_decay", (29, [0, 10, 30], [1.0, 0.5, 0.1])),
    ("piecewise_decay", (31, [0, 10, 30], [1.0, 0.5, 0.1])),
])
def test_schedulers_match_jax(name, args):
    assert getattr(tutil, name)(*args) == getattr(jutil, name)(*args)


def test_rec_round_matches_jax():
    x = [np.float32(-825.3849), [1.23456, np.float64(2.5e-3)], 7]
    got, want = tutil.rec_round(x), jutil.rec_round(x)
    assert got == want == [-825.38, [1.23, 0.0], 7.0]
    assert tutil.rec_round(np.float32(3.14159), 3) == 3.142
    assert tmag.round is tutil.rec_round


def test_check_model(tmp_path, monkeypatch):
    """``tests/test_models.py::test_check_model``'s three cases; the absent
    case raises, names the bundled directory and opens no connection."""
    def no_network(*args, **kwargs):
        raise AssertionError("check_model opened a connection")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="Unknown model name"):
        tutil.check_model("bogus")

    p = tmp_path / "save_model" / "arrange"
    p.mkdir(parents=True)
    (p / "dqn_10.npz").write_bytes(b"")
    tutil.check_model("arrange")  # present -> no raise

    with pytest.raises(RuntimeError) as err:
        tutil.check_model("battle-game")
    assert tutil.bundled_model_dir() in str(err.value)
    assert tutil.bundled_model_dir() == jutil.bundled_model_dir()
    assert os.path.exists(os.path.join(
        tutil.bundled_model_dir(), "trusty-battle-game-l", "tfdqn_0.npz"))


def test_sample_observation_matches_jax():
    """Random actors on the small battle, 4 steps, 12 observations drawn
    per group, the same NumPy seed in both packages."""
    out = {}
    for tag, mag, util, kw in (("jax", jmag, jutil, {}),
                               ("port", tmag, tutil, dict(device="cpu"))):
        env = small_battle(mag, **kw)
        np.random.seed(5)
        out[tag] = util.sample_observation(env, env.get_handles(), 12, 3)
    for (tv, tf), (jv, jf) in zip(out["port"], out["jax"]):
        assert tv.shape == jv.shape == (12, 13, 13, 7)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def gather_views(rng, n, h, w):
    """Views of the gather bot's channels: food (4) in a few cells, the
    agent itself (3, above 1), a minimap (6) with a few positive cells."""
    views = np.zeros((n, h, w, 7), np.float32)
    for i in range(n):
        for _ in range(rng.randint(0, 4)):
            views[i, rng.randint(h), rng.randint(w), 4] = 1.0
        views[i, h // 2, w // 2, 3] = 1.5
        for _ in range(rng.randint(0, 3)):
            views[i, rng.randint(h), rng.randint(w), 6] = rng.rand()
    return views


@pytest.mark.parametrize("bot", ["RandomActor", "RushPredator",
                                 "RunawayPrey", "RushGatherer"])
def test_rule_bots_match_jax(bot):
    """Each bot of both packages on the same views, the same NumPy seed:
    pursuit's predators and prey (map 24) for the rush and run-away bots,
    battle for the random actor, the gather channels for the gatherer."""
    game = "pursuit" if bot in ("RushPredator", "RunawayPrey") else "battle"
    envs = {"jax": jmag.GridWorld(game, map_size=24),
            "port": tmag.GridWorld(game, map_size=24, device="cpu")}
    env = envs["port"]
    env.reset()
    env.add_agents(env.get_handles()[0], method="random", n=12)
    env.add_agents(env.get_handles()[1], method="random", n=30)
    g = 1 if bot == "RunawayPrey" else 0
    view, feat = env.get_observation(env.get_handles()[g])
    if bot == "RushGatherer":
        view = gather_views(np.random.RandomState(2), 40, 13, 13)
        feat = np.zeros((40, 34), np.float32)
    assert len(view) > 5
    acts = {}
    for tag, rule in (("jax", jrule), ("port", trule)):
        handles = envs[tag].get_handles()
        other = handles[1 - g]
        model = getattr(rule, bot)(envs[tag], handles[g], other)
        np.random.seed(9)
        acts[tag] = model.infer_action((view, feat), None)
    np.testing.assert_array_equal(acts["port"], acts["jax"])
    assert acts["port"].dtype == np.int32
    if bot == "RushPredator":  # predators next to prey attack
        assert (acts["port"] >= env.get_view2attack(
            env.get_handles()[0])[0]).any()


@pytest.fixture
def hosted():
    """A ``SubprocessModel`` (spawned worker on the CPU) and a
    ``ProcessingModel`` of the same DQN, seed and weights."""
    env = small_battle(tmag, device="cpu")
    h = env.get_handles()[0]
    kw = dict(batch_size=4, memory_size=256, target_update=10, train_freq=1,
              seed=3)
    sub = tmag.SubprocessModel(env, h, "hosted", 0, 100, DeepQNetwork,
                               device="cpu", **kw)
    local = tmag.ProcessingModel(env, h, "local", 0, 100, DeepQNetwork,
                                 device="cpu", **kw)
    yield env, h, sub, local
    sub.quit()


def test_subprocess_model_matches_processing_model(hosted, tmp_path):
    """act (non-blocking), sample, train, save and load over the pipe; the
    worker's actions equal the in-process model's on the same seed and
    weights, before and after the weights cross by checkpoint."""
    env, h, sub, local = hosted
    for step in range(3):
        obs, ids = env.get_observation(h), env.get_agent_id(h)
        sub.infer_action(obs, ids, "e_greedy", 0.5, block=False)
        acts = sub.fetch_action()
        assert acts.dtype == np.int32 and acts.shape == (len(ids),)
        np.testing.assert_array_equal(
            acts, local.infer_action(obs, ids, "e_greedy", 0.5))
        env.set_action(h, acts)
        env.step()
        rewards, alives = env.get_reward(h), env.get_alive(h)
        sub.sample_step(rewards, alives, block=False)
        assert sub.check_done() == "done"
        local.sample_step(rewards, alives)
        env.clear_dead()
    sub.train(print_every=1000, block=False)
    loss, value = sub.fetch_train()
    assert np.isfinite(loss) and np.isfinite(value) and loss > 0
    assert all(np.isfinite(local.train(print_every=1000)))

    sub.save(str(tmp_path), 1)
    local.load(str(tmp_path), 1, name="hosted")
    obs, ids = env.get_observation(h), env.get_agent_id(h)
    np.testing.assert_array_equal(sub.infer_action(obs, ids, "greedy"),
                                  local.infer_action(obs, ids, "greedy"))
    local.save(str(tmp_path), 2)
    sub.load(str(tmp_path), 2, name="local")
    with np.load(tmp_path / "local" / "tfdqn_2.npz") as f:
        flat = dict(f)
    assert set(flat) == set(local.model.get_params())
    sub.quit()
    assert not sub.proc.is_alive() and sub.proc.exitcode == 0


def test_subprocess_worker_reports_protocol_misuse(hosted):
    _, _, sub, _ = hosted
    sub.conn.send(("sample", None))
    from magent_tpu_torch.model import _send_arrays
    _send_arrays(sub.conn, [np.zeros(1, np.float32), np.ones(1, bool)])
    with pytest.raises(RuntimeError, match="sample before act"):
        sub.check_done()
    sub.conn.send(("bogus", None))
    with pytest.raises(RuntimeError, match="unknown command"):
        sub.check_done()


@pytest.mark.parametrize("cls", [DeepQNetwork, AdvantageActorCritic,
                                 DeepRecurrentQNetwork])
def test_models_default_to_the_card(cls):
    """No ``device``: the card, and a ``RuntimeError`` without one; never
    a silent fall back to the CPU."""
    env = small_battle(tmag, device="cpu")
    h = env.get_handles()[0]
    if torch.cuda.is_available():
        assert cls(env, h, "m", memory_size=64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(env, h, "m", memory_size=64)
    m = cls(env, h, "m", memory_size=64, device="cpu")
    assert m.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in m.net.parameters())


@pytest.mark.parametrize("cls,kw", [
    (DeepQNetwork, dict(batch_size=4, memory_size=256)),
    (AdvantageActorCritic, dict(use_comm=True)),
    (DeepRecurrentQNetwork, dict(batch_size=4, unroll_step=4,
                                 memory_size=400)),
])
def test_bf16_models_train(cls, kw):
    """``dtype="bf16"`` runs the nets' trunks in bfloat16 with f32
    parameters (``tests/test_models.py::test_bf16_model_dtype``'s
    check): a round of ``_torch_model_play.play`` gives finite losses and
    leaves every parameter f32."""
    env = small_battle(tmag, device="cpu")
    models = [cls(env, h, "bf16-%d" % i, dtype="bf16", seed=i,
                  device="cpu", **kw)
              for i, h in enumerate(env.get_handles())]
    assert all(m.net.dtype == torch.bfloat16 for m in models)
    np.random.seed(0)
    rec = play(tmag, env, models, 0.5, rounds=1)
    assert all(np.isfinite(np.hstack(r).astype(np.float64)).all()
               for r in rec["train"])
    for m in models:
        assert all(p.dtype == torch.float32 for p in m.net.parameters())
        assert m.opt_state.count >= 1


def test_dqn_sharding_is_not_ported():
    """``num_gpu=2`` now works (the name is kept from before the port had
    sharding): it shards the inference over the local devices, on the
    CPU the model's one device (so it caps at 1, the single path), or the
    devices it is given."""
    env = small_battle(tmag, device="cpu")
    h = env.get_handles()[0]
    model = DeepQNetwork(env, h, "m", num_gpu=2, memory_size=64,
                         device="cpu")
    assert model._infer_devices == 1 and model._replicas is None
    model = DeepQNetwork(env, h, "m", num_gpu=2, memory_size=64,
                         device="cpu", devices=["cpu"] * 3)
    assert model._infer_devices == 2 and len(model._replicas) == 2


@pytest.mark.parametrize("modules", [
    "magent_tpu_torch",
    "magent_tpu_torch.model, magent_tpu_torch.utility",
    "magent_tpu_torch.builtin.tf_model, magent_tpu_torch.builtin.rule_model",
])
def test_package_exports_model_layer_and_imports_no_jax(modules):
    """``import magent_tpu_torch as m`` gives the JAX package's names
    (``utility``, ``BaseModel``, ``ProcessingModel``, ``SubprocessModel``,
    ``round``) and the builtin model packages, loading neither JAX nor any
    ``magent_tpu`` module."""
    for name in ("utility", "BaseModel", "ProcessingModel",
                 "SubprocessModel", "round"):
        assert name in tmag.__all__ and name in jmag.__all__
    code = (
        "import sys, %s; import magent_tpu_torch as m; "
        "tm = m.builtin.torch_model; "
        "assert m.round is m.utility.rec_round; "
        "assert m.BaseModel and m.ProcessingModel and m.SubprocessModel; "
        "assert m.builtin.rule_model.RushGatherer; "
        "assert m.builtin.tf_model.DeepQNetwork is tm.DeepQNetwork; "
        "assert tm.AdvantageActorCritic and tm.DeepRecurrentQNetwork; "
        "bad = sorted(x for x in sys.modules if x.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'magent_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)" % modules)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
