"""The port's examples and second backend on the card against the same runs
on the CPU (JAX-free; f32, TF32 off).

- ``th_model``'s DQN and A2C: fresh nets equal on both devices (drawn on
  the CPU from one seeded generator); the CPU and card models on the same
  views: Q values and policies within ``ATOL`` 1e-5, greedy actions equal
  wherever the top two Q values lie more than ``MARGIN`` 1e-5 apart, A2C's
  draws equal wherever the host's uniform lies more than ``MARGIN`` from
  a boundary of the policy's running sum; one ``train()`` on copies of one
  recorded episode buffer (the same host rows): what it returns within
  rtol ``RTOL`` 1e-5, parameters within ``2.2 lr`` per Adam step; a
  checkpoint saved from the card loaded into a CPU model bit for bit;
- one round of train_battle and train_tiger (the reference harness's
  sizes, cut to ``STEPS`` steps, round 0's eps 1) on both backends through
  their ``setup``: counts and reward totals exact, what ``train`` returns
  within ``RTOL``.

Marked ``gpu``: each test decides at run time whether a card exists and
skips without one.  On a machine with an H100:
python -m pytest tests/test_torch_port_examples_gpu.py -q"""

import copy
import importlib

import numpy as np
import pytest
import torch

import magent_tpu_torch as tmag
from magent_tpu_torch.builtin import th_model

from _torch_model_play import MARGIN, place_small, top_two_gap

pytestmark = pytest.mark.gpu

ATOL = 1e-5
RTOL = 1e-5
STEPS = 6
SEED = 9
LR = {"dqn": 1e-4, "a2c": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def recorded_round(env, steps=5):
    """One round of the small battle with NumPy's random actions, recorded
    per group -> (buffers, the last step's observations)."""
    handles = env.get_handles()
    env.reset()
    place_small(env, handles)
    rng = np.random.RandomState(SEED)
    buffers = [tmag.utility.EpisodesBuffer(100) for _ in handles]
    for _ in range(steps):
        obs = [env.get_observation(h) for h in handles]
        ids = [env.get_agent_id(h) for h in handles]
        acts = [rng.randint(0, env.get_action_space(h)[0],
                            env.get_num(h)).astype(np.int32)
                for h in handles]
        for h, a in zip(handles, acts):
            env.set_action(h, a)
        env.step()
        for i, h in enumerate(handles):
            buffers[i].record_step(ids[i], obs[i], acts[i], env.get_reward(h),
                                   env.get_alive(h))
        env.clear_dead()
    return buffers, obs


@pytest.mark.parametrize("kind", ["dqn", "a2c"])
def test_th_model_gpu_matches_cpu(cuda, kind, tmp_path):
    cls = {"dqn": th_model.DeepQNetwork,
           "a2c": th_model.AdvantageActorCritic}[kind]
    kw = dict(batch_size=4, memory_size=256, target_update=3) \
        if kind == "dqn" else {}
    env = tmag.GridWorld("battle", map_size=16, device="cpu")
    h = env.get_handles()[0]
    cm, gm = (cls(env, h, "m", seed=4, device=d, **kw)
              for d in ("cpu", "cuda"))
    for k, v in cm.net.state_dict().items():
        assert torch.equal(gm.net.state_dict()[k].cpu(), v), k
    buffers, obs = recorded_round(env)
    view, feat = obs[0]

    with torch.no_grad():
        want = cm.net(cm._tensor(view), cm._tensor(feat))
        got = gm.net(gm._tensor(view), gm._tensor(feat))
    if kind == "dqn":
        q = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), q, atol=ATOL, rtol=0)
        clear = top_two_gap(q) > MARGIN
        np.testing.assert_array_equal(
            gm.infer_action(obs[0], None, "greedy")[clear],
            cm.infer_action(obs[0], None, "greedy")[clear])
    else:
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                                   atol=ATOL, rtol=0)
        probe = copy.deepcopy(cm._rng)
        cdf = np.cumsum(want[0].numpy(), axis=1)
        u = probe.rand(len(view), 1) * cdf[:, -1:]
        clear = np.abs(cdf - u).min(axis=1) > MARGIN
        np.testing.assert_array_equal(
            gm.infer_action(obs[0], None)[clear],
            cm.infer_action(obs[0], None)[clear])

    got_out = gm.train(copy.deepcopy(buffers[0]))
    want_out = cm.train(copy.deepcopy(buffers[0]))
    np.testing.assert_allclose(_flat(got_out), _flat(want_out), rtol=RTOL)
    steps = cm.train_ct
    assert gm.train_ct == steps > 0
    for k, v in cm.net.state_dict().items():
        np.testing.assert_allclose(gm.net.state_dict()[k].cpu().numpy(),
                                   v.numpy(), rtol=0,
                                   atol=2.2 * LR[kind] * steps, err_msg=k)

    gm.save(str(tmp_path), 1)
    back = cls(env, h, "other", seed=8, device="cpu", **kw)
    back.load(str(tmp_path), 1, name="m")
    for k, v in gm.net.state_dict().items():
        assert torch.equal(back.net.state_dict()[k], v.cpu()), k


def example_round(name, backend, device, argv):
    """One round of example ``name`` through its ``setup`` on ``device``,
    cut to STEPS steps -> (nums, reward totals, what train returned)."""
    mod = importlib.import_module("magent_tpu_torch.examples." + name)
    if hasattr(mod, "_flip"):
        mod._flip[0] = False
    args = mod.cli().parse_args(argv + ["--backend", backend, "--device",
                                        device])
    ex = mod.setup(args)
    ex.runner.max_steps = STEPS - 1
    ex.new_round()
    np.random.seed(SEED)
    totals = ex.runner.sample(mod.round_eps(args, 0))
    return list(ex.runner.nums), totals, ex.runner.train()


@pytest.mark.parametrize("backend", ["jax", "torch"])
@pytest.mark.parametrize("name,argv", [
    ("train_battle", ["--train", "--map_size", "32"]),
    ("train_tiger", ["--train", "--map_size", "64"]),
])
def test_example_round_gpu_matches_cpu(cuda, name, argv, backend, tmp_path,
                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = example_round(name, backend, "cpu", argv)
    got = example_round(name, backend, "cuda", argv)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    flat = [np.asarray(_flat(x), float) for x in (got[2], want[2])]
    assert np.any(flat[1])
    np.testing.assert_allclose(flat[0], flat[1], rtol=RTOL)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [float(x)]
