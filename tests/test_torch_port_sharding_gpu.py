"""The port's mesh on the card (JAX-free; TF32 off): ``chip_smoke.py``
phase 14 (a) and (d) as tests.

- (a) a one-rank mesh (``make_mesh()``: the card, no launcher) gives the
  unsharded result bit for bit: the ``dqn`` fused trainer placed through
  ``param_sharding`` over two train steps (losses, parameters, moments,
  env state), in f32 and in bf16 (views and trunk), both runs on cuDNN's
  deterministic algorithms (the card's own run-to-run variation of the
  convolutions' gradient sums is not the mesh's), and the lockstep loop
  of a mesh venv from a state placed by ``state_sharding``;
- (d) ``DeepQNetwork(num_gpu=2)`` on one card caps at one device, and
  with the card twice as its devices runs two replicas on it: greedy and
  eps-0.3 actions equal the unsharded model's.

Marked ``gpu``: each test decides at run time whether a card exists and
skips without one.  On a machine with an H100:
python -m pytest tests/test_torch_port_sharding_gpu.py -q"""

import copy

import numpy as np
import pytest
import torch

import magent_tpu_torch as tmag
from magent_tpu_torch import random as rnd
from magent_tpu_torch.builtin.config import battle
from magent_tpu_torch.builtin.torch_model import DeepQNetwork, DQNNet
from magent_tpu_torch.builtin.torch_model.flax_params import init_dense_
from magent_tpu_torch.core.state import FIELDS
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld, device_put,
                                       make_dqn_train_step, make_mesh,
                                       param_sharding, state_sharding)

pytestmark = pytest.mark.gpu

MAP, CAPS, B = 64, [100, 100], 4


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


def _states_equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture
def deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dqn_trainer_on_a_one_rank_mesh_is_bit_for_bit(
        cuda, deterministic_cudnn, dtype):
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.device.type == "cuda"
    runs = []
    for placed in (False, True):
        venv = VecGridWorld(battle.get_config(MAP), CAPS, B,
                            obs_dtype=dtype, mesh=mesh if placed else None)
        spec = venv.spec
        nets = []
        for g in range(2):
            net = DQNNet(spec.view_space(g), spec.feature_size(g),
                         spec.groups[g].type.n_action, dtype=dtype)
            init_dense_(net, torch.Generator().manual_seed(g))
            nets.append(net.to(venv.device))
        nets = tuple(nets)
        tx = ClipAdam(1e-4, 5.0)
        opts = tuple(tx.init(n) for n in nets)
        tgt = tuple(copy.deepcopy(n).requires_grad_(False) for n in nets)
        if placed:
            placement = param_sharding(mesh, nets)
            nets, tgt, opts = (device_put(t, placement)
                               for t in (nets, tgt, opts))
        step = make_dqn_train_step(venv, tx, rollout_len=4,
                                   train_minibatch=512)
        state = venv.reset(rnd.PRNGKey(1))
        metrics = []
        for s in range(2):
            nets, opts, state, m = step(nets, tgt, opts, state,
                                        rnd.fold_in(rnd.PRNGKey(2), s), 0.3)
            metrics.append(m)
        runs.append((nets, opts, state, metrics))
    (n0, o0, s0, m0), (n1, o1, s1, m1) = runs
    for a, b in zip(m0, m1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _states_equal(s1, s0)
    for g in range(2):
        for p, q in zip(n0[g].parameters(), n1[g].parameters()):
            assert torch.equal(p, q)
        for p, q in zip(o0[g].mu + o0[g].nu, o1[g].mu + o1[g].nu):
            assert torch.equal(p, q)


def test_lockstep_on_a_one_rank_mesh_is_bit_for_bit(cuda):
    mesh = make_mesh()
    venv = VecGridWorld(battle.get_config(MAP), CAPS, B)
    mvenv = VecGridWorld(battle.get_config(MAP), CAPS, B, mesh=mesh)
    state = venv.reset(rnd.PRNGKey(0))
    states = [state, device_put(state, state_sharding(mesh, state))]
    sums = [[], []]
    for i, v in enumerate((venv, mvenv)):
        key = rnd.PRNGKey(2)
        for _ in range(10):
            key, akey = rnd.split(key).unbind(-2)
            s = sum(view.float().sum() for view, _ in
                    v.observe_all(states[i]))
            states[i], rew, _, _ = v.transition(states[i],
                                                v.random_actions(akey))
            sums[i].append(s + rew.sum())
    assert torch.equal(torch.stack(sums[0]), torch.stack(sums[1]))
    _states_equal(states[1], states[0])


def test_sharded_inference_on_one_card(cuda):
    env = tmag.GridWorld("battle", map_size=32)
    h = env.get_handles()[0]
    base = DeepQNetwork(env, h, "one", memory_size=64)
    capped = DeepQNetwork(env, h, "one", memory_size=64, num_gpu=2)
    two = DeepQNetwork(env, h, "one", memory_size=64, num_gpu=2,
                       devices=["cuda:0", "cuda:0"])
    n_cards = torch.cuda.device_count()
    assert capped._infer_devices == min(2, n_cards)
    assert two._infer_devices == 2
    flat = base.get_params()
    rng = np.random.RandomState(0)
    view = rng.rand(1500, *base.view_space).astype(np.float32)
    feat = rng.rand(1500, *base.feature_space).astype(np.float32)
    ids = np.arange(1500)
    acts = []
    for m in (base, capped, two):
        m.set_params(flat)
        key0 = m.key
        greedy = m.infer_action((view, feat), ids, policy="greedy")
        m.key = key0
        acts.append((greedy, m.infer_action((view, feat), ids, eps=0.3)))
    for greedy, eps in acts[1:]:
        np.testing.assert_array_equal(greedy, acts[0][0])
        np.testing.assert_array_equal(eps, acts[0][1])
