"""Reproducibility on the card (JAX-free): an f32 train step gives the same
parameters from the same key, run after run.  cuDNN's default backward
convolutions sum in an order that varies from run to run; the trainers'
halves and the per-agent models' ``train`` run on its deterministic
algorithms (``builtin.torch_model.base.deterministic_convolutions``), which
restores the caller's flags after.  Two runs of 2 ``dqn`` train steps at
``tools.bench_train``'s geometry with 4 envs (battle 2x1000, map 200,
rollout 8, f32 views and nets), and two rounds of ``DeepQNetwork`` play
and ``train`` on the card (``tests/_torch_model_play.py``'s
``DQN_REPRO``: battle map 40, 64 agents a side, batch 64, a size at which
two runs on cuDNN's defaults differ), each pair bit for bit.  Marked ``gpu``: each test decides at run time
whether a card exists and skips without one.  On a machine with an H100:
python -m pytest tests/test_torch_port_determinism_gpu.py -q"""

import pytest
import torch

import magent_tpu_torch as tmag
from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.torch_model import DeepQNetwork
from magent_tpu_torch.tools import bench_train

from _torch_model_play import DQN_REPRO, dqn_train_params

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32
    cudnn.deterministic = cudnn.benchmark = False  # PyTorch's defaults
    cudnn.allow_tf32 = False
    yield torch.device("cuda")
    assert (cudnn.deterministic, cudnn.benchmark) == (False, False)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved


def _dqn_params(device, dtype):
    args = bench_train.cli().parse_args(
        ["dqn", "--n_envs", "4", "--obs_dtype", dtype, "--net_dtype", dtype])
    loop, carry = bench_train.build(args, "dqn", device)
    key = trandom.PRNGKey(2, device)
    for s in range(2):
        nets, opts, state, _ = loop.train_step(
            *carry, trandom.fold_in(key, s), bench_train.EPS)
        carry[0], carry[2], carry[3] = nets, opts, state
    return [p.detach().clone() for n in carry[0] for p in n.parameters()]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dqn_train_steps_repeat_bit_for_bit(cuda, dtype):
    a, b = _dqn_params(cuda, dtype), _dqn_params(cuda, dtype)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_deep_q_network_train_repeats_bit_for_bit(cuda):
    a, b = (dqn_train_params(tmag, DeepQNetwork, cuda, **DQN_REPRO)
            for _ in range(2))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
