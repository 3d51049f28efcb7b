"""The second NN backend (port of ``magent_tpu/builtin/torch_model``): the
JAX package's PyTorch DQN and A2C (``thdqn``/``tha2c``), each with a
parameter layout and checkpoints of its own, on ``device`` (``None``: the
card).  The reference shipped TensorFlow and MXNet; its second backend's
name, ``mx_model``, aliases this one."""

from .a2c import AdvantageActorCritic
from .dqn import DeepQNetwork

__all__ = ["DeepQNetwork", "AdvantageActorCritic"]
