"""Compatibility alias: the reference exposed this under
``magent.builtin.tf_model.dqn``; the implementation is the PyTorch model."""

from ..torch_model.dqn import *  # noqa: F401,F403
from ..torch_model.dqn import DeepQNetwork  # noqa: F401
