"""Compatibility alias: the reference exposed this under
``magent.builtin.tf_model.drqn``; the implementation is the PyTorch model."""

from ..torch_model.drqn import *  # noqa: F401,F403
from ..torch_model.drqn import DeepRecurrentQNetwork  # noqa: F401
