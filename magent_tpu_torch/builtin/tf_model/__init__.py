"""Compatibility alias: the reference exposed its models under
``magent.builtin.tf_model``; here they are PyTorch models (builtin.torch_model)."""

from ..torch_model import *  # noqa: F401,F403
from ..torch_model import DeepQNetwork  # noqa: F401
