"""Compatibility alias: the reference exposed this under
``magent.builtin.tf_model.base``; the implementation is the PyTorch model."""

from ..torch_model.base import *  # noqa: F401,F403
from ..torch_model.base import CheckpointModel  # noqa: F401
