"""Compatibility alias: the reference exposed this under
``magent.builtin.tf_model.a2c``; the implementation is the PyTorch model."""

from ..torch_model.a2c import *  # noqa: F401,F403
from ..torch_model.a2c import AdvantageActorCritic  # noqa: F401
