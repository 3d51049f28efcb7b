"""Neural networks of the port (counterparts of ``magent_tpu/builtin``'s
model modules) and their flax checkpoint converters."""

from .a2c import A2CNet, CommNet
from .dqn import DQNNet
from .drqn import DRQNNet, DRQNTrunk, split_unroll
from .flax_params import params_from_flax, params_to_flax, tensors_to_flax

__all__ = ["A2CNet", "CommNet", "DQNNet", "DRQNNet", "DRQNTrunk",
           "params_from_flax", "params_to_flax", "split_unroll",
           "tensors_to_flax"]
