"""Neural networks of the port (counterparts of ``magent_tpu/builtin``'s
model modules), their flax checkpoint converters, and the per-agent models
over them (the JAX package's ``builtin/jax_model``)."""

from .a2c import A2CNet, AdvantageActorCritic, CommNet
from .base import CheckpointModel, latest_epoch, round_up_pow2
from .dqn import DeepQNetwork, DQNNet
from .drqn import DeepRecurrentQNetwork, DRQNNet, DRQNTrunk, split_unroll
from .flax_params import params_from_flax, params_to_flax, tensors_to_flax

__all__ = ["A2CNet", "AdvantageActorCritic", "CheckpointModel", "CommNet",
           "DQNNet", "DRQNNet", "DRQNTrunk", "DeepQNetwork",
           "DeepRecurrentQNetwork", "latest_epoch", "params_from_flax",
           "params_to_flax", "round_up_pow2", "split_unroll",
           "tensors_to_flax"]
