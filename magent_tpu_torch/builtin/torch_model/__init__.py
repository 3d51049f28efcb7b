"""Neural networks of the port (counterparts of ``magent_tpu/builtin``'s
model modules)."""

from .dqn import DQNNet, params_from_flax, params_to_flax

__all__ = ["DQNNet", "params_from_flax", "params_to_flax"]
