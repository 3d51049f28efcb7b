"""Import-path alias: the reference's second-backend DQN lived at
``magent.builtin.mx_model.dqn``; the implementation is ``th_model.dqn``."""

from ..th_model.dqn import DeepQNetwork, TorchDQNNet  # noqa: F401
