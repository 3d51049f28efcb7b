"""Import-path alias: the reference exposed its second NN backend under
``magent.builtin.mx_model`` (MXNet DQN and A2C,
python/magent/builtin/mx_model/__init__.py); here it is ``th_model``, as
in the JAX package."""

from ..th_model import AdvantageActorCritic, DeepQNetwork  # noqa: F401

__all__ = ["DeepQNetwork", "AdvantageActorCritic"]
