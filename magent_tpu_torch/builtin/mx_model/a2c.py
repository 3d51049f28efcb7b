"""Import-path alias: the reference's second-backend A2C lived at
``magent.builtin.mx_model.a2c``; the implementation is ``th_model.a2c``."""

from ..th_model.a2c import AdvantageActorCritic, TorchA2CNet  # noqa: F401
