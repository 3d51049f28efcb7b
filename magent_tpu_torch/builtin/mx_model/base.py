"""Import-path alias: the reference's second-backend base lived at
``magent.builtin.mx_model.base``; the implementation is ``th_model.base``."""

from ..th_model.base import TorchBaseModel  # noqa: F401
