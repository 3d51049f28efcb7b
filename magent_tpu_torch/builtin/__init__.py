"""Built-in game configurations (``config``), the rule bots
(``rule_model``), the PyTorch models (``torch_model``) and their reference
alias (``tf_model``)."""

from . import config, rule_model, tf_model, torch_model  # noqa: F401
