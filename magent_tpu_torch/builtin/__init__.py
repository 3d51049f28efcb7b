"""Built-in game configurations (``config``), the rule bots
(``rule_model``), the PyTorch models (``torch_model``) and their reference
alias (``tf_model``), and the second NN backend (``th_model``) and its
reference alias (``mx_model``)."""

from . import config, mx_model, rule_model, tf_model, th_model, torch_model  # noqa: F401
