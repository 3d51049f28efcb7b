"""The port's example scripts (counterparts of the repository's
``examples/``): run each as ``python -m magent_tpu_torch.examples.<name>``
from the repository root."""
