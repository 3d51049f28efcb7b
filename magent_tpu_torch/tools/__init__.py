"""Measurement tools of the port; each runs as ``python -m
magent_tpu_torch.tools.<name>``."""
