"""Interactive live rendering (PyGame client + game servers), capability
parity with the reference renderer package (port of ``magent_tpu/renderer``;
reference: python/magent/renderer/).  Importing it loads no ``pygame``."""

from .base_renderer import BaseRenderer
from .pygame_renderer import PyGameRenderer

__all__ = ["BaseRenderer", "PyGameRenderer"]
