"""Renderer interface (port of ``magent_tpu/renderer/base_renderer.py``;
reference: python/magent/renderer/base_renderer.py).

NOTE on similarity: this is an abstract INTERFACE (method
signatures + docstrings) that downstream games implement;
the signatures are the compatibility contract with the
reference, hence the textual overlap.
"""

from abc import ABCMeta, abstractmethod


class BaseRenderer(metaclass=ABCMeta):
    @abstractmethod
    def start(self, *args, **kwargs):
        pass
