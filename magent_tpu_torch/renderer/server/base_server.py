"""Abstract live-game server driven by the PyGame client (port of
``magent_tpu/renderer/server/base_server.py``; reference:
python/magent/renderer/server/base_server.py).

A server owns a live environment (or synthetic data) and answers the
client's queries frame by frame:

- ``get_info() -> ((w, h), groups_info, static_info)`` once at startup;
- ``get_status(frame_id)``: True = advance, False = paused waiting for
  user input, None = game over;
- ``get_data(frame_id, x_range, y_range) -> (pos, events)`` where ``pos``
  maps agent id to [x, y, group] and events are (op, x, y) attack marks;
- ``get_banners`` / ``get_endscreen``: styled text rows;
- ``keydown`` / ``mousedown``: user input forwarded from the client; the
  return value signals whether the frame counter should advance.

NOTE on similarity: this is an abstract INTERFACE (method
signatures + docstrings) that downstream games implement;
the signatures are the compatibility contract with the
reference, hence the textual overlap.
"""

from abc import ABCMeta, abstractmethod


class BaseServer(metaclass=ABCMeta):
    @abstractmethod
    def get_info(self):
        pass

    @abstractmethod
    def get_data(self, frame_id, x_range, y_range):
        pass

    @abstractmethod
    def add_agents(self, x, y, g):
        pass

    @abstractmethod
    def get_map_size(self):
        pass

    @abstractmethod
    def get_banners(self, frame_id, resolution):
        pass

    @abstractmethod
    def get_status(self, frame_id):
        pass

    @abstractmethod
    def keydown(self, frame_id, key, mouse_x, mouse_y):
        pass

    @abstractmethod
    def mousedown(self, frame_id, key, mouse_x, mouse_y):
        pass

    @abstractmethod
    def get_endscreen(self, frame_id):
        pass
