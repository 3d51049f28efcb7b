"""Tiny scripted server for renderer debugging
(port of ``magent_tpu/renderer/server/sample_server.py``; reference:
python/magent/renderer/server/sample_server.py)."""

from .base_server import BaseServer


class SampleServer(BaseServer):
    _FRAMES = {
        0: ({1: [10, 10, 0]}, [(1, 0, 0)]),
        1: ({1: [9, 10, 0]}, [(1, 0, 0)]),
        2: ({1: [8, 10, 0]}, [(1, 0, 0)]),
        3: ({1: [14, 12, 0]}, [(1, 0, 0)]),
    }

    def get_info(self):
        return (50, 50), [[1, 1, 200, 0, 0]], {"wall": []}

    def get_data(self, frame_id, x_range, y_range):
        return self._FRAMES.get(frame_id, ({1: [10, 10, 0]}, [(1, 0, 0)]))

    def add_agents(self, x, y, g):
        pass

    def get_map_size(self):
        return 50, 50

    def get_banners(self, frame_id, resolution):
        return [(("sample server", (0, 0, 0)),)]

    def get_status(self, frame_id):
        return True

    def keydown(self, frame_id, key, mouse_x, mouse_y):
        return False

    def mousedown(self, frame_id, key, mouse_x, mouse_y):
        return False

    def get_endscreen(self, frame_id):
        return []
