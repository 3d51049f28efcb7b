"""Synthetic random-walk server for renderer stress testing
(port of ``magent_tpu/renderer/server/random_server.py``; reference:
python/magent/renderer/server/random_server.py)."""

import random

from .base_server import BaseServer


class RandomServer(BaseServer):
    def __init__(self, agent_number=1000, group_number=20, map_size=100,
                 shape_range=3, speed=5, event_range=100):
        self._map_size = map_size
        self._number = agent_number
        self._data = {
            i: [random.randint(0, map_size - 1),
                random.randint(0, map_size - 1),
                random.randint(0, group_number - 1)]
            for i in range(agent_number)
        }
        self._group = [
            [random.randint(1, shape_range), random.randint(1, shape_range),
             random.randint(0, 255), random.randint(0, 255),
             random.randint(0, 255)]
            for _ in range(group_number)
        ]
        self._speed = speed
        self._event_range = event_range

    def get_info(self):
        return (self._map_size, self._map_size), self._group, {"wall": []}

    def get_data(self, frame_id, x_range, y_range):
        result = {}
        for i, old in self._data.items():
            x = min(max(old[0] + random.randint(-self._speed, self._speed), 0),
                    self._map_size - 1)
            y = min(max(old[1] + random.randint(-self._speed, self._speed), 0),
                    self._map_size - 1)
            new = [x, y, old[2]]
            self._data[i] = new
            if (x_range[0] <= x <= x_range[1] and y_range[0] <= y <= y_range[1]) \
                    or (x_range[0] <= old[0] <= x_range[1]
                        and y_range[0] <= old[1] <= y_range[1]):
                result[i] = new
        events = [
            (random.choice(list(self._data)),
             random.randint(0, self._map_size - 1),
             random.randint(0, self._map_size - 1))
            for _ in range(random.randint(0, self._event_range))
        ]
        return result, events

    def add_agents(self, x, y, g):
        self._data[self._number] = [x, y, g]
        self._number += 1

    def get_map_size(self):
        return self._map_size, self._map_size

    def get_banners(self, frame_id, resolution):
        return [(("random server, frame %d" % frame_id, (0, 0, 0)),)]

    def get_status(self, frame_id):
        return True

    def keydown(self, frame_id, key, mouse_x, mouse_y):
        return False

    def mousedown(self, frame_id, key, mouse_x, mouse_y):
        return False

    def get_endscreen(self, frame_id):
        return []
