"""``examples/train_battle.py``'s ``generate_map``: each group a square of
agents two cells apart, ``density`` of the cells per group, the two
squares ``gap`` cells either side of the middle column, border walls
only."""

import math

import numpy as np

from . import border


def layout(world):
    m, p = world["map_size"], world["placement"]
    side = int(math.sqrt(int(m * m * p["density"]))) * 2
    y0 = (m - side) // 2

    def square(x0):
        return np.array([(x, y) for x in range(x0, x0 + side, 2)
                         for y in range(y0, y0 + side, 2)], np.int64)

    return border(m), [square(m // 2 - p["gap"] - side), square(m // 2 + p["gap"])]
