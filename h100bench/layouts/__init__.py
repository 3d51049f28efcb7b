"""One file per placement kind (a configuration's ``world.placement.kind``):
``layout(world)`` -> (the full wall map [H, W] bool, border included;
per group, the start cells [n, 2] int64 (x, y) top-left, in slot order),
made with NumPy from the ``world`` object alone, so the program and the
reference get the same.  :func:`h100bench.world.layout` finds the file by
the kind's name."""

import numpy as np


def border(m):
    """An m x m wall map [y, x] with its border cells set."""
    wall = np.zeros((m, m), bool)
    wall[0, :] = wall[-1, :] = wall[:, 0] = wall[:, -1] = True
    return wall
