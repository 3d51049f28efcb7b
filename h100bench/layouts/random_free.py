"""``examples/train_pursuit.py``'s ``generate_map`` with a fixed draw:
each group in turn takes ``int(m * m * share)`` bodies, each at a random
top-left cell whose whole rect is free, then ``int(m * m * wall_share)``
interior walls go on free cells; every cell drawn from one
``numpy.random.RandomState(seed)``, x then y, a drawn cell that is not
free drawn again.  The draws are those of the program's
``builtin/config/pursuit.py`` ``layout`` (bodies of w x w at x and y in
[1, m - 1 - w), walls in [1, m - 1)), made here in runs of as many draws as
are still wanted, which the legacy generator answers as it would one by
one."""

import numpy as np

from . import border


def _place(rng, taken, n, w, l, hi):
    """``n`` rects of w x l on free cells of ``taken`` (marked as they go),
    x and y drawn in [1, hi) -> [n, 2] int64 (x, y)."""
    out = []
    while len(out) < n:
        xy = rng.randint(1, hi, size=2 * (n - len(out)))
        for x, y in xy.reshape(-1, 2).tolist():
            if not taken[y:y + l, x:x + w].any():
                taken[y:y + l, x:x + w] = True
                out.append((x, y))
    return np.array(out, np.int64).reshape(-1, 2)


def layout(world):
    m, p = world["map_size"], world["placement"]
    types = world["agent_types"]
    rng = np.random.RandomState(p["seed"])
    taken = np.zeros((m, m), bool)
    placed = []
    for g, share in zip(world["groups"], p["shares"]):
        t = types[g["type"]]
        w, l = int(t.get("width", 1)), int(t.get("length", 1))
        placed.append(_place(rng, taken, int(m * m * share), w, l,
                             m - 1 - max(w, l)))
    walls = _place(rng, taken, int(m * m * p["wall_share"]), 1, 1, m - 1)
    wall = border(m)
    wall[walls[:, 1], walls[:, 0]] = True
    return wall, placed
