"""minstd_rand0 LCG replicating the reference engine RNG (a copy of
``magent_tpu/core/lcg.py``; NumPy only).

The reference engine uses ``std::default_random_engine`` (GNU libstdc++ =
``minstd_rand0``: x' = 16807 * x mod 2147483647), seeded 0 at construction
(which the standard maps to 1) and reseedable via the ``seed`` config
(reference: src/gridworld/GridWorld.cc:29,144-145).  It drives random agent
and wall placement on the host (Map.cc:49-63), so a seed places the same
cells in both packages.
"""

from __future__ import annotations

import numpy as np

M = 2147483647  # 2^31 - 1
A = 16807


def seed_state(seed: int) -> np.uint32:
    """Map a user seed to engine state (0 -> 1, like libstdc++)."""
    s = int(seed) % M
    return np.uint32(1 if s == 0 else s)


def next_host(state: np.uint32) -> tuple[np.uint32, int]:
    """Advance once; returns (new_state, drawn_value). The drawn value IS the
    new state, matching ``linear_congruential_engine::operator()``."""
    nxt = (int(state) * A) % M
    return np.uint32(nxt), nxt


class HostLCG:
    """Mutable host-side engine RNG."""

    def __init__(self, seed: int = 0):
        self.state = seed_state(seed)

    def seed(self, seed: int):
        self.state = seed_state(seed)

    def __call__(self) -> int:
        self.state, val = next_host(self.state)
        return val
