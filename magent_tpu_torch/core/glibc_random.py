"""Bit-exact replica of glibc's ``random()`` (TYPE_3 additive generator); a
copy of ``magent_tpu/core/glibc_random.py``.

The reference DiscreteSnake engine draws placement cells, directions, and
food positions from libc ``random()``/``srandom`` (reference:
src/discrete_snake/DiscreteSnake.cc:84,111,288; Map.cc:73-84), so snake
golden-trajectory parity needs this stream (the gridworld engine instead
uses a minstd LCG, replicated in core/lcg.py).

Algorithm (glibc stdlib/random_r.c, TYPE_3: degree 31, separation 3):
seed the 31-entry table with a Schrage-factored minstd LCG, duplicate the
first 3 entries, churn 310 outputs, then each call does
``r[f] += r[r]; return (uint32)r[f] >> 1``.
"""

from __future__ import annotations


class GlibcRandom:
    DEG, SEP = 31, 3

    def __init__(self, seed: int = 1):
        self.srandom(seed)

    def srandom(self, seed: int):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * self.DEG  # 31-entry circular table (randtbl)
        r[0] = seed
        word = seed
        for i in range(1, self.DEG):
            # 16807 * word % 2^31-1 without overflow (Schrage)
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        self.r = r
        self.f = self.SEP  # fptr index
        self.b = 0  # rptr index
        n = len(r)
        for _ in range(10 * self.DEG):
            self._step(n)

    def _step(self, n):
        r = self.r
        val = (r[self.f] + r[self.b]) & 0xFFFFFFFF
        r[self.f] = val
        self.f += 1
        if self.f >= n:
            self.f = 0
        self.b += 1
        if self.b >= n:
            self.b = 0
        return val >> 1

    def random(self) -> int:
        return self._step(len(self.r))
