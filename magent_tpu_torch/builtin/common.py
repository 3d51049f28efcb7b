"""Circular replay storage of the per-agent DQN (port of
``magent_tpu/builtin/common.py``).

Host NumPy, as in the JAX package: the model draws its minibatch rows with
``np.random.choice`` and reads them here, so that the same NumPy seed picks
the same rows in both packages; only the gathered minibatch goes to the
device.  The reference's wrap-around head bug stays fixed: after a split
write the head sits at the end of the wrapped tail."""

import numpy as np


class ReplayBuffer:
    def __init__(self, shape, dtype=np.float32):
        self.buffer = np.empty(shape=shape, dtype=dtype)
        self.head = 0
        self.capacity = int(shape[0])

    def put(self, data):
        """Append a batch, wrapping around the ring; returns len(data)."""
        n = len(data)
        first = min(n, self.capacity - self.head)
        self.buffer[self.head : self.head + first] = data[:first]
        if first < n:  # wrap the remainder to the front
            self.buffer[: n - first] = data[first:]
        self.head = (self.head + n) % self.capacity
        return n

    def get(self, index):
        """Read rows by any numpy-style index."""
        return self.buffer[index]

    def clear(self):
        self.head = 0
