"""Threefry-2x32 keys and draws in NumPy ``uint32``, as ``jax.random``
defines them with ``jax_threefry_partitionable`` on.

Threefry-2x32 with 20 rounds is the Random123 generator (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011).  A key is a pair
of words, ``[..., 2]``; a batch of keys draws one stream per key.

- ``key(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``;
- ``split(k, n)[i]`` and ``fold_in(k, i)``: both words of
  ``threefry(k, (0, i))``;
- ``bits(k, shape)`` at flat index ``n``: ``w0 ^ w1`` of
  ``threefry(k, (n >> 32, n & 0xFFFFFFFF))``;
- ``uniform``: the top 23 bits of ``bits`` as the mantissa of a float in
  [1, 2), minus 1;
- ``randint``: ``hi`` and ``lo`` words from the two halves of
  ``split(k)``, ``(hi % span * m + lo % span) % span`` with ``m = (2**16
  % span)**2 % span``, every product and sum mod 2**32.

``fmix32`` is MurmurHash3's 32-bit finaliser."""

from __future__ import annotations

import numpy as np

U32 = np.uint32
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = U32(0x1BD11BDA)


def _rotl(v, r):
    return (v << U32(r)) | (v >> U32(32 - r))


def threefry(k, c0, c1):
    """Threefry-2x32-20 of counter words ``(c0, c1)`` under key words
    ``k[..., 0], k[..., 1]`` (broadcast) -> the two output words."""
    with np.errstate(over="ignore"):
        k0, k1 = k[..., 0].astype(U32), k[..., 1].astype(U32)
        ks = (k0, k1, k0 ^ k1 ^ PARITY)
        x0 = np.asarray(c0, U32) + ks[0]
        x1 = np.asarray(c1, U32) + ks[1]
        for block in range(5):
            for r in ROTATIONS[block % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + U32(block + 1)
    return x0, x1


def key(seed):
    """The key of a whole number ``seed`` below 2**64."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], U32)


def seed_key(seed):
    """The benchmark's key of a seed of any size: its low word, then its
    high bits folded in."""
    k = key(seed & 0xFFFFFFFF)
    return fold_in(k, seed >> 32) if seed >> 32 else k


def split(k, n=2):
    """``[..., 2]`` -> ``[..., n, 2]``."""
    k = np.asarray(k, U32)[..., None, :]
    i = np.arange(n, dtype=U32)
    w0, w1 = threefry(k, np.zeros_like(i), i)
    return np.stack([w0, w1], -1)


def fold_in(k, data):
    k = np.asarray(k, U32)
    w0, w1 = threefry(k, U32(0), U32(int(data) & 0xFFFFFFFF))
    return np.stack([w0, w1], -1)


def bits(k, shape):
    """``[..., 2]`` -> ``uint32 [..., *shape]``."""
    k = np.asarray(k, U32)
    shape = tuple(int(s) for s in shape)
    n = np.arange(int(np.prod(shape)), dtype=np.uint64)
    kk = k.reshape(k.shape[:-1] + (1, 2))
    w0, w1 = threefry(kk, (n >> np.uint64(32)).astype(U32), n.astype(U32))
    return (w0 ^ w1).reshape(k.shape[:-1] + shape)


def uniform(k, shape):
    """float32 in [0, 1)."""
    b = bits(k, shape)
    return ((b >> U32(9)) | U32(0x3F800000)).view(np.float32) - np.float32(1)


def randint(k, shape, lo, hi):
    """int32 in [lo, hi)."""
    span = U32(hi - lo)
    with np.errstate(over="ignore"):
        m = U32((2**16 % int(span)) ** 2 % 2**32 % int(span))
        halves = split(k)
        a, b = bits(halves[..., 0, :], shape), bits(halves[..., 1, :], shape)
        off = (a % span) * m + b % span
    return (off % span).astype(np.int64).astype(np.int32) + np.int32(lo)


def fmix32(z):
    z = np.asarray(z, U32)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> U32(16))) * U32(0x85EBCA6B)
        z = (z ^ (z >> U32(13))) * U32(0xC2B2AE35)
    return z ^ (z >> U32(16))
