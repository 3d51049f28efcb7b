"""Threefry-2x32 counter-based random numbers in torch, bit-equal to
``jax.random``'s default key under ``jax_threefry_partitionable=True``.

The engine's attack shuffle splits ``state.key`` every step, the random reset
draws placement scores from a key, and the auto-reset folds the env's key —
reproducing JAX's bits lets a whole trajectory of the port be held against
the JAX package.

Keys are int64 tensors of shape ``[..., 2]`` holding uint32 words (torch's
uint32 lacks most ops).  A batch of keys ``[B, 2]`` draws one independent
stream per row, as ``jax.vmap`` over single keys would.  On a CUDA key each
public draw is one launch of ``csrc/threefry.cu`` (:mod:`.ops.threefry`),
the draw's tail fused in; ``normal`` and ``gumbel`` apply their float tails
to its ``uniform``, and ``categorical`` its argmax.  On a CPU key the draws
run the plain version below, every uint32 operation done in int64 masked
with ``& 0xFFFFFFFF``; the two give the same values, bit for bit.

Semantics (jax/_src/prng.py, partitionable mode):

- ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xFFFFFFFF]``;
- ``split(key, n)[i]`` = ``threefry(key, (0, i))`` (both output words);
- ``fold_in(key, d)`` = ``threefry(key, (0, d))``;
- ``bits(key, shape)`` at flat index n = ``w0 ^ w1`` of
  ``threefry(key, (n >> 32, n & 0xFFFFFFFF))``;
- ``uniform`` puts the top 23 bits of ``bits`` in a float's mantissa in
  [1, 2) and subtracts 1; ``normal``, ``gumbel`` and ``categorical``
  build on it (``sqrt(2) * erf_inv(u)``, ``-log(-log(u))``, the
  Gumbel-max draw);
- ``randint`` (int32) draws ``hi`` and ``lo`` words from the two halves of
  ``split(key)`` and returns ``minval + ((hi % span) * m + lo % span) %
  span`` with ``m = (2**16 % span)**2 % span``, every product and sum
  (the square in ``m`` too) wrapping mod 2**32 (jax/_src/random.py
  ``_randint``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import spans
from .ops import _build
from .ops import threefry as _kernel

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words;
    key words and counters broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError("seed must lie in [0, 2**32), got %d" % seed)
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _on_card(key: torch.Tensor) -> bool:
    """Validate ``key``; True for a CUDA key (the kernel), False for a CPU
    key (the plain version)."""
    if key.dtype != torch.int64 or key.shape[-1] != 2:
        raise ValueError("a key is an int64 tensor of shape [..., 2], got %s %s"
                         % (key.dtype, tuple(key.shape)))
    return _build.route(key) == "cuda"


def _words(key: torch.Tensor):
    return key[..., 0], key[..., 1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``."""
    with spans.span("rng.split"):
        if _on_card(key):
            return _kernel.split(key, int(num))
        k1, k2 = _words(key)
        i = torch.arange(num, dtype=torch.int64, device=key.device)
        b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                              torch.zeros_like(i), i)
        return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a Python int ``data`` (uint32)."""
    with spans.span("rng.fold_in"):
        if _on_card(key):
            return _kernel.fold_in(key, int(data) & MASK32)
        k1, k2 = _words(key)
        d = torch.full_like(k1, int(data) & MASK32)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
        return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (uint32 words in int64): ``[..., 2]`` ->
    ``[..., *shape]``."""
    shape = tuple(int(s) for s in shape)
    with spans.span("rng.bits"):
        if _on_card(key):
            return _kernel.bits(key, shape)
        k1, k2 = _words(key)
        n = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=key.device)
        lead = k1.dim()
        k1 = k1.reshape(k1.shape + (1,))
        k2 = k2.reshape(k2.shape + (1,))
        b1, b2 = threefry2x32(k1, k2, n >> 32, n & MASK32)
        return (b1 ^ b2).reshape(key.shape[:lead] + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, maxval), float32: ``[..., 2]`` ->
    ``[..., *shape]``.  Outside the default range JAX scales as
    ``max(minval, floats * (maxval - minval) + minval)`` in float32, and so
    does this, with XLA's fused multiply-add: the float32 product is exact
    in float64, so the sum rounds there and once more to float32."""
    default = minval == 0.0 and maxval == 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    with spans.span("rng.uniform"):
        if _on_card(key):
            return _kernel.uniform(key, tuple(int(s) for s in shape),
                                   float(lo), float(hi - lo), not default)
        b = bits(key, shape)
        f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        if default:
            return f
        scaled = f.double() * float(hi - lo) + float(lo)
        return scaled.float().clamp_min(float(lo))


# XLA's f32 erf_inv (M. Giles' single-precision approximation): the
# polynomial's coefficients in w = -log1p(-x * x), for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x):
    """XLA's float32 ``erf_inv`` on ``x`` in (-1, 1), the same polynomial
    in the same order; its ``log1p`` is PyTorch's, and XLA may fuse a
    multiply-add, so the two differ by an ulp or two here and there."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for lo_c, hi_c in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, lo_c, hi_c).to(x.dtype)
        p = c if p is None else c + p * w
    return p * x


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal``, float32: ``sqrt(2) * erf_inv(u)`` of ``u =
    uniform(key, shape, nextafter(-1, 0), 1)``; ``u`` bit for bit,
    ``erf_inv`` as :func:`_erf_inv`."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    with spans.span("rng.normal"):
        return _erf_inv(uniform(key, shape, lo, 1.0)) * float(
            np.float32(np.sqrt(2)))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (``mode="low"``), float32:
    ``-log(-log(uniform(key, shape, tiny, 1)))``.  The bits are JAX's; the
    two ``log``s are PyTorch's, which differ from XLA's by an ulp here and
    there."""
    tiny = float(torch.finfo(torch.float32).tiny)
    with spans.span("rng.gumbel"):
        return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for one key, as
    jax computes it: ``argmax(gumbel(key, logits.shape) + logits, -1)``
    (the first maximum on ties) -> int32 ``logits.shape[:-1]``."""
    with spans.span("rng.categorical"):
        noise = gumbel(key, logits.shape)
        return (noise + logits).argmax(-1).to(torch.int32)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with the default
    int32 dtype, bit for bit: ``[..., 2]`` -> int32 ``[..., *shape]`` in
    ``[minval, maxval)`` (``minval`` alone when ``maxval <= minval``).  The
    uint32 arithmetic wraps: each product and sum is masked to 32 bits, as
    exact int64 arithmetic would give other numbers."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -2**31 <= v < 2**31:
            raise ValueError("randint bounds must fit int32, got %d" % v)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    # wraps too: for spans above 2**16 the square is 2**32, which is 0
    multiplier = ((2**16 % span) ** 2 & MASK32) % span
    with spans.span("rng.randint"):
        if _on_card(key):
            return _kernel.randint(key, tuple(int(s) for s in shape), minval,
                                   span, multiplier)
        keys = split(key)
        hi = bits(keys[..., 0, :], shape)
        lo = bits(keys[..., 1, :], shape)
        offset = ((hi % span) * multiplier) & MASK32
        offset = ((offset + lo % span) & MASK32) % span
        return (offset + minval).to(torch.int32)


def mul32(a, c: int):
    """``(a * c) mod 2**32`` for int64 tensors of uint32 words and a uint32
    constant, split in 16-bit halves so no intermediate leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def splitmix_finalize(z):
    """The engine's SplitMix-style 32-bit finalizer (engine.py:1035-1037,
    vec_env.py:306-308) on int64 tensors of uint32 words."""
    z = mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)
