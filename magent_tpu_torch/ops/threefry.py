"""Threefry-2x32 on the card: each public draw of
:mod:`magent_tpu_torch.random` on a CUDA key is one launch of
``csrc/threefry.cu``.

The kernel runs the 20 rounds in native uint32 arithmetic, one thread per
counter, and fuses the draw's tail (``split``/``fold_in``'s two words,
``bits``' xor, ``uniform``'s mantissa and scaling, ``randint``'s subkeys and
wrap-around arithmetic), so its outputs equal the plain version's, bit for
bit: :mod:`magent_tpu_torch.random`'s tensor code, which the draws call for
CPU keys.  The functions here take CUDA keys only; the draws validate them
and route.  Outputs keep the plain version's dtypes and shapes: int64
words for ``split``, ``fold_in`` and ``bits``, float32 for ``uniform``,
int32 for ``randint``.  Scalars go to the kernel as arguments: a draw
makes no host sync and copies nothing to the card."""

from __future__ import annotations

import math

import torch

from . import _build

# csrc/threefry.cu Mode
WORDS, BITS, UNIFORM, RANDINT = range(4)
THREADS = 256
# the grid-stride loop's blocks per SM at most: a draw of 819,200 counters
# (64 battles of 2 x 1600) runs 3.1 counters per thread
BLOCKS_PER_SM = 8


def _rows(key: torch.Tensor) -> torch.Tensor:
    """The key as ``[rows, 2]`` words with unit word stride (a view where
    the layout allows one, else a copy)."""
    rows = key.reshape(-1, 2)
    return rows if rows.stride(1) == 1 else rows.contiguous()


def _draw(key, mode, count, shape, dtype, *, base=0, span=1, mult=0,
          minval=0, lo=0.0, scale=1.0, scaled=False) -> torch.Tensor:
    out = torch.empty(tuple(key.shape[:-1]) + shape, dtype=dtype,
                      device=key.device)
    rows = _rows(key)
    total = rows.shape[0] * count
    if total:
        blocks = min(-(-total // THREADS),
                     _build.sm_count(key.device) * BLOCKS_PER_SM)
        _build.launch("magent_threefry", key.device, rows.data_ptr(),
                      rows.stride(0), count, total, mode, base, span, mult,
                      minval, lo, scale, int(scaled), blocks, out.data_ptr())
    return out


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., num, 2]``: counters (0, i)."""
    return _draw(key, WORDS, num, (num, 2), torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., 2]``: counter (0, data), ``data`` a uint32."""
    return _draw(key, WORDS, 1, (2,), torch.int64, base=data)


def bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``[..., 2]`` -> int64 ``[..., *shape]`` uint32 words."""
    return _draw(key, BITS, math.prod(shape), shape, torch.int64)


def uniform(key: torch.Tensor, shape: tuple, lo: float, scale: float,
            scaled: bool) -> torch.Tensor:
    """``[..., 2]`` -> float32 ``[..., *shape]`` in [0, 1), or scaled to
    ``max(lo, u * scale + lo)`` with ``lo``, ``scale`` float32 values."""
    return _draw(key, UNIFORM, math.prod(shape), shape, torch.float32, lo=lo,
                 scale=scale, scaled=scaled)


def randint(key: torch.Tensor, shape: tuple, minval: int, span: int,
            mult: int) -> torch.Tensor:
    """``[..., 2]`` -> int32 ``[..., *shape]``: ``minval + ((hi % span) *
    mult + lo % span) % span`` mod 2**32, ``span`` in [1, 2**32)."""
    return _draw(key, RANDINT, math.prod(shape), shape, torch.int32,
                 span=span, mult=mult, minval=minval)
