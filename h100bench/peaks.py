"""The NVIDIA H100 SXM's published peaks, and the least time of some work.

HBM3 at 3.35 TB/s and 989 TFLOP/s of dense bf16 (NVIDIA's data sheet, at
the full 700 W); per SM and clock 128 float32 and 64 int32 instructions
(CUDA C++ Programming Guide, compute capability 9.0), over 132 SMs at the
1980 MHz maximum SM clock."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SMS, SM_CLOCK_HZ = 132, 1.98e9
F32_PER_S = SMS * 128 * SM_CLOCK_HZ
INT32_PER_S = SMS * 64 * SM_CLOCK_HZ


def least_seconds(work):
    """The larger of the bytes over the HBM's rate and each pipe's
    instructions over its rate."""
    return max(work.get("bytes", 0) / HBM_BYTES_PER_S,
               work.get("int32", 0) / INT32_PER_S,
               work.get("f32", 0) / F32_PER_S)


def nbytes(*tensors):
    """Bytes of the tensors among ``tensors`` (nested tuples flattened)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total
