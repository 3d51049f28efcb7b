"""Device timing of a call on the card."""

from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` in ms, without the host's launch work
    (which bounds back-to-back calls of a kernel shorter than it): a spin
    kernel (``torch.cuda._sleep``) is queued ahead of the start event and
    outlasts the host's enqueueing of ``reps`` calls, so CUDA events time
    the calls as the device runs them back to back, each after the device's
    own launch gap.  The spin doubles until it outlasts the enqueueing.
    Median of 3 batches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    per_call = []
    while len(per_call) < 3:
        spun, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spun.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if spun.elapsed_time(start) <= enqueue_ms:
            if cycles >= 1 << 30:
                raise AssertionError("the host took %.3f ms to enqueue %d "
                                     "calls" % (enqueue_ms, reps))
            cycles *= 2
            continue
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def elapsed_ms(fn, calls: int, device) -> float:
    """Total ms of ``calls`` back-to-back calls of ``fn``, the profilers'
    clock: CUDA events recorded around them on the card (read once, after
    the last call), the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
