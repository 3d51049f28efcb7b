"""The 95th percentile of the ms between consecutive end-of-step CUDA
events, over the window's steps outside the profiled stretch."""

import statistics


def read(ctx):
    gaps = ctx.step_gaps_ms
    if not gaps or len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20)[-1]
