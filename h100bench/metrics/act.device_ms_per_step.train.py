"""Device ms per train step of the operations launched inside the
program's ``net.act`` span (the rollout's acting forward, its elementwise
kernels included), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("net.act"))
