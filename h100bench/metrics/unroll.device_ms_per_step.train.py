"""Device ms per train step of the operations launched inside the
program's ``net.unroll`` span (``split_unroll``: a net's re-unroll of the
stored window; the DRQN trainer's target nets), in the profiled
stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("net.unroll"))
