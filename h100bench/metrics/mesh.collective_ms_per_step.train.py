"""Device ms per train step of the operations launched inside the
program's ``mesh.all_reduce`` span (the learn step's gradient exchange
over the ``dp`` ranks: the collective's kernels, which wait for the
slowest rank, and their copies), on rank 0, in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("mesh.all_reduce"))
