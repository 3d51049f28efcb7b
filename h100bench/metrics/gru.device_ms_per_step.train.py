"""Device ms per train step of the operations launched inside the
program's ``net.gru`` span (the recurrent cell: each acting step's
``GRUCell``, each carry step of ``split_unroll`` and the checkpoint's
recompute of both in the backward), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("net.gru"))
