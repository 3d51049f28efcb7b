"""Device ms per env step of the operations launched inside the program's
``observe.features`` span (each group's feature vector), in the profiled
stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("observe.features"))
