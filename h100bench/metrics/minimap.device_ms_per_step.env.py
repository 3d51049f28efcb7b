"""Device ms per env step of the operations launched inside the program's
``observe.minimap`` span (the pooled minimap channels), in the profiled
stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("observe.minimap"))
