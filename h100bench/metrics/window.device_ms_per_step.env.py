"""Device ms per env step of the operations launched inside the program's
``observe.window`` span (each group's window positions, the window gather
and its epilogue: liveness, minimap channels, the views' dtype), in the
profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("observe.window"))
