"""Device ms per env step of the operations launched inside the program's
``observe.grids`` or ``observe.render`` spans (the packed grid and each
group's channel image), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("observe.grids", "observe.render"))
