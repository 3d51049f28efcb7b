"""Device ms per train step of the operations launched inside the
program's ``train.learn`` span (minibatch draw, TD loss, backward, clipped
Adam), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("train.learn"))
