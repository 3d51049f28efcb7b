"""Device ms per train step of the operations launched inside the
program's ``env.observe`` span (the rollout's observations: grid pass,
renders, minimaps, windows, features), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("env.observe"))
