"""Device ms per train step of the operations launched inside the
program's ``env.transition`` span (the rollout's env steps: engine,
rules, rewards, auto-reset), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("env.transition"))
