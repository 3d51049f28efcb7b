"""Device ms per train step of the operations launched inside the
program's ``train.rollout`` span (the e-greedy rollout: observe, acting
net, draws, env steps), in the profiled stretch."""

from ..program_spans import device_ms_per_step, named


def read(ctx):
    return device_ms_per_step(ctx, named("train.rollout"))
