"""Device operations per train step launched inside any of the program's
``rng.*`` spans (threefry's draws), in the profiled stretch."""

from ..program_spans import layer, of

RNG = layer("rng")


def read(ctx):
    sp = of(ctx)
    if sp is None or not sp.has(RNG):
        return None
    return sp.launches(RNG) / ctx.steps
