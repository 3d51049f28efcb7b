"""The share, in %, of the profiled stretch's device idle time (the gaps
between merged device intervals) whose next operation was launched inside
any of the program's ``rng.*`` spans."""

from ..program_spans import layer, of

RNG = layer("rng")


def read(ctx):
    sp = of(ctx)
    if sp is None or not sp.has(RNG):
        return None
    idle = sp.idle_s()
    return 100.0 * sp.idle_s(RNG) / idle if idle else None
