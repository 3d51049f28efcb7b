"""The hand-written kernels' share of their roofline, in %: the least time
of the entry points' calls in the profiled stretch (``rooflines/``) over
the device time of the port's kernels there."""


def read(ctx):
    if ctx.trace is None or ctx.least_s is None:
        return None
    measured = ctx.trace.port_kernel_s()
    return 100.0 * ctx.least_s / measured if measured else None
