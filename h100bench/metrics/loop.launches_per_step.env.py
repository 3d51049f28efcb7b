"""Device operations (kernels, copies, sets) per env step in the profiled
stretch."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    return len(ctx.trace.device) / ctx.steps
