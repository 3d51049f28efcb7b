"""Device ms per env step of the operations launched inside the
benchmark's ``engine`` range, in the profiled stretch."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    s = ctx.trace.device_s_by_range().get("engine", 0.0)
    return 1e3 * s / ctx.steps if s else None
