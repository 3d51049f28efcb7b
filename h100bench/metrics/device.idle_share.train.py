"""The device's idle share of a step, in %: 1 - the union of device
activity per step in the profiled stretch over the wall time per step of
the window (whose pace the profiler does not slow)."""


def read(ctx):
    w = ctx.window
    if ctx.trace is None or not ctx.steps or not w.get("train_steps"):
        return None
    busy = ctx.trace.busy_s() / ctx.steps
    return 100.0 * (1.0 - busy / (w["seconds"] / w["train_steps"]))
