"""The env step's share of the chip's peak, in %: the least bytes a step
moves (``EnvLoop.step_bytes``: the observation it returns, and each
agent's action, reward and liveness) over the HBM's peak rate, times the
window's steps, over the window's seconds.  An env step does no
floating-point work to speak of, so the memory peak is the one that
bounds it; the whole step's time counts, whatever implements it."""

from ..peaks import HBM_BYTES_PER_S


def read(ctx):
    w = ctx.window
    if not ctx.step_bytes or not w.get("env_steps"):
        return None
    return 100.0 * ctx.step_bytes / HBM_BYTES_PER_S * w["env_steps"] / w["seconds"]
