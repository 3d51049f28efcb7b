"""The train step's model FLOPs (:mod:`h100bench.flops`) over the
window's seconds times the chips' dense bf16 peak, in %."""

from ..peaks import BF16_FLOPS


def read(ctx):
    w = ctx.window
    if not w.get("train_steps"):
        return None
    flops = ctx.flops_per_train_step * w["train_steps"]
    return 100.0 * flops / (w["seconds"] * BF16_FLOPS * ctx.chips)
