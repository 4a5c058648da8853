"""The whole train step's share of the card's fp32 peak: the forward's
closest hits and shading at every lane and bounce, and K6's backward, by
the frozen counts, over the peak times the traced window."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "step_ms"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    w = ctx.work
    lanes = Y.train_lanes(ctx)
    ops = (lanes * (Y.sphere_ops(w) + Y.K2_OPS_LANE)
           + ctx.units * w["max_depth"] * w["lanes"] * Y.K6_OPS_RAY)
    return 100.0 * ops / (Y.FP32_FLOP_PER_S * ctx.trace.window_s)
