"""The whole frame's share of the card's fp32 peak: the operations the
traced frames need by the frozen counts (each segment against the live
spheres, boxes and media, and its shading) over the peak times the
traced window."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "frame_ms"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    w, segs = ctx.work, ctx.window["segments"]
    ops = segs * (Y.sphere_ops(w) + Y.box_media_ops(w) + Y.K2_OPS_LANE)
    return 100.0 * ops / (Y.FP32_FLOP_PER_S * ctx.trace.window_s)
