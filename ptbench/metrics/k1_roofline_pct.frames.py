"""K1's share of its roofline in the traced frames: the least time for
the frames' segments against the live spheres (16 operations a pair, 32
bytes a segment) over K1's device time (``sphere_nearest_kernel<false``)."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "frame_ms"


def read(ctx):
    sec, _ = ctx.trace.kernel_s("sphere_nearest_kernel<false")
    segs = ctx.window["segments"]
    return Y.roofline_pct(segs * ctx.work["spheres"] * Y.K1_OPS_PAIR,
                          segs * Y.K1_BYTES_RAY, sec)
