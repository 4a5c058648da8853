"""K2's share of its roofline in the traced frames: one shaded lane a
segment (~300 operations, 114 bytes) over K2's device time
(``shade_kernel``)."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "frame_ms"


def read(ctx):
    sec, _ = ctx.trace.kernel_s("shade_kernel")
    segs = ctx.window["segments"]
    return Y.roofline_pct(segs * Y.K2_OPS_LANE, segs * Y.K2_BYTES_LANE, sec)
