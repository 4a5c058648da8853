"""The box and media sweep's share of its roofline in the traced frames:
each segment against every live box (84 operations) and medium (114) over
the kernel's device time (``box_media_nearest_kernel``)."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "frame_ms"


def read(ctx):
    sec, _ = ctx.trace.kernel_s("box_media_nearest_kernel")
    segs = ctx.window["segments"]
    return Y.roofline_pct(segs * Y.box_media_ops(ctx.work),
                          segs * Y.box_media_bytes(ctx.work), sec)
