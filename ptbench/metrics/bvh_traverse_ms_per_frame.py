"""The BVH traversal's device milliseconds a frame (the flat and the wide
traversal kernels). A time and not a roofline: its work is the visits a
ray, which the renderer does not count on the card yet."""

UNIT = "ms"
MOVES = "frame_ms"


def read(ctx):
    sec, n = ctx.trace.kernel_s("bvh_traverse_kernel",
                                "bvh_wide_traverse_kernel")
    return 1e3 * sec / ctx.units if n else None
