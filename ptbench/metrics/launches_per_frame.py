"""Device operations (kernels, copies, fills) a frame in the traced window."""

UNIT = "count"
MOVES = "frame_ms"


def read(ctx):
    return ctx.trace.launches / ctx.units if ctx.trace.launches else None
