"""Device operations (kernels, copies, fills) a train step in the traced
window: the forward, autograd's backward and Adam."""

UNIT = "count"
MOVES = "step_ms"


def read(ctx):
    return ctx.trace.launches / ctx.units if ctx.trace.launches else None
