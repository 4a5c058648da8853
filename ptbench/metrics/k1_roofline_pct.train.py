"""K1's share of its roofline in the traced train steps (the forward's
closest hits): every lane at each bounce against the live spheres."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "step_ms"


def read(ctx):
    sec, _ = ctx.trace.kernel_s("sphere_nearest_kernel<false")
    lanes = Y.train_lanes(ctx)
    return Y.roofline_pct(lanes * ctx.work["spheres"] * Y.K1_OPS_PAIR,
                          lanes * Y.K1_BYTES_RAY, sec)
