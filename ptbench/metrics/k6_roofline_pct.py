"""K6's share of its roofline in the traced train steps: 60 bytes a ray
at each of the ``max_depth`` bounces whose distance feeds the image, over
the device time of the backward and its fixed-order sums
(``sphere_nearest_bwd_kernel``, ``sum_partials_kernel``)."""

from ptbench import yardsticks as Y

UNIT = "%"
MOVES = "step_ms"


def read(ctx):
    sec, _ = ctx.trace.kernel_s("sphere_nearest_bwd_kernel",
                                "sum_partials_kernel")
    w = ctx.work
    rays = ctx.units * w["max_depth"] * w["lanes"]
    return Y.roofline_pct(rays * Y.K6_OPS_RAY, rays * Y.K6_BYTES_RAY, sec)
