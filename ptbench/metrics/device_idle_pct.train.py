"""The share of the traced window in which no operation ran on the card:
1 - (union of device intervals) / window."""

UNIT = "%"
MOVES = "step_ms"


def read(ctx):
    tr = ctx.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.busy_s > 0 else None
