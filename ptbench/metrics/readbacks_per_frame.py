"""Alive-count readbacks (host waits on the card) a frame, from the
progressive driver's own per-frame count (``ProgressiveResult.readbacks``)."""

UNIT = "count"
MOVES = "frame_ms"


def read(ctx):
    rb = ctx.window.get("readbacks")
    return sum(rb) / len(rb) if rb else None
