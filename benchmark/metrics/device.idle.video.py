"""Per-layer metric ``device.idle.video`` (%), moving ``video_fps``: the share of the traced
video's span in which no operation ran on the device (1 - the union of
the device's intervals over the span)."""

from __future__ import annotations

from benchmark import trace as tr


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.device or ctx.get("traced_video") is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(t) / t.window_s)
