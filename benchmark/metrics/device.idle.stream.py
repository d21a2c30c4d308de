"""Per-layer metric ``device.idle.stream`` (%), moving ``stream_p50_ms``: the share of the traced
frames' span (the feed's own pace) in which no operation ran on the
device."""

from __future__ import annotations

from benchmark import trace as tr


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.device or ctx.get("traced_trips") is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(t) / t.window_s)
