"""Per-layer metric ``stream.trip_ms`` (ms), moving ``stream_p50_ms``: the device's busy time a trip
over the traced frames (the trip graph's replays, the init graph and the
copies of each frame), from the profile."""

from __future__ import annotations

from benchmark import trace as tr


def read(ctx):
    t, trips = ctx.get("trace"), ctx.get("traced_trips")
    if t is None or not t.device or trips is None or sum(trips) == 0:
        return None
    return 1e3 * tr.busy_s(t) / float(sum(trips))
