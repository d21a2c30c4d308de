"""Per-layer metric ``stream.trips_per_frame`` (count), moving ``stream_p50_ms``: the online LM's trips a
frame (the pump's ``iters``), the mean over the window's frames."""

from __future__ import annotations


def read(ctx):
    trips = ctx.get("trips")
    if trips is None or len(trips) == 0:
        return None
    return float(sum(trips)) / len(trips)
