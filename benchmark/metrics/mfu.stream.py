"""Per-layer metric ``mfu.stream`` (%), moving ``stream_p50_ms``: the feed's share of the
card's FP32 peak: the frozen analytic operations of the online trip
(``runners/stream.py::trip_work``) times the window's trips, over the
window's wall time, over 67 TFLOP/s."""

from __future__ import annotations

from benchmark import counts


def read(ctx):
    trips = ctx.get("trips")
    if trips is None or len(trips) == 0:
        return None
    from benchmark.runners.stream import trip_work
    return (100.0 * trip_work(float(sum(trips))).flops / ctx["window_s"]
            / counts.PEAK_F32_FLOPS)
