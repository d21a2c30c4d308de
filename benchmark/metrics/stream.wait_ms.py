"""Per-layer metric ``stream.wait_ms`` (ms), moving ``stream_p50_ms``: the host's time
blocked on the device at the pump's read of ``converged`` (the program's
span ``online.wait``), over the traced frames, a trip (the
``online.trip`` spans)."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    trips = [] if t is None else spans.find(t, spans.ON_TRIP)
    if not trips:
        return None
    return 1e-6 * spans.total_ns(spans.find(t, spans.ON_WAIT)) / len(trips)
