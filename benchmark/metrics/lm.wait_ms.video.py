"""Per-layer metric ``lm.wait_ms.video`` (ms), moving ``video_fps``: the host's time blocked
on the device at the LM loop's read of ``converged`` (the program's span
``multi_frame.wait``), over the traced video, a trip (the
``multi_frame.trip`` spans)."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    trips = [] if t is None else spans.find(t, spans.LM_TRIP)
    if not trips:
        return None
    return 1e-6 * spans.total_ns(spans.find(t, spans.LM_WAIT)) / len(trips)
