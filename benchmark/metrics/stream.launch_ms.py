"""Per-layer metric ``stream.launch_ms`` (ms), moving ``stream_p50_ms``: the host's time to
launch one online LM trip (the trip graph's replay, the program's span
``online.trip``), the mean over the traced frames' trips."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    return None if t is None else spans.mean_ms(spans.find(t, spans.ON_TRIP))
