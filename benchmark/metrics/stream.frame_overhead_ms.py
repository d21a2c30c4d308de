"""Per-layer metric ``stream.frame_overhead_ms`` (ms), moving ``stream_p50_ms``: a frame's
fixed host cost in the pump: of each ``online.submit`` span, the time
its ``online.trip`` and ``online.wait`` spans leave uncovered (the copy
in, the init graph, the copy out, the advance), the mean over the
traced frames."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    frames = [] if t is None else spans.find(t, spans.SUBMIT)
    if not frames:
        return None
    inner = spans.find(t, spans.ON_TRIP) + spans.find(t, spans.ON_WAIT)
    return 1e-6 * sum(f.end_ns - f.start_ns - spans.covered_ns(f, inner)
                      for f in frames) / len(frames)
