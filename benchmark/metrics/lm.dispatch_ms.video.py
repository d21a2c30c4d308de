"""Per-layer metric ``lm.dispatch_ms.video`` (ms), moving ``video_fps``: the host's time to
enqueue one LM trip (the program's span ``multi_frame.trip``: assembly
where not fused, the step, the cost history's write), the mean over the
traced video's trips of both stages."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    return None if t is None else spans.mean_ms(spans.find(t, spans.LM_TRIP))
