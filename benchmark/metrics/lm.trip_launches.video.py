"""Per-layer metric ``lm.trip_launches.video`` (count), moving ``video_fps``: the runtime's
launch calls (kernels, graphs, copies, fills; ``spans.LAUNCH``) that the
host makes inside one LM trip's span ``multi_frame.trip``, the mean over
the traced video's trips."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    trips = [] if t is None else spans.find(t, spans.LM_TRIP)
    if not trips:
        return None
    return spans.launches_in(t, trips) / len(trips)
