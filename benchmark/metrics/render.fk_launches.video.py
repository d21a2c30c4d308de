"""Per-layer metric ``render.fk_launches.video`` (count), moving ``video_fps``: the runtime's
launch calls (``spans.LAUNCH``) inside the render's eager FK of one
100-frame chunk (``params_to_pose`` and ``joint_affines``, the program's
span ``render.fk``), the mean over the traced video's chunks."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    fk = [] if t is None else spans.find(t, spans.FK)
    if not fk:
        return None
    return spans.launches_in(t, fk) / len(fk)
