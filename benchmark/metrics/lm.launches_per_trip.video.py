"""Per-layer metric ``lm.launches_per_trip.video`` (count), moving ``video_fps``: the device's operations
(kernels, copies, fills) in the profile of one whole video, render
included, over that video's LM trips."""

from __future__ import annotations


def read(ctx):
    tr, v = ctx.get("trace"), ctx.get("traced_video")
    if tr is None or v is None or not tr.device:
        return None
    return len(tr.device) / (v["trips1"] + v["trips2"])
