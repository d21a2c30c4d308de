"""Per-layer metric ``lm.trips.video`` (count), moving ``video_fps``: the LM loop's trips a video,
stage 1's plus stage 2's (a batch runs until its slowest window stops;
``iters_run``), the mean over the window's videos."""

from __future__ import annotations


def read(ctx):
    videos = ctx.get("videos")
    if not videos:
        return None
    return sum(v["trips1"] + v["trips2"] for v in videos) / len(videos)
