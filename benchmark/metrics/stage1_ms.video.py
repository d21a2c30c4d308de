"""Per-layer metric ``stage1_ms.video`` (ms), moving ``video_fps``: stage 1 of the fused fit
(``solve.two_stage``'s ``run.timings['stage1_s']``, ended by a device
synchronize), the mean over the window's videos."""

from __future__ import annotations


def read(ctx):
    videos = ctx.get("videos")
    if not videos:
        return None
    return 1e3 * sum(v["stage1_s"] for v in videos) / len(videos)
