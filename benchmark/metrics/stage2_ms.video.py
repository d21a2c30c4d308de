"""Per-layer metric ``stage2_ms.video`` (ms), moving ``video_fps``: stage 2 of the fused fit
(``run.timings['stage2_s']``, from the interpolated starts to the
solved windows, ended by a device synchronize), the mean over the
window's videos."""

from __future__ import annotations


def read(ctx):
    videos = ctx.get("videos")
    if not videos:
        return None
    return 1e3 * sum(v["stage2_s"] for v in videos) / len(videos)
