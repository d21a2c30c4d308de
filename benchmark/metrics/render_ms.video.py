"""Per-layer metric ``render_ms.video`` (ms), moving ``video_fps``: ``pipeline.common.render_frames``
over every frame of a video, the benchmark's span around the call ended
by a device synchronize; the mean over the window's videos."""

from __future__ import annotations


def read(ctx):
    videos = ctx.get("videos")
    if not videos:
        return None
    return 1e3 * sum(v["render_s"] for v in videos) / len(videos)
