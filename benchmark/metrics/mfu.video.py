"""Per-layer metric ``mfu.video`` (%), moving ``video_fps``: the whole video's share of
the card's FP32 peak: the frozen analytic operations of both stages' LM
trips as run, the skinning and the raster of every video of the window
(``runners/video.py::video_work``), over the window's wall time, over 67
TFLOP/s."""

from __future__ import annotations

from benchmark import counts


def read(ctx):
    videos, box = ctx.get("videos"), ctx.get("box_px")
    if not videos or box is None:
        return None
    from benchmark.runners.video import video_work
    flops = sum(video_work(v, b, ctx["cfg"]).flops for v, b in zip(videos, box))
    return 100.0 * flops / ctx["window_s"] / counts.PEAK_F32_FLOPS
