"""Per-layer metric ``mfu.smplx`` (%), moving ``video_fps``: the whole-body video's share
of the card's FP32 peak: the frozen analytic operations of both stages'
LM trips as run at P = 94 and 94 keypoint rows, the skinning at SMPL-X's
widths and the raster of every video of the window
(``runners/video_smplx.py::video_work``), over the window's wall time,
over 67 TFLOP/s."""

from __future__ import annotations

from benchmark import counts


def read(ctx):
    videos, box = ctx.get("videos"), ctx.get("box_px")
    if not videos or box is None:
        return None
    from benchmark.runners.video_smplx import video_work
    flops = sum(video_work(v, b, ctx["cfg"]).flops for v, b in zip(videos, box))
    return 100.0 * flops / ctx["window_s"] / counts.PEAK_F32_FLOPS
