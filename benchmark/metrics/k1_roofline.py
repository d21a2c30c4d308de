"""Per-layer metric ``k1_roofline`` (%), moving ``video_fps``: K1's share of its roofline over
the traced video: the least time of its launches by the frozen count
(``counts.k1_launch`` at stage 1's (1 x anchors) and stage 2's (windows
x 20) shapes, one launch a trip) over K1's device time in the profile."""

from __future__ import annotations

from benchmark import counts
from benchmark import trace as tr

PATTERNS = [r"arrow_pcg_kernel"]


def read(ctx):
    t, v = ctx.get("trace"), ctx.get("traced_video")
    if t is None or v is None:
        return None
    secs, n = tr.kernel_time(t, PATTERNS)
    if n == 0 or secs <= 0:
        return None
    from benchmark.runners.video import cg_steps
    cfg = ctx["cfg"]
    frames = v["frames"]
    n_a = len(range(0, frames, cfg["fit"]["anchor_every"]))
    cg = cg_steps(cfg, frames)
    least = (v["trips1"] * counts.bound_s(counts.k1_launch(1, n_a, 76, 10, cg))
             + v["trips2"] * counts.bound_s(counts.k1_launch(
                 v["windows"], cfg["fit"]["window"], 76, 10, cg)))
    # a launch the profiler lost counts neither its time nor its work
    least *= n / (v["trips1"] + v["trips2"])
    return 100.0 * least / secs
