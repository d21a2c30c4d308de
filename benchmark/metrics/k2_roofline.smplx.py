"""Per-layer metric ``k2_roofline.smplx`` (%), moving ``video_fps``: K2's share of its
roofline over the traced whole-body video's render: the frozen count
(``counts.k2_work`` at 10 475 vertices, 55 joints and 20 directions:
every frame's skinning work, the model operands read once a launch) over
K2's device time in the profile."""

from __future__ import annotations

from benchmark import counts
from benchmark import trace as tr

PATTERNS = [r"lbs_kernel"]
N_JOINTS = 55


def read(ctx):
    t, v = ctx.get("trace"), ctx.get("traced_video")
    if t is None or v is None:
        return None
    secs, n = tr.kernel_time(t, PATTERNS)
    if n == 0 or secs <= 0:
        return None
    sz = ctx["model_sizes"]
    work = counts.k2_work(v["frames"], n, sz["n_verts"], N_JOINTS,
                          sz["n_betas"] + sz["n_expression"])
    return 100.0 * counts.bound_s(work) / secs
