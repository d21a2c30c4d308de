"""Per-layer metric ``k3_roofline`` (%), moving ``video_fps``: K3's share of its roofline over
the traced video's render: the frozen count (``counts.k3_work``:
12 operations a pixel of every kept face's clipped box, counted on these
frames from the reference's vertices, 150 a face of setup; vertices and
faces read once a launch, gray and covered written once) over the device
time of K3's four kernels in the profile."""

from __future__ import annotations

from benchmark import counts
from benchmark import trace as tr

PATTERNS = [r"\(anonymous namespace\)::(setup|scan|fill|tile)_kernel[<(]"]
LAUNCH = [r"\(anonymous namespace\)::tile_kernel[<(]"]


def read(ctx):
    t, v = ctx.get("trace"), ctx.get("traced_video")
    if t is None or v is None or "traced_box_px" not in ctx:
        return None
    secs, _ = tr.kernel_time(t, PATTERNS)
    _, n = tr.kernel_time(t, LAUNCH)
    if n == 0 or secs <= 0:
        return None
    sz, rc = ctx["model_sizes"], ctx["cfg"]["render"]
    work = counts.k3_work(v["frames"], n, sz["n_verts"], sz["n_faces"],
                          ctx["traced_box_px"], rc["height"], rc["width"])
    return 100.0 * counts.bound_s(work) / secs
