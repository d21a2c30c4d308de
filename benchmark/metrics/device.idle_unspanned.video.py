"""Per-layer metric ``device.idle_unspanned.video`` (%), moving ``video_fps``: of the traced
video's idle device time (the gaps between the union of the device's
intervals), the share in gaps whose middle lies in no span of the
program: time the trace can charge to no layer of the port."""

from __future__ import annotations

from benchmark import spans


def read(ctx):
    t = ctx.get("trace")
    got = None if t is None else spans.unspanned_idle_ns(t)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * got[1] / got[0]
