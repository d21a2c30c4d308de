"""Per-layer metric ``lm.hand_pca_ms.smplx`` (ms), moving ``video_fps``: the host's time a
trip in the hands' PCA expansion and its Jacobian columns (the program's
span ``energy.hand_pca``, inside the LM trip's ``multi_frame.trip``), over
the traced whole-body video's trips of both stages. None where the
program has no such span."""

from __future__ import annotations

from benchmark import spans

HAND_PCA = "energy.hand_pca"


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    trips = spans.find(t, spans.LM_TRIP)
    pca = spans.find(t, HAND_PCA)
    if not trips or not pca:
        return None
    inside = sum(spans.covered_ns(trip, pca) for trip in trips)
    return 1e-6 * inside / len(trips)
