"""Fused two-stage pipeline (port of ``smpltpu/solve/two_stage.py``):
stage-1 shared-shape anchor solve -> interpolation of the anchor optima
into window starts, on the device -> the batched stage-2 window solve.

Same semantics as the reference (and as its sequential recipe): the
interpolation runs between consecutive anchors and holds the last anchor
past its end, and window frames beyond the video end get the blind init
(masked by frame_valid). A whole-body layout's hand coefficients are
interpolated linearly, as every other dim of the frame vector.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from smpltpu_torch.energy.params import hand_comps, init_frame_params
from smpltpu_torch.solve.multi_frame import build_multi_fitter
from smpltpu_torch.utils.obs import span


def interp_tables(anchor_idx, n_frames: int):
    """Static (seg_lo, seg_hi, t) tables: frame i in anchor segment
    [a_k, a_{k+1}) gets (1-t) * anchor[k] + t * anchor[k+1] with
    t = (i - a_k) / (a_{k+1} - a_k); frames at/past the last anchor get
    anchor[last] (hi == lo there). A copy of the reference's numpy helper,
    whose module imports JAX."""
    anchor_idx = np.asarray(anchor_idx, np.int64)
    n_a = len(anchor_idx)
    i = np.arange(n_frames)
    seg = np.clip(np.searchsorted(anchor_idx, i, side="right") - 1,
                  0, n_a - 1)
    lo_f = anchor_idx[seg]
    hi = np.minimum(seg + 1, n_a - 1)
    nxt = np.where(seg + 1 < n_a, anchor_idx[hi], n_frames)
    t = (i - lo_f) / np.maximum(nxt - lo_f, 1)
    return seg, hi, t.astype(np.float64)


def interpolate_anchors(ap, seg, hi, t):
    """The frames' poses (N, P) from the anchor optima ``ap`` (A, P) and
    ``interp_tables``' tables as tensors on ap's device (``t`` as (N, 1)
    in ap's dtype): the fused run's interpolation."""
    return (1.0 - t) * ap[seg] + t * ap[hi]


def build_fused_two_stage(spec, cam, cfg1, cfg2, n_shapes: int, anchor_idx,
                          win_starts, wsize: int, n_frames: int, *, device,
                          dtype, spec2=None):
    """Return run(p0a (A, P), shape0 (nS,), kpa (A, K, 4), r0a (A, 3, 3),
    kpw (W, wsize, K, 4), r0w (W, wsize, 3, 3), vw (W, wsize)) ->
    (stage-1 MultiFrameResult, unbatched; stage-2 MultiFrameResult with a
    leading window axis).

    ``spec2``: the stage-2 skeleton spec when it differs from stage 1's.

    ``run.timings`` holds the wall seconds of the last call's two stages
    (``stage1_s``, ``stage2_s``), each ended by a device synchronize. Under
    a profiler the phases are the spans ``two_stage.stage1``,
    ``two_stage.interp`` (with stage 1's synchronize) and
    ``two_stage.stage2``."""
    fit1 = build_multi_fitter(spec, cam, cfg1, n_shapes, device=device,
                              dtype=dtype)
    fit2 = build_multi_fitter(spec if spec2 is None else spec2, cam, cfg2,
                              n_shapes, device=device, dtype=dtype)
    seg, hi, t = interp_tables(anchor_idx, n_frames)
    seg_t = torch.as_tensor(seg, device=device)
    hi_t = torch.as_tensor(hi, device=device)
    t_t = torch.as_tensor(t, dtype=dtype, device=device)[:, None]
    win_f = (np.asarray(win_starts, np.int64)[:, None]
             + np.arange(wsize)[None])                            # (W, wsize)
    valid = torch.as_tensor(win_f < n_frames, device=device)[..., None]
    win_g = torch.as_tensor(np.clip(win_f, 0, n_frames - 1), device=device)
    init_p = init_frame_params(len(spec.parents), device=device, dtype=dtype,
                               n_hand_comps=hand_comps(spec.hands))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def run(p0a, shape0, kpa, r0a, kpw, r0w, vw):
        t0 = time.perf_counter()
        with span("two_stage.stage1"):
            st1 = fit1(p0a, shape0, kpa, r0a)
        with span("two_stage.interp"):
            poses = interpolate_anchors(st1.params, seg_t, hi_t, t_t)  # (N, P)
            p0w = torch.where(valid, poses[win_g], init_p)  # (W, wsize, P)
            sync()
        t1 = time.perf_counter()
        with span("two_stage.stage2"):
            st2 = fit2(p0w, st1.shape, kpw, r0w, vw)
            sync()
        run.timings = {"stage1_s": t1 - t0, "stage2_s": time.perf_counter() - t1}
        return st1, st2

    run.timings = {}
    return run
