"""The library's entry point: fit a whole video's keypoints in one call
(port of ``smpltpu/pipeline/api.py``). Numpy in, fitted parameters and
diagnostics out, no files:

    result = fit_video(model_dict, kp_batch, width, height,
                       mode="multi", init_from_anchors=True)
    result.params      # (F, 76) packed per-frame pose vectors
    result.shape       # (nS,) shared shape (multi, stream) / (F, nS) (single)
    result.errors_px   # (F,) mean pixel reprojection error per frame
    result.verts       # optional (F, nV, 3) skinned vertices

Everything runs on ``device`` ("cuda" unless the caller asks for the
CPU) in ``dtype``; the evaluation skins through K2 once per call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from smpltpu_torch.constants import init_root_rotation
from smpltpu_torch.energy.params import N_FRAME_PARAMS, init_frame_params
from smpltpu_torch.energy.reproj import make_skeleton_spec
from smpltpu_torch.models.smpl import SMPLModel, require_smpl_width
from smpltpu_torch.pipeline.common import batched_frame_eval
from smpltpu_torch.solve.multi_frame import MultiFrameConfig, build_multi_fitter
from smpltpu_torch.solve.online import OnlineConfig, OnlineFitter
from smpltpu_torch.solve.single_frame import build_fitter, make_single_frame_problem
from smpltpu_torch.utils.camera import default_intrinsics


class FitResult(NamedTuple):
    params: np.ndarray      # (F, P)
    shape: np.ndarray       # (nS,) or (F, nS)
    errors_px: np.ndarray   # (F,)
    verts: Optional[np.ndarray]  # (F, nV, 3) if requested
    converged: np.ndarray   # per frame (single, stream) or per window (multi)
    # meaning by mode:
    #   mode="single": (F, max_iters) per-frame cost after each LM trip
    #   mode="multi":  (max_iters,)   stage 1's cost after each LM trip
    #   mode="stream": (F,)           per-frame final costs (the causal
    #                  solver keeps no trip trace; drive
    #                  solve.online.OnlineFitter.step for one)
    # a trace's slots after the convergence exit hold the final cost
    cost_history: np.ndarray


def fit_video(
    model_dict: dict,
    kp_batch: np.ndarray,        # (F, 17, 4) dense keypoints (io layout)
    width: int,
    height: int,
    mode: str = "multi",         # 'single' | 'multi' | 'stream'
    beta_pose: float = 5.0,
    beta_shape: float = 25.0,
    lambda_temporal: float = 3.0,
    max_iters: int = 100,
    opt_shape: bool = False,     # single mode only
    gmm_dict: Optional[dict] = None,
    anchor_skip: int = 10,
    window: int = 20,
    overlap: int = 5,
    s2_iters: int = 60,
    init_from_anchors: bool = True,
    want_verts: bool = False,
    calib: int = 10,             # stream mode only: calibration buffer
    *,
    device="cuda",
    dtype=torch.float32,
) -> FitResult:
    """Fit every frame of a video. 'single': independent per-frame fits
    (the reference's 3dba_single), one batch; 'multi': shared-shape
    anchors, then every sliding window as one batch (3dba_multi's batched
    windows); 'stream': causal per-frame warm-started solves, the shape
    locked by a calibration buffer (``solve/online.py``; frames with no
    detection hold the previous pose and report converged=False)."""
    dev = torch.device(device)
    model = SMPLModel.from_dict(model_dict, device=dev, dtype=dtype)
    require_smpl_width(model.num_joints, model.hand_pca(), "fit_video")
    cam = default_intrinsics(width, height, device=dev, dtype=dtype)
    r0 = np.asarray(init_root_rotation(), np.float64)
    n_frames = kp_batch.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)
    kp = t(kp_batch)

    def init_params():
        return init_frame_params(model.num_joints, device=dev, dtype=dtype)

    if mode == "single":
        prob = make_single_frame_problem(
            model, r0, cam, beta_pose=beta_pose, beta_shape=beta_shape,
            opt_shape=opt_shape, gmm_dict=gmm_dict)
        x0_one = init_params()
        if opt_shape:
            x0_one = torch.cat([x0_one, x0_one.new_zeros(model.num_shapes)])
        fitter = build_fitter(prob, max_iters=max_iters, device=dev,
                              dtype=dtype)
        st = fitter(x0_one.repeat(n_frames, 1), kp)
        x = st.x.cpu().numpy()
        params = x[:, :N_FRAME_PARAMS]
        shape = (x[:, N_FRAME_PARAMS:] if opt_shape
                 else np.zeros((n_frames, model.num_shapes)))
        converged = st.converged.cpu().numpy()
        cost_history = st.cost_history.cpu().numpy()
    elif mode == "multi":
        spec = make_skeleton_spec(model, r0, with_shape=True)
        anchor_idx = list(range(0, n_frames, anchor_skip))
        cfg1 = MultiFrameConfig(beta_pose=beta_pose, beta_shape=beta_shape,
                                lambda_temporal=lambda_temporal,
                                max_iters=max_iters)
        fit1 = build_multi_fitter(spec, cam, cfg1, model.num_shapes,
                                  device=dev, dtype=dtype)
        n_a = len(anchor_idx)
        st1 = fit1(init_params().repeat(n_a, 1),
                   torch.zeros(model.num_shapes, dtype=dtype, device=dev),
                   kp[anchor_idx], spec.r0.repeat(n_a, 1, 1))
        anchor_params = st1.params.cpu().numpy()
        shape = st1.shape.cpu().numpy()

        default_pose = init_params().cpu().numpy()
        poses = np.tile(default_pose, (n_frames, 1))
        if init_from_anchors:
            for k, fid in enumerate(anchor_idx):
                nxt = anchor_idx[k + 1] if k + 1 < n_a else n_frames
                pb = anchor_params[k + 1] if k + 1 < n_a else anchor_params[k]
                poses[fid] = anchor_params[k]
                for i in range(fid + 1, min(nxt, n_frames)):
                    w = (i - fid) / max(nxt - fid, 1)
                    poses[i] = (1 - w) * anchor_params[k] + w * pb

        stride = window - overlap
        starts = list(range(0, n_frames, stride))
        cfg2 = MultiFrameConfig(beta_pose=beta_pose, beta_shape=1e5,
                                lambda_temporal=lambda_temporal,
                                max_iters=s2_iters)
        fit2 = build_multi_fitter(spec, cam, cfg2, model.num_shapes,
                                  device=dev, dtype=dtype)
        n_w = len(starts)
        wp = np.tile(default_pose, (n_w, window, 1))
        wk = np.zeros((n_w, window) + kp_batch.shape[1:], np.float32)
        wv = np.zeros((n_w, window), np.float32)
        for wi, s in enumerate(starts):
            e = min(s + window, n_frames)
            wp[wi, :e - s] = poses[s:e]
            wk[wi, :e - s] = kp_batch[s:e]
            wv[wi, :e - s] = 1.0
        # every window as one batch (W, F, P): the reference's jax.vmap
        st2 = fit2(t(wp), t(shape).repeat(n_w, 1), t(wk),
                   spec.r0.repeat(n_w, window, 1, 1), t(wv))
        fitted = st2.params.cpu().numpy()
        params = poses
        for wi, s in enumerate(starts):
            e = min(s + window, n_frames)
            params[s:e] = fitted[wi, :e - s]
        converged = st2.converged.cpu().numpy()
        cost_history = st1.cost_history.cpu().numpy()
    elif mode == "stream":
        fit = OnlineFitter(
            model, cam,
            OnlineConfig(beta_pose=beta_pose,
                         lambda_temporal=lambda_temporal,
                         max_iters=max_iters),
            gmm_dict=gmm_dict, device=dev, dtype=dtype)
        kp_np = np.asarray(kp_batch, np.float32)
        valid_idx = np.flatnonzero(kp_np[:, :, 3].sum(axis=1) > 0)
        params = np.tile(fit.prev.cpu().numpy(), (n_frames, 1))
        converged = np.zeros(n_frames, dtype=bool)
        n_calib = min(calib, valid_idx.size)
        start_at = 0
        if n_calib > 0:
            calib_idx = valid_idx[:n_calib]
            params[calib_idx] = fit.calibrate(kp_np[calib_idx],
                                              beta_shape=beta_shape)
            converged[calib_idx] = True
            start_at = int(calib_idx[-1]) + 1
        # the causal replay over the rest, on the trip graph
        costs = np.zeros(n_frames)
        if start_at < n_frames:
            xs, _solved, fcosts, _iters, conv = fit.replay(kp_np[start_at:])
            params[start_at:] = xs
            converged[start_at:] = conv
            costs[start_at:] = fcosts
        cost_history = costs
        shape = fit.shape.cpu().numpy()
    else:
        raise ValueError(f"unknown mode {mode!r}")

    shapes_per_frame = (shape if shape.ndim == 2
                        else np.tile(shape, (n_frames, 1)))
    errors, verts = batched_frame_eval(
        model, params, shapes_per_frame,
        np.tile(r0.astype(np.float32), (n_frames, 1, 1)),
        np.asarray(kp_batch), cam, want_verts=want_verts)
    return FitResult(params=params, shape=shape, errors_px=errors,
                     verts=verts, converged=converged,
                     cost_history=cost_history)
