"""Data-driven frame initialization (port of the numpy half of
``smpltpu/solve/init.py``): the estimators behind the multi CLI's
``--data-init`` and ``--orient-init``.

The reference initializes every frame blindly at s=1, rootAA=0,
t=(0,0,3) (src/main_single_frame.cpp:219-224). ``estimate_frame_init``
reads depth and translation off the detections instead: depth from the
pinhole relation between the keypoints' pixel span and the rest
skeleton's metric span over the same joints, translation from
back-projecting the keypoint centroid at that depth; ``orient=True`` adds
a weak-perspective estimate of the root orientation from the torso
(``estimate_root_orient``). The batched ``*_batch`` twins vectorize every
branch over frames.

Everything below ``rest_joints_cam`` is a copy of the reference's numpy
code (the port may not import it), pinned against the original by
``tests/test_torch_cli.py``; only the source of the default frame
parameters differs (:func:`_init_params`).

The multi-start half fits through the single-frame solver:
``make_start_set`` (the data-driven init under root-yaw hypotheses, the
reference's blind init and optional pose seeds, one row per start),
``best_of_starts``, ``build_px_eval`` and ``fit_adaptive`` (fit every
frame once, multi-start only the frames left above a pixel threshold
and, with ``propagate=True``, walk the neighbours' optima along the
sequence through the streaming scan of ``solve/online.py``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from smpltpu_torch.constants import HUBER_DELTA
from smpltpu_torch.energy.params import frame_param_layout, init_frame_params
from smpltpu_torch.energy.reproj import SkeletonSpec, project, skeleton_joints_cam


def _init_params(n_joints: int, depth: float) -> np.ndarray:
    """The reference init (s=1, rootAA=0, t=(0,0,depth), jointAA=0) as a
    writable float64 numpy vector."""
    return init_frame_params(n_joints, depth=depth, device="cpu",
                             dtype=torch.float64).numpy()


def rest_joints_cam(spec: SkeletonSpec) -> np.ndarray:
    """Rest-pose joint positions in the camera frame at identity pose,
    unit scale, zero translation: R0 @ (root-anchored rest skeleton),
    (nJ, 3) float64 numpy, computed on the host from the spec's offsets and
    R0 (as the reference does, in float64 from the spec's values)."""
    n_j = len(spec.parents)
    spec_ns = SkeletonSpec(
        parents=spec.parents,
        base_offsets=spec.base_offsets.detach().to("cpu", torch.float64),
        r0=spec.r0.detach().to("cpu", torch.float64),
        joint_shape_reg=None)
    x0 = init_frame_params(n_j, depth=0.0, device="cpu", dtype=torch.float64)
    return skeleton_joints_cam(
        x0, torch.zeros(1, dtype=torch.float64), spec_ns).numpy()


# Rigid-ish torso subset of the observable SMPL joints (constants.USE_SMPL):
# pelvis (0), hips (1, 2), shoulders (16, 17). Knees/ankles/wrists move with
# limb articulation and would violate the rigidity assumption badly.
TORSO_SMPL_IDS = (0, 1, 2, 16, 17)


def aa_from_rotation(r: np.ndarray) -> np.ndarray:
    """Angle-axis from a rotation matrix (numpy, Shepperd's quaternion
    extraction — stable on all branches including angle ~ pi, where the
    direct trace/arccos log map loses the axis)."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        q = np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                      (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        q = np.array([(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                      (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s])
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        q = np.array([(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                      0.25 * s, (r[1, 2] + r[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        q = np.array([(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                      (r[1, 2] + r[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    angle = 2.0 * np.arccos(np.clip(q[0], -1.0, 1.0))
    sn = np.linalg.norm(q[1:])
    if sn < 1e-12:
        return np.zeros(3)
    return q[1:] / sn * angle


def rotation_from_aa(aa: np.ndarray) -> np.ndarray:
    """Rodrigues (numpy) — inverse of aa_from_rotation."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa)
    if th < 1e-12:
        return np.eye(3)
    k = aa / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1.0 - np.cos(th)) * (kx @ kx)


def estimate_root_orient(
    kp_dense: np.ndarray,   # (K, 4) [jid, u, v, valid]
    rest_cam: np.ndarray,   # (nJ, 3) from rest_joints_cam(spec)
    cam,
    torso_ids=TORSO_SMPL_IDS,
    min_pts: int = 4,
    depth_bounds: tuple = (0.5, 15.0),
):
    """Weak-perspective Procrustes estimate of the root rotation from one
    frame's 2D detections (the SMPLify-style PnP init). Returns
    (R (3,3), t (3,)) in the solver's root convention — FK applies
    joints_cam = s * R_aa @ rest_cam + t (energy/reproj.py:128-132), so R
    IS rodrigues(root_aa) directly — or None when degenerate.

    Why: the reference's blind init (src/main_single_frame.cpp:219-224)
    AND the repo's span-based data init both start at identity root
    orientation; on frames whose true root rotation exceeds ~1 rad the
    robustified energy's basin is unreachable from there, and a yaw-only
    multi-start cannot recover non-yaw rotations (measured on the
    1000-frame bench ramp: 873/1000 frames stuck >6 px, 13.96 px mean
    after escalating all of them —
    docs/measurements/bench_sweep_r5_20260820.log adapt1000-noorient;
    scope: on that workload articulation amplitude dominates and the
    estimate alone buys only 13.20 px — see fit_adaptive's ``propagate``
    for the at-scale lever). This estimator reads the
    orientation off the data instead:

      normalized centered 2D  y_i ≈ (1/z̄) * (R (X_i - X̄))_{xy}

    over the rigid-ish TORSO joints (falls back to all observed joints
    below ``min_pts``), solved by least squares for the 2x3 map, then
    lifted to SO(3) via SVD (nearest scaled rotation rows; r3 = r1 x r2).
    Mean depth z̄ = 1/alpha from the singular values, translation from the
    centroids. Weak perspective holds because torso extent (~0.5 m) is
    small against typical subject depth (>2 m)."""
    kp = np.asarray(kp_dense, np.float64)
    valid = kp[:, 3] > 0
    jid = kp[valid, 0].astype(int)
    uv = kp[valid, 1:3]
    sel = np.isin(jid, np.asarray(torso_ids))
    if sel.sum() < min_pts:
        sel = np.ones(jid.shape, bool)
    if sel.sum() < min_pts:
        return None
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    x = rest_cam[jid[sel]]                                   # (N, 3)
    y = np.stack([(uv[sel, 0] - cx) / fx, (uv[sel, 1] - cy) / fy], axis=1)
    xc = x - x.mean(0)
    yc = y - y.mean(0)
    g = xc.T @ xc
    try:
        evals, evecs = np.linalg.eigh(g)                     # ascending
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(evals).all() or evals[2] <= 1e-12:
        return None
    if evals[1] < 1e-6 * evals[2]:
        # collinear points: orientation about the line is unobservable
        return None
    if evals[0] < 1e-2 * evals[2]:
        # PLANAR point set — the SMPL torso in practice (pelvis/hips/
        # shoulders are coplanar to ~1 cm). The 3D normal equations are
        # singular along the plane normal (a ridge there amplifies noise
        # into an arbitrary out-of-plane column — measured: singular
        # values 3-12x the true 1/z̄, garbage rotations), so solve the
        # classical planar weak-perspective pose instead: LS the 2x2 map
        # A from plane coordinates to image, then A = (1/z̄) * U diag(1,
        # cos phi) V^T where phi is the out-of-plane tilt — z̄ from the
        # LARGE singular value, tilt magnitude from the foreshortening
        # ratio, tilt SIGN unobservable (the Necker flip start covers it).
        p_basis = evecs[:, [2, 1]]                           # (3, 2)
        xi = xc @ p_basis                                    # (N, 2)
        try:
            a2 = np.linalg.solve(xi.T @ xi, xi.T @ yc).T     # (2, 2)
            u2, s2, vt2 = np.linalg.svd(a2)
        except np.linalg.LinAlgError:
            return None
        if not np.isfinite(s2).all() or s2[0] < 1e-9:
            return None
        alpha = float(s2[0])                                 # = 1 / z̄
        cphi = float(np.clip(s2[1] / s2[0], 0.0, 1.0))
        sphi = np.sqrt(1.0 - cphi * cphi)
        # Q = R @ p_basis (3x2, orthonormal columns): top 2x2 from the
        # SVD frame, third row sphi * v2 (Q^T Q = I by construction)
        q = np.vstack([u2 @ np.diag([1.0, cphi]) @ vt2, sphi * vt2[1]])
        basis3 = np.column_stack(
            [p_basis, np.cross(p_basis[:, 0], p_basis[:, 1])])
        q3 = np.cross(q[:, 0], q[:, 1])
        r = np.column_stack([q, q3]) @ basis3.T
    else:
        # genuinely 3D spread: full 3-column LS, lifted to the nearest
        # scaled rotation rows via SVD (r3 = r1 x r2)
        m = (yc.T @ xc) @ np.linalg.inv(g + 1e-12 * np.eye(3))   # (2, 3)
        try:
            u_m, s_m, vt_m = np.linalg.svd(m)
        except np.linalg.LinAlgError:
            return None
        if not np.isfinite(s_m).all() or s_m[0] < 1e-9:
            return None
        alpha = float(s_m.mean())                            # = 1 / z̄
        r2 = u_m @ vt_m[:2]                                  # (2, 3)
        r = np.vstack([r2, np.cross(r2[0], r2[1])])          # det +1
    # paraperspective correction: the affine LS estimates orientation as
    # seen from the CENTROID RAY's frame, not the optical axis — for an
    # off-center subject (±0.5 m at 2-5 m, viewing angles to ~14 deg)
    # this is the dominant model error (measured on synthetic rigid
    # torsos: 6.4 -> 2.1 deg median with the correction). Pre-rotate by
    # the minimal rotation taking e_z to the centroid ray.
    d = np.array([y[:, 0].mean(), y[:, 1].mean(), 1.0])
    d = d / np.linalg.norm(d)
    v = np.cross([0.0, 0.0, 1.0], d)
    if np.linalg.norm(v) > 1e-12:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        r = (np.eye(3) + vx + vx @ vx / (1.0 + d[2])) @ r
    if alpha < 1.0 / depth_bounds[1] or alpha > 1.0 / depth_bounds[0]:
        return None
    z_bar = 1.0 / alpha
    rx_bar = r @ x.mean(0)
    t = np.array([y[:, 0].mean() * z_bar - rx_bar[0],
                  y[:, 1].mean() * z_bar - rx_bar[1],
                  z_bar - rx_bar[2]])
    if not (depth_bounds[0] * 0.5 <= t[2] + rx_bar[2] <= depth_bounds[1] * 2):
        return None
    return r, t


def estimate_frame_init(
    kp_dense: np.ndarray,   # (K, 4) [jid, u, v, valid]
    rest_cam: np.ndarray,   # (nJ, 3) from rest_joints_cam(spec)
    cam,
    n_joints: int = 24,
    depth_bounds: tuple = (0.5, 15.0),
    min_kps: int = 4,
    default_depth: float = 3.0,
    orient: bool = False,
) -> np.ndarray:
    """Closed-form (P,) init for one frame. Falls back to the reference
    init (s=1, t=(0,0,default_depth)) when fewer than min_kps detections.

    ``orient=True`` additionally estimates the ROOT ROTATION by
    weak-perspective Procrustes over the torso detections
    (:func:`estimate_root_orient`) and uses its translation; identity-
    orientation span init when that is degenerate. Opt-in so the plain
    ``--data-init`` paths (and the committed full-res pipeline golden)
    keep their pinned behavior; the adaptive/multi-start machinery turns
    it on (fit_adaptive, make_start_set)."""
    x0 = _init_params(n_joints, default_depth)
    kp_dense = np.asarray(kp_dense, np.float64)
    valid = kp_dense[:, 3] > 0
    if valid.sum() < min_kps:
        return x0
    if orient:
        est = estimate_root_orient(kp_dense, rest_cam, cam,
                                   depth_bounds=depth_bounds)
        if est is not None:
            r_est, t_est = est
            x0[1:4] = aa_from_rotation(r_est)
            x0[4:7] = np.clip(t_est, [-50.0, -50.0, depth_bounds[0]],
                              [50.0, 50.0, depth_bounds[1]])
            return x0
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    uv = kp_dense[valid, 1:3]
    jid = kp_dense[valid, 0].astype(int)
    span_px = float(uv[:, 1].max() - uv[:, 1].min())
    span_m = float(rest_cam[jid, 1].max() - rest_cam[jid, 1].min())
    if span_px < 1.0 or span_m <= 0.0:
        return x0
    # the span and the v back-projection are VERTICAL -> fy (fx only for u);
    # identical for the default_intrinsics fx==fy but not for a real
    # calibrated camera
    z = float(np.clip(fy * span_m / span_px, *depth_bounds))
    tx = (float(uv[:, 0].mean()) - cx) * z / fx - float(rest_cam[jid, 0].mean())
    ty = (float(uv[:, 1].mean()) - cy) * z / fy - float(rest_cam[jid, 1].mean())
    x0[4:7] = (tx, ty, z)
    return x0


# ---------------------------------------------------------------------------
# Batched (vectorized-over-frames) init builders.
#
# The per-frame functions above are ~60 tiny numpy ops each; these
# batched twins vectorize every branch across the frame axis (batched
# eigh/svd/solve loop in C, masked sums replace subset gathers) and are
# pinned equal to the per-frame loops in the reference's tests
# (tests/test_init_batch.py). The per-frame functions remain the
# reference implementation.
# ---------------------------------------------------------------------------


def rotation_from_aa_batch(aa: np.ndarray) -> np.ndarray:
    """Rodrigues over a batch: (F, 3) -> (F, 3, 3). Matches
    rotation_from_aa row-for-row (identity below the 1e-12 angle floor)."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa, axis=1)
    safe = np.where(th < 1e-12, 1.0, th)
    k = aa / safe[:, None]
    kx = np.zeros(aa.shape[:1] + (3, 3))
    kx[:, 0, 1] = -k[:, 2]
    kx[:, 0, 2] = k[:, 1]
    kx[:, 1, 0] = k[:, 2]
    kx[:, 1, 2] = -k[:, 0]
    kx[:, 2, 0] = -k[:, 1]
    kx[:, 2, 1] = k[:, 0]
    r = (np.eye(3)[None] + np.sin(th)[:, None, None] * kx
         + (1.0 - np.cos(th))[:, None, None] * (kx @ kx))
    return np.where((th < 1e-12)[:, None, None], np.eye(3)[None], r)


def aa_from_rotation_batch(r: np.ndarray) -> np.ndarray:
    """Shepperd quaternion extraction over a batch: (F, 3, 3) -> (F, 3).
    Matches aa_from_rotation row-for-row (all four branches; the batched
    sqrt clamps its argument at 0 where the scalar version would produce
    NaN on a numerically-degenerate non-rotation input)."""
    r = np.asarray(r, np.float64)
    t = np.trace(r, axis1=1, axis2=2)
    with np.errstate(all="ignore"):
        s0 = np.sqrt(np.maximum(t + 1.0, 0.0)) * 2.0
        q0 = np.stack([0.25 * s0, (r[:, 2, 1] - r[:, 1, 2]) / s0,
                       (r[:, 0, 2] - r[:, 2, 0]) / s0,
                       (r[:, 1, 0] - r[:, 0, 1]) / s0], 1)
        s1 = np.sqrt(np.maximum(
            1.0 + r[:, 0, 0] - r[:, 1, 1] - r[:, 2, 2], 0.0)) * 2.0
        q1 = np.stack([(r[:, 2, 1] - r[:, 1, 2]) / s1, 0.25 * s1,
                       (r[:, 0, 1] + r[:, 1, 0]) / s1,
                       (r[:, 0, 2] + r[:, 2, 0]) / s1], 1)
        s2 = np.sqrt(np.maximum(
            1.0 + r[:, 1, 1] - r[:, 0, 0] - r[:, 2, 2], 0.0)) * 2.0
        q2 = np.stack([(r[:, 0, 2] - r[:, 2, 0]) / s2,
                       (r[:, 0, 1] + r[:, 1, 0]) / s2, 0.25 * s2,
                       (r[:, 1, 2] + r[:, 2, 1]) / s2], 1)
        s3 = np.sqrt(np.maximum(
            1.0 + r[:, 2, 2] - r[:, 0, 0] - r[:, 1, 1], 0.0)) * 2.0
        q3 = np.stack([(r[:, 1, 0] - r[:, 0, 1]) / s3,
                       (r[:, 0, 2] + r[:, 2, 0]) / s3,
                       (r[:, 1, 2] + r[:, 2, 1]) / s3, 0.25 * s3], 1)
        c0 = (t > 0)[:, None]
        c1 = ((r[:, 0, 0] > r[:, 1, 1])
              & (r[:, 0, 0] > r[:, 2, 2]))[:, None]
        c2 = (r[:, 1, 1] > r[:, 2, 2])[:, None]
        q = np.where(c0, q0, np.where(c1, q1, np.where(c2, q2, q3)))
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        q = np.where(q[:, :1] < 0, -q, q)
        angle = 2.0 * np.arccos(np.clip(q[:, 0], -1.0, 1.0))
        sn = np.linalg.norm(q[:, 1:], axis=1)
        small = sn < 1e-12
        aa = q[:, 1:] / np.where(small, 1.0, sn)[:, None] * angle[:, None]
    return np.where(small[:, None], 0.0, aa)


def _rowwise_lapack(fn, out_shape_like, ok, *args):
    """Run a batched numpy.linalg call; if LAPACK raises for ANY row
    (possible even past a det/finite pre-guard — e.g. an exact zero
    pivot on a near-singular 2x2 whose f64 det rounds nonzero), fall
    back to per-row calls, marking the failing rows not-ok. The
    per-frame reference path wraps the same calls in try/except, so
    this reproduces its None-semantics row-for-row (and bitwise values
    for the rows that succeed — same LAPACK routine either way)."""
    try:
        return fn(*args), ok
    except np.linalg.LinAlgError:
        out = np.zeros_like(out_shape_like)
        good = ok.copy()
        for i in range(out.shape[0]):
            if not good[i]:
                continue
            try:
                out[i] = fn(*(a[i] for a in args))
            except np.linalg.LinAlgError:
                good[i] = False
        return out, good


def estimate_root_orient_batch(
    kp_batch: np.ndarray,   # (F, K, 4)
    rest_cam: np.ndarray,
    cam,
    torso_ids=TORSO_SMPL_IDS,
    min_pts: int = 4,
    depth_bounds: tuple = (0.5, 15.0),
):
    """Vectorized :func:`estimate_root_orient`. Returns
    ``(r (F,3,3), t (F,3), ok (F,) bool)``; frames where the per-frame
    version would return ``None`` have ``ok=False`` (r=I, t=0). Every
    branch — torso/all-joints fallback, collinear/planar/3D-spread
    split, paraperspective correction, depth gates — mirrors the scalar
    code; equality pinned by tests/test_init_batch.py (and fuzzed over
    degenerate-input zoos). Caveat: on frames sitting exactly AT a
    branch threshold (the 1e-2 planar/3D split, near-equal eigenvalues)
    ulp-level differences between the masked-sum and subset-sum input
    statistics can flip the branch — both results are then equally
    valid estimates of a degenerate frame (ok-semantics still match).
    LAPACK non-convergence/singularity on pathological rows falls back
    to per-row calls (_rowwise_lapack) instead of failing the batch."""
    kp = np.asarray(kp_batch, np.float64)
    f_dim = kp.shape[0]
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    eye3 = np.eye(3)[None]

    with np.errstate(all="ignore"):
        valid = kp[:, :, 3] > 0
        jid = np.clip(kp[:, :, 0].astype(int), 0, rest_cam.shape[0] - 1)
        torso = np.isin(jid, np.asarray(torso_ids)) & valid
        use_torso = torso.sum(1) >= min_pts
        sel = np.where(use_torso[:, None], torso, valid)
        ok = sel.sum(1) >= min_pts
        w = sel.astype(np.float64)
        n = np.maximum(w.sum(1), 1.0)

        x_all = rest_cam[jid]                                   # (F, K, 3)
        y_all = np.stack([(kp[:, :, 1] - cx) / fx,
                          (kp[:, :, 2] - cy) / fy], axis=2)     # (F, K, 2)
        xm = (x_all * w[:, :, None]).sum(1) / n[:, None]
        ym = (y_all * w[:, :, None]).sum(1) / n[:, None]
        xc = (x_all - xm[:, None, :]) * w[:, :, None]
        yc = (y_all - ym[:, None, :]) * w[:, :, None]
        g = np.einsum("fki,fkj->fij", xc, xc)
        ok &= np.isfinite(g).all((1, 2))
        g_in = np.where(ok[:, None, None], g, eye3)
        try:
            evals, evecs = np.linalg.eigh(g_in)
        except np.linalg.LinAlgError:
            evals = np.zeros((f_dim, 3))
            evecs = np.tile(np.eye(3), (f_dim, 1, 1))
            for i in range(f_dim):
                try:
                    evals[i], evecs[i] = np.linalg.eigh(g_in[i])
                except np.linalg.LinAlgError:
                    ok[i] = False
        ok &= np.isfinite(evals).all(1) & (evals[:, 2] > 1e-12)
        ok &= evals[:, 1] >= 1e-6 * evals[:, 2]
        planar = evals[:, 0] < 1e-2 * evals[:, 2]

        # ---- planar branch (torso in practice) ----
        p_basis = evecs[:, :, [2, 1]]                           # (F, 3, 2)
        xi = np.einsum("fki,fij->fkj", xc, p_basis)             # (F, K, 2)
        m2 = np.einsum("fki,fkj->fij", xi, xi)                  # (F, 2, 2)
        rhs = np.einsum("fki,fkj->fij", xi, yc)                 # (F, 2, 2)
        det2 = m2[:, 0, 0] * m2[:, 1, 1] - m2[:, 0, 1] * m2[:, 1, 0]
        s_ok = (np.isfinite(m2).all((1, 2)) & np.isfinite(rhs).all((1, 2))
                & (det2 != 0.0))
        a2, s_ok = _rowwise_lapack(
            np.linalg.solve, rhs, s_ok,
            np.where(s_ok[:, None, None], m2, np.eye(2)[None]),
            np.where(s_ok[:, None, None], rhs, 0.0))
        a2 = np.swapaxes(a2, 1, 2)                              # the .T
        s_ok &= np.isfinite(a2).all((1, 2))
        a2_in = np.where(s_ok[:, None, None], a2, np.eye(2)[None])
        try:
            u2, s2, vt2 = np.linalg.svd(a2_in)
        except np.linalg.LinAlgError:
            u2 = np.tile(np.eye(2), (f_dim, 1, 1))
            s2 = np.zeros((f_dim, 2))
            vt2 = np.tile(np.eye(2), (f_dim, 1, 1))
            for i in range(f_dim):
                try:
                    u2[i], s2[i], vt2[i] = np.linalg.svd(a2_in[i])
                except np.linalg.LinAlgError:
                    s_ok[i] = False
        pl_ok = s_ok & np.isfinite(s2).all(1) & (s2[:, 0] >= 1e-9)
        alpha_p = s2[:, 0]
        cphi = np.clip(s2[:, 1] / np.where(alpha_p == 0.0, 1.0, alpha_p),
                       0.0, 1.0)
        sphi = np.sqrt(1.0 - cphi * cphi)
        dg = np.zeros((f_dim, 2, 2))
        dg[:, 0, 0] = 1.0
        dg[:, 1, 1] = cphi
        top = u2 @ dg @ vt2                                     # (F, 2, 2)
        q = np.concatenate(
            [top, (sphi[:, None] * vt2[:, 1, :])[:, None, :]], axis=1)
        basis3 = np.concatenate(
            [p_basis,
             np.cross(p_basis[:, :, 0], p_basis[:, :, 1])[:, :, None]],
            axis=2)                                             # (F, 3, 3)
        q3 = np.cross(q[:, :, 0], q[:, :, 1])                   # (F, 3)
        r_pl = (np.concatenate([q, q3[:, :, None]], axis=2)
                @ np.swapaxes(basis3, 1, 2))

        # ---- 3D-spread branch ----
        g_reg = g + 1e-12 * eye3
        inv_ok = np.isfinite(g_reg).all((1, 2)) & (
            np.abs(np.linalg.det(g_reg)) > 0.0)
        g_inv, inv_ok = _rowwise_lapack(
            np.linalg.inv, g_reg, inv_ok,
            np.where(inv_ok[:, None, None], g_reg, eye3))
        m3 = np.einsum("fki,fkj->fij", yc, xc) @ g_inv          # (F, 2, 3)
        m3_ok = inv_ok & np.isfinite(m3).all((1, 2))
        m3_in = np.where(m3_ok[:, None, None], m3, np.eye(2, 3)[None])
        try:
            u_m, s_m, vt_m = np.linalg.svd(m3_in)
        except np.linalg.LinAlgError:
            u_m = np.tile(np.eye(2), (f_dim, 1, 1))
            s_m = np.zeros((f_dim, 2))
            vt_m = np.tile(np.eye(3), (f_dim, 1, 1))
            for i in range(f_dim):
                try:
                    u_m[i], s_m[i], vt_m[i] = np.linalg.svd(m3_in[i])
                except np.linalg.LinAlgError:
                    m3_ok[i] = False
        ok3 = m3_ok & np.isfinite(s_m).all(1) & (s_m[:, 0] >= 1e-9)
        alpha_3 = s_m.mean(1)
        r2 = u_m @ vt_m[:, :2, :]                               # (F, 2, 3)
        r_3d = np.concatenate(
            [r2, np.cross(r2[:, 0], r2[:, 1])[:, None, :]], axis=1)

        r = np.where(planar[:, None, None], r_pl, r_3d)
        alpha = np.where(planar, alpha_p, alpha_3)
        ok &= np.where(planar, pl_ok, ok3)

        # ---- paraperspective correction ----
        d = np.concatenate([ym, np.ones((f_dim, 1))], axis=1)
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        v = np.stack([-d[:, 1], d[:, 0], np.zeros(f_dim)], axis=1)
        nv = np.linalg.norm(v, axis=1)
        vx = np.zeros((f_dim, 3, 3))
        vx[:, 0, 1] = -v[:, 2]
        vx[:, 0, 2] = v[:, 1]
        vx[:, 1, 0] = v[:, 2]
        vx[:, 1, 2] = -v[:, 0]
        vx[:, 2, 0] = -v[:, 1]
        vx[:, 2, 1] = v[:, 0]
        corr = eye3 + vx + vx @ vx / (1.0 + d[:, 2])[:, None, None]
        r = np.where((nv > 1e-12)[:, None, None], corr @ r, r)

        ok &= ((alpha >= 1.0 / depth_bounds[1])
               & (alpha <= 1.0 / depth_bounds[0]))
        z_bar = 1.0 / np.where(alpha == 0.0, 1.0, alpha)
        rx_bar = np.einsum("fij,fj->fi", r, xm)
        t = np.stack([ym[:, 0] * z_bar - rx_bar[:, 0],
                      ym[:, 1] * z_bar - rx_bar[:, 1],
                      z_bar - rx_bar[:, 2]], axis=1)
        zc = t[:, 2] + rx_bar[:, 2]
        ok &= (depth_bounds[0] * 0.5 <= zc) & (zc <= depth_bounds[1] * 2)

    r = np.where(ok[:, None, None], r, eye3)
    t = np.where(ok[:, None], t, 0.0)
    return r, t, ok


def estimate_frame_init_batch(
    kp_batch: np.ndarray,   # (F, K, 4)
    rest_cam: np.ndarray,
    cam,
    n_joints: int = 24,
    depth_bounds: tuple = (0.5, 15.0),
    min_kps: int = 4,
    default_depth: float = 3.0,
    orient: bool = False,
) -> np.ndarray:
    """Vectorized :func:`estimate_frame_init`: (F, K, 4) -> (F, P).
    Row-for-row equal to the per-frame loop (tests/test_init_batch.py)."""
    kp = np.asarray(kp_batch, np.float64)
    f_dim = kp.shape[0]
    x0 = np.tile(_init_params(n_joints, default_depth), (f_dim, 1))
    if f_dim == 0:
        return x0
    valid = kp[:, :, 3] > 0
    proc = valid.sum(1) >= min_kps
    if not proc.any():
        return x0
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    done = np.zeros(f_dim, bool)
    if orient:
        r_b, t_b, ok_o = estimate_root_orient_batch(
            kp, rest_cam, cam, depth_bounds=depth_bounds)
        use = proc & ok_o
        if use.any():
            x0[use, 1:4] = aa_from_rotation_batch(r_b[use])
            x0[use, 4:7] = np.clip(
                t_b[use], [-50.0, -50.0, depth_bounds[0]],
                [50.0, 50.0, depth_bounds[1]])
            done |= use
    span = proc & ~done
    if span.any():
        with np.errstate(all="ignore"):
            jid = np.clip(kp[:, :, 0].astype(int), 0,
                          rest_cam.shape[0] - 1)
            w = valid.astype(np.float64)
            n = np.maximum(w.sum(1), 1.0)
            upix, vpix = kp[:, :, 1], kp[:, :, 2]
            span_px = (np.where(valid, vpix, -np.inf).max(1)
                       - np.where(valid, vpix, np.inf).min(1))
            ry = rest_cam[jid, 1]
            span_m = (np.where(valid, ry, -np.inf).max(1)
                      - np.where(valid, ry, np.inf).min(1))
            good = span & (span_px >= 1.0) & (span_m > 0.0)
            z = np.clip(fy * span_m / np.where(span_px == 0.0, 1.0,
                                               span_px), *depth_bounds)
            tx = ((upix * w).sum(1) / n - cx) * z / fx \
                - (rest_cam[jid, 0] * w).sum(1) / n
            ty = ((vpix * w).sum(1) / n - cy) * z / fy \
                - (ry * w).sum(1) / n
        x0[good, 4] = tx[good]
        x0[good, 5] = ty[good]
        x0[good, 6] = z[good]
    return x0


def make_start_set(
    kp_batch: np.ndarray,   # (F, K, 4)
    spec: SkeletonSpec,
    cam,
    yaws=(0.0, np.pi / 2, -np.pi / 2, np.pi),
    include_reference_init: bool = True,
    n_extra_dims: int = 0,   # append zeros (e.g. the shape block) per start
    pose_seeds: np.ndarray = None,   # (S_extra, 3*(nJ-1)) joint-AA seeds
    orient: bool = True,
) -> np.ndarray:
    """(F, S, P[+extra]) float64 start set: the data-driven init under each
    yaw hypothesis [+ the reference's blind init] [+ one start per pose
    seed, with the data-driven root and the seed's joint angle-axes].

    ``orient=True``: each frame's base start carries the weak-perspective
    root-orientation estimate, the yaws compose about the camera y axis on
    top of it, and the yaw = pi slot becomes the Necker flip
    (diag(1,1,-1) R diag(1,1,-1)); a frame without an estimate keeps the
    absolute yaw. Pose seeds are how a GMM prior's component means enter:
    the hard-assignment energy is piecewise and a zero-pose start cannot
    switch component basins (the reference's docstring says more)."""
    rest = rest_joints_cam(spec)
    n_j = len(spec.parents)
    p_dim = frame_param_layout(n_j)["total"]
    f_dim = kp_batch.shape[0]
    necker = np.diag([1.0, 1.0, -1.0])
    base = estimate_frame_init_batch(np.asarray(kp_batch, np.float64),
                                     rest, cam, n_joints=n_j,
                                     orient=orient)
    have_r = (np.any(base[:, 1:4] != 0.0, axis=1) if orient
              else np.zeros(f_dim, bool))
    r_est = rotation_from_aa_batch(base[:, 1:4])
    rows = []
    for yaw in yaws:
        v = base.copy()
        v[~have_r, 2] = yaw
        if have_r.any():
            # tolerant matching: a near-pi yaw still gets the Necker flip,
            # a near-zero one the plain base start
            if np.isclose(abs(yaw), np.pi):
                v[have_r, 1:4] = aa_from_rotation_batch(
                    necker[None] @ r_est[have_r] @ necker[None])
            elif not np.isclose(yaw, 0.0):
                v[have_r, 1:4] = aa_from_rotation_batch(
                    rotation_from_aa(np.array([0.0, yaw, 0.0]))[None]
                    @ r_est[have_r])
        rows.append(v)
    if include_reference_init:
        rows.append(np.tile(_init_params(n_j, 3.0), (f_dim, 1)))
    if pose_seeds is not None:
        for seed in np.asarray(pose_seeds, np.float64):
            v = base.copy()
            v[:, 7:p_dim] = seed
            rows.append(v)
    out = np.stack(rows, axis=1)                # (F, S, P)
    if n_extra_dims > 0:
        out = np.concatenate(
            [out, np.zeros(out.shape[:2] + (n_extra_dims,))], axis=-1)
    return out


def build_px_eval(prob):
    """fn(x (F, P[+nS]), kp (F, K, 4)) -> (F,) mean pixel error over each
    frame's valid keypoints (0 for an empty frame) under the solver's
    forward, the fitted scale included, in x's dtype: how ``fit_adaptive``
    picks the frames worth multi-starting."""
    p = frame_param_layout(len(prob.spec.parents))["total"]

    def fn(x, kp):
        shape = (x[..., p:] if prob.opt_shape
                 else x.new_zeros(x.shape[:-1] + (prob.n_shapes,)))
        uv = project(skeleton_joints_cam(x[..., :p], shape, prob.spec),
                     prob.cam)                                    # (F, nJ, 2)
        jid = kp[..., 0].long()
        d = torch.linalg.vector_norm(
            torch.take_along_dim(uv, jid[..., None], dim=-2) - kp[..., 1:3],
            dim=-1)
        v = kp[..., 3]
        return torch.sum(d * v, dim=-1) / torch.clamp(torch.sum(v, dim=-1),
                                                       min=1.0)
    return fn


class AdaptiveResult:
    """fit_adaptive output (numpy): per-frame best params, cost and pixel
    error, convergence, trips and the cost history of each frame's
    selected solve, the frames escalated and where the escalation won."""

    def __init__(self, x, cost, px, converged, iters_run, cost_history,
                 hard_idx, escalated):
        self.x = x                        # (F, P[+nS])
        self.cost = cost                  # (F,)
        self.px = px                      # (F,) mean pixel error
        self.converged = converged        # (F,) bool
        self.iters_run = iters_run        # (F,)
        self.cost_history = cost_history  # (F, H)
        self.hard_idx = hard_idx          # (n_hard,) frames escalated
        self.escalated = escalated        # (F,) bool: multi-start result kept


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def fit_adaptive(
    prob,
    kp_batch: np.ndarray,     # (F, K, 4)
    max_iters: int,
    px_thresh: float = 6.0,
    chunk: int = 0,
    lm_cfg=None,
    dtype=None,
    yaws=(np.pi / 2, -np.pi / 2, np.pi),
    fitter=None,
    orient: bool = True,
    propagate: bool = False,
    propagate_iters: int = 30,
) -> AdaptiveResult:
    """Adaptive multi-start single-frame fitting, on the problem's device:

    1. fit every frame once from the data-driven init;
    2. multi-start only the frames whose phase-1 mean pixel error exceeds
       ``px_thresh``: one smaller batch over the other start hypotheses
       (the extra ``yaws`` around the data init, the reference's blind
       init and, with a GMM prior, one start per component mean), keeping
       each hard frame's lowest-cost result over all its starts;
    3. with ``propagate=True``, for the frames still above the threshold:
       warm-started solves along the sequence (the causal replay of
       ``solve/online.py::build_online_scan`` with the tether weight zero,
       so each frame solves the phase-1 objective from its neighbour's
       optimum), forward and then, while hard frames remain, over the
       reversed sequence; a frame adopts the propagated result only where
       both its pixel error and its cost strictly improve. Pose-only: an
       ``opt_shape`` problem skips it with a warning.

    Unlike the reference, phase 3 takes ``huber_delta`` from ``lm_cfg``
    where one is given, so that the costs that decide adoption are on one
    scale (with the default config the two agree). ``fitter``: a prebuilt
    ``build_fitter`` result to reuse; default one of (max_iters, lm_cfg,
    chunk) in ``dtype`` (float32)."""
    from smpltpu_torch.solve.single_frame import build_fitter

    device = prob.spec.base_offsets.device
    dtype = torch.float32 if dtype is None else dtype
    kp_batch = np.asarray(kp_batch)
    f_dim = kp_batch.shape[0]
    n_j = len(prob.spec.parents)
    n_extra = prob.n_shapes if prob.opt_shape else 0
    rest = rest_joints_cam(prob.spec)

    x0 = estimate_frame_init_batch(kp_batch, rest, prob.cam,
                                   n_joints=n_j, orient=orient)
    if n_extra:
        x0 = np.concatenate([x0, np.zeros((f_dim, n_extra))], axis=-1)
    if fitter is None:
        fitter = build_fitter(prob, max_iters=max_iters, device=device,
                              dtype=dtype, lm_cfg=lm_cfg, chunk=chunk)
    px_eval = build_px_eval(prob)

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)
    kp_t = t(kp_batch)
    st_a = fitter(t(x0), kp_t)
    x, cost, conv, iters, hist, px = (np.array(_numpy(a)) for a in (
        st_a.x, st_a.cost, st_a.converged, st_a.iters_run,
        st_a.cost_history, px_eval(st_a.x, kp_t)))
    escalated = np.zeros(f_dim, bool)

    hard = np.nonzero(px > px_thresh)[0]
    if hard.size:
        seeds = (_numpy(prob.gmm.means).astype(np.float64)
                 if getattr(prob, "gmm", None) is not None else None)
        s_dim = len(yaws) + 1 + (0 if seeds is None else len(seeds))
        starts = make_start_set(kp_batch[hard], prob.spec, prob.cam,
                                yaws=tuple(yaws),
                                include_reference_init=True,
                                n_extra_dims=n_extra, pose_seeds=seeds,
                                orient=orient)
        kp_b = t(np.repeat(kp_batch[hard], s_dim, axis=0))
        st_b = fitter(t(starts.reshape(hard.size * s_dim, -1)), kp_b)
        x_b, cost_bf, conv_b, iters_b, hist_b, px_bf = (_numpy(a) for a in (
            st_b.x, st_b.cost, st_b.converged, st_b.iters_run,
            st_b.cost_history, px_eval(st_b.x, kp_b)))
        px_b = px_bf.reshape(hard.size, s_dim)
        cost_b = cost_bf.reshape(hard.size, s_dim)
        best = np.argmin(cost_b, axis=1)
        rows = np.arange(hard.size)
        better = cost_b[rows, best] < cost[hard]
        sel = hard[better]
        flat = rows[better] * s_dim + best[better]
        x[sel] = x_b[flat]
        cost[sel] = cost_b[rows[better], best[better]]
        px[sel] = px_b[rows[better], best[better]]
        conv[sel] = conv_b[flat]
        iters[sel] = iters_b[flat]
        hist[sel] = hist_b[flat]
        escalated[sel] = True

    if propagate and prob.opt_shape:
        print("[WARN] fit_adaptive: propagate is pose-only (the streaming "
              "scan it reuses locks shape) — skipping phase P for this "
              "--opt-shape problem", file=sys.stderr)
    if propagate and not prob.opt_shape and (px > px_thresh).any():
        scan = _propagate_scan(prob, propagate_iters, device, dtype,
                               HUBER_DELTA if lm_cfg is None
                               else lm_cfg.huber_delta)
        shape0 = torch.zeros(prob.n_shapes, dtype=dtype, device=device)

        def one_pass(order):
            kp_o = t(kp_batch[order])
            xs, costs_p, iters_p, _solved, conv_p = scan(
                t(x[order[0]]), shape0, kp_o, 1.0)
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            return tuple(_numpy(a)[inv] for a in (
                xs, costs_p, iters_p, conv_p, px_eval(xs, kp_o)))

        for order in (np.arange(f_dim), np.arange(f_dim)[::-1]):
            still = px > px_thresh
            if not still.any():
                break
            x_p, c_p, i_p, cv_p, px_p = one_pass(order)
            # adopt only where BOTH the pixel error and the (same-objective)
            # cost strictly improve: phase A's result is never regressed
            sel_p = still & (px_p < px) & (c_p < cost)
            if sel_p.any():
                x[sel_p] = x_p[sel_p]
                cost[sel_p] = c_p[sel_p]
                px[sel_p] = px_p[sel_p]
                iters[sel_p] = i_p[sel_p]
                conv[sel_p] = cv_p[sel_p]
                escalated[sel_p] = True
    return AdaptiveResult(x, cost, px, conv, iters, hist, hard, escalated)


# phase P's scans, one per (problem, trips, device, dtype, Huber scale);
# each value holds its problem, so a recycled id() never hits a stale scan
_PROP_SCAN_CACHE: dict = {}
_PROP_SCAN_CACHE_MAX = 16


def _propagate_scan(prob, max_iters: int, device, dtype, huber_delta: float):
    """The causal replay of phase P: ``build_online_scan`` with
    lambda_temporal = 0 (the tether rows vanish, residual and Jacobian), so
    each scanned frame solves exactly the phase-1 objective (same priors,
    frozen joints, scale bounds and ``freeze_scale``); only the warm start
    is temporal."""
    key = (id(prob), int(max_iters), str(device), dtype, float(huber_delta))
    hit = _PROP_SCAN_CACHE.get(key)
    if hit is not None:
        return hit[1]
    from smpltpu_torch.solve.online import OnlineConfig, build_online_scan

    cfg = OnlineConfig(beta_pose=prob.beta_pose, lambda_temporal=0.0,
                       max_iters=max_iters, freeze_scale=prob.freeze_scale,
                       huber_delta=huber_delta)
    fn = build_online_scan(prob.spec, prob.cam, cfg, prob.n_joints,
                           gmm=prob.gmm, device=device, dtype=dtype)
    if len(_PROP_SCAN_CACHE) >= _PROP_SCAN_CACHE_MAX:
        _PROP_SCAN_CACHE.pop(next(iter(_PROP_SCAN_CACHE)))
    _PROP_SCAN_CACHE[key] = (prob, fn)
    return fn


def best_of_starts(states, f_dim: int, s_dim: int):
    """Each frame's lowest-cost start of an LMResult whose leading axis is
    F*S (starts fastest-varying): (x (F, P), cost (F,), best_idx (F,)),
    numpy."""
    cost = _numpy(states.cost).reshape(f_dim, s_dim)
    best = np.argmin(cost, axis=1)
    x = _numpy(states.x).reshape(f_dim, s_dim, -1)
    return (x[np.arange(f_dim), best],
            cost[np.arange(f_dim), best],
            best)
