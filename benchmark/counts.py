"""The yardstick's arithmetic: the H100's peaks, the analytic operation
and byte counts of the fit's and the render's stages, and each kernel's
bound. Frozen copies, so that a later change to the program cannot move
them:

* ``stage_solver``, ``stage_single_frame``, ``stage_lbs``: the counts of
  ``smpltpu_torch/utils/roofline.py`` (``_solver_counts`` lines 58-92,
  ``stage_single_frame`` 103-122, ``stage_lbs`` 125-133), term for term,
  and its peaks (lines 42-44);
* ``bound_s``: ``chip_smoke.py::bound`` (lines 430-435), the least time
  for a kernel's bytes at 3.35 TB/s or its float32 operations at 67
  TFLOP/s;
* ``k1_launch``, ``k2_work``, ``k3_work``: the operations and bytes that
  ``chip_smoke.py`` holds each kernel to (K1 lines 584-590, K2 1102-1108,
  K3 ``k3_bounds`` 736-750, the ``rasterize_verts`` entry): inputs read
  once and outputs written once, and the work these inputs need; K3's is
  also the render's raster count of ``smpltpu_torch/bench.py::raster_count``
  (lines 694-734).

All are functions of shapes and of the inputs, never of what implements
them.
"""

from __future__ import annotations

from typing import NamedTuple

# one NVIDIA H100 SXM (data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12
F32 = 4


class Work(NamedTuple):
    flops: float
    bytes: float


def bound_s(work: Work) -> float:
    """The least seconds the card can take for ``work``."""
    return max(work.bytes / PEAK_HBM_BPS, work.flops / PEAK_F32_FLOPS)


def stage_solver(n_problems, f_dim, p_dim, n_shapes, kp_rows, lm_iters,
                 cg_iters, linear="pcg") -> Work:
    """A batch of multi-frame trust-region fits: per LM trip and window,
    J^T J over the corrected keypoint rows, ``cg_iters`` PCG matvecs (or
    ~2F block factorizations for the exact solves), +10 %."""
    pq = p_dim + n_shapes
    asm = f_dim * (kp_rows * pq * pq) * 2.0
    if linear in ("pcg", "pcg_kernel"):
        matvec = (f_dim * p_dim * p_dim + 2 * f_dim * p_dim * n_shapes
                  + 2 * (f_dim - 1) * p_dim + n_shapes * n_shapes) * 2.0
        lin = cg_iters * (matvec + 10 * f_dim * p_dim)
        lin_bytes = cg_iters * (f_dim * p_dim * p_dim + f_dim * p_dim
                                * n_shapes) * 4.0
    else:
        lin = 2 * f_dim * (p_dim ** 3) / 3.0 * 2.0
        lin_bytes = f_dim * p_dim * p_dim * 4.0 * 3.0
    per_iter = (asm + lin) * 1.10
    per_iter_bytes = f_dim * kp_rows * pq * 4.0 + lin_bytes
    return Work(n_problems * lm_iters * per_iter,
                n_problems * lm_iters * per_iter_bytes)


def stage_single_frame(n_problems, p_dim, kp_rows, lm_iters,
                       tr_solver="eigh") -> Work:
    """Single-frame LM trips: one (kp_rows + P, P) J^T J and the
    trust-region subproblem each (chol: 8 P^3 / 3 x 2), +10 %."""
    rows = kp_rows + p_dim
    asm = rows * p_dim * p_dim * 2.0
    if tr_solver == "eigh":
        sub = 25.0 * p_dim ** 3
    elif tr_solver == "chol":
        sub = 8 * (p_dim ** 3) / 3.0 * 2.0
    else:
        sub = (p_dim ** 3) / 3.0 * 2.0
    per_iter = (asm + sub) * 1.10
    per_bytes = rows * p_dim * 4.0 + p_dim * p_dim * 4.0 * 4
    return Work(n_problems * lm_iters * per_iter,
                n_problems * lm_iters * per_bytes)


def stage_lbs(batch, n_verts, n_joints=24, n_shapes=10) -> Work:
    per_v = (3 * n_shapes + 12 * n_joints + 12) * 2.0
    return Work(batch * n_verts * per_v,
                batch * n_verts * (3 + 3 * n_shapes + n_joints) * 4.0)


def k1_launch(n_w, f, p, n_s, iters) -> Work:
    """One K1 solve of W windows of F frames, ``iters`` CG steps (rtol 0:
    all run): per step and window the D matvec 2FP^2, the shape border
    4FPnS, the couplings 4FP, C 2nS^2 and 11 (FP + nS) of preconditioner,
    dots and updates; bytes: its seven inputs and two outputs once."""
    flops = iters * n_w * (2 * f * p * p + 4 * f * p * n_s + 4 * f * p
                           + 2 * n_s * n_s + 11 * (f * p + n_s))
    ins = (n_w * f * p * p + n_w * (f - 1) + p + n_w * f * p * n_s
           + n_w * n_s * n_s + n_w * f * p + n_w * n_s)
    outs = n_w * f * p + n_w * n_s
    return Work(float(flops), float(F32 * (ins + outs)))


def k2_work(frames, launches, n_verts, n_joints=24, n_shapes=10) -> Work:
    """K2 over ``frames`` frames in ``launches`` launches: per (frame,
    vertex) the blend 6nS + 3, the transforms 24nJ and the apply 18; bytes:
    each frame's shape, joint affines and output, and the three model
    operands once a launch."""
    flops = frames * n_verts * (6 * n_shapes + 3 + 24 * n_joints + 18)
    per_frame = n_shapes + n_joints * 12 + 3 * n_verts
    per_launch = 3 * n_verts + n_shapes * 3 * n_verts + n_joints * n_verts
    return Work(float(flops), float(F32 * (frames * per_frame + launches * per_launch)))


def k3_work(frames, launches, n_verts, n_faces, box_px, height, width) -> Work:
    """K3 (``rasterize_verts``) over ``frames`` frames in ``launches``
    launches: 12 operations a pixel of every kept face's clipped box
    (``box_px`` over all the frames) plus 150 a face of setup; bytes: every
    frame's vertices, the faces once a launch, gray and covered written
    once. This is also the render's raster count of
    ``smpltpu_torch/bench.py::raster_count``."""
    return Work(12.0 * box_px + 150.0 * frames * n_faces,
                float(F32 * frames * n_verts * 3 + launches * 12 * n_faces
                      + 2 * frames * height * width))
