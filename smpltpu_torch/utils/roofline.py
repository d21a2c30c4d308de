"""Analytic roofline accounting for the fit's and the render's stages
(port of ``smpltpu/utils/roofline.py``, with the H100's peaks).

The reference publishes wall time only (time_ms in log.csv,
src/main_multi_frame.cpp:176-188); what explains the headroom is where
each stage sits on the roofline: achieved FLOP/s against the FP32 peak,
achieved bytes/s against HBM, and which resource (or the host's launch
latency) binds. The counts are analytic, from the solver's structure
(solve/multi_frame.py, energy/jacobian.py, ops/lbs.py, render/zbuffer.py),
not from a profiler; the work counted does not depend on what implements
it, so the formulas are the reference's, term for term.

Counting conventions:
  * 1 MAC = 2 FLOPs; only the dominant dense terms are counted (small
    vector bookkeeping inside loops is folded into a +10% slop on the
    solver stages). Counts carry ~10-20% error.
  * bytes = the device-memory traffic of the dominant operands, each read
    once per use (an upper bound on pressure: a kernel that keeps its
    blocks in shared memory, as K1 does, moves less).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit): 67 TFLOP/s FP32 outside the tensor cores, 989
TFLOP/s bf16 on them, 3.35 TB/s HBM3. ``chip_smoke.py::bound`` reads
them from here.

``DISPATCH_FLOOR_S`` is the host's time to enqueue one eager launch on the
card: ``chip_smoke.py`` phase 11 (``graft_entry``, ``launch_floor_us``)
times 10 000 launches of a one-element add between two synchronizations.
On an NVIDIA H100 80GB HBM3 at 700.00 W with torch 2.11, six runs of it
read 6.82, 8.29, 8.59, 10.92, 11.92 and 12.55 us a launch (PERF.md,
section 6; the first from a call of PR 9, the others of PR 8); the
constant is their median, and the smoke holds each new reading within
1.5x of it (``LAUNCH_FLOOR_BAND``; the six span 1.84x, the host's speed
differs from call to call).
"""

from __future__ import annotations

from typing import NamedTuple

# one H100 SXM
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12
# host time per eager launch on the card (see above); used only for the
# binding-resource verdict on host-dispatched loops
DISPATCH_FLOOR_S = 9.755e-6


class StageCount(NamedTuple):
    name: str
    flops: float          # total FLOPs for the stage
    hbm_bytes: float      # upper-bound HBM traffic
    seq_steps: int        # sequential device-side loop steps (scan/while
                          # trips) — the latency-bound denominator


def _solver_counts(n_problems: int, f_dim: int, p_dim: int, n_shapes: int,
                   kp_rows: int, lm_iters: float, cg_iters: int,
                   linear: str = "pcg") -> tuple:
    """FLOPs/bytes for a batch of multi-frame trust-region fits.

    Per LM iteration and window the dominant terms are
      assembly: J^T J over the corrected keypoint rows — F frames of a
        (kp_rows, P + nS) Jacobian product (the analytic Jacobian's own
        construction is O(kp_rows * (P + nS)) and negligible beside it);
      linear solve: cg_iters PCG matvecs of the (F,P,P) block-diagonal +
        temporal off-diagonals + (F,P,nS) shape coupling (or, for
        tridiag/cr, ~2F Cholesky factorizations of P x P blocks);
      cost: one FK + projection pass, O(F * nJ) — negligible.
    """
    pq = p_dim + n_shapes
    asm = f_dim * (kp_rows * pq * pq) * 2.0            # J^T J (+ J^T r)
    if linear in ("pcg", "pcg_kernel"):
        matvec = (f_dim * p_dim * p_dim + 2 * f_dim * p_dim * n_shapes
                  + 2 * (f_dim - 1) * p_dim + n_shapes * n_shapes) * 2.0
        vecops = 10 * f_dim * p_dim                     # axpys/dots/prec
        lin = cg_iters * (matvec + vecops)
        lin_bytes = cg_iters * (f_dim * p_dim * p_dim + f_dim * p_dim
                                * n_shapes) * 4.0       # d_blocks + b_pw
        seq_per_iter = cg_iters
    else:                                               # tridiag / cr
        lin = 2 * f_dim * (p_dim ** 3) / 3.0 * 2.0      # block eliminations
        lin_bytes = f_dim * p_dim * p_dim * 4.0 * 3.0
        seq_per_iter = 2 * f_dim
    per_iter = (asm + lin) * 1.10                       # +10% slop
    per_iter_bytes = (f_dim * kp_rows * pq * 4.0        # Jacobian write/read
                      + lin_bytes)
    flops = n_problems * lm_iters * per_iter
    bytes_ = n_problems * lm_iters * per_iter_bytes
    seq = int(lm_iters * (1 + seq_per_iter))
    return flops, bytes_, seq


def stage_solver(name: str, n_problems: int, f_dim: int, p_dim: int,
                 n_shapes: int, kp_rows: int, lm_iters: float,
                 cg_iters: int, linear: str = "pcg") -> StageCount:
    f, b, s = _solver_counts(n_problems, f_dim, p_dim, n_shapes, kp_rows,
                             lm_iters, cg_iters, linear)
    return StageCount(name, f, b, s)


def stage_single_frame(name: str, n_problems: int, p_dim: int,
                       kp_rows: int, lm_iters: float,
                       tr_solver: str = "eigh") -> StageCount:
    """Single-frame LM (solve/lm.py): per iteration one (kp_rows+prior, P)
    J^T J + the trust-region subproblem — eigh is an iterative Jacobi
    program (~25 n^3 FLOP-equivalents, dominated by its sequential sweep
    structure rather than FLOPs), chol is tr_newton_iters + 2 Cholesky
    factorizations (n^3/3 each)."""
    rows = kp_rows + p_dim
    asm = rows * p_dim * p_dim * 2.0
    if tr_solver == "eigh":
        sub = 25.0 * p_dim ** 3                        # Jacobi sweeps
    elif tr_solver == "chol":
        sub = 8 * (p_dim ** 3) / 3.0 * 2.0
    else:                                              # dogleg
        sub = (p_dim ** 3) / 3.0 * 2.0
    per_iter = (asm + sub) * 1.10
    per_bytes = rows * p_dim * 4.0 + p_dim * p_dim * 4.0 * 4
    return StageCount(name, n_problems * lm_iters * per_iter,
                      n_problems * lm_iters * per_bytes, int(lm_iters))


def stage_lbs(name: str, batch: int, n_verts: int, n_joints: int = 24,
              n_shapes: int = 10) -> StageCount:
    """Fused blendshape + LBS (ops/lbs.py): per vertex a (3, nS) shape
    blend, a (nJ,) weighted 3x4 affine blend, and one point transform."""
    per_v = (3 * n_shapes + 12 * n_joints + 12) * 2.0
    flops = batch * n_verts * per_v
    # operands: template+shapedirs+weights read once per batch element
    bytes_ = batch * n_verts * (3 + 3 * n_shapes + n_joints) * 4.0
    return StageCount(name, flops, bytes_, 1)


def stage_raster(name: str, n_frames: int, n_faces: int, n_tiles: int,
                 max_chunks: int, chunk: int, tile_px: int,
                 bin_entries: int = 4, act_cap: int | None = None) -> StageCount:
    """Tile-binned rasterizer (the reference's render/pallas_raster.py; K3
    in render/zbuffer.py bins and draws the same work): setup +
    sort of ~bin_entries*n_faces packed keys (sort counted as c*n*log2 n
    compare-exchanges), phase-2 kernel: per executed grid step 3 edge
    FMAs for tile_px x chunk candidates."""
    import math

    n_entries = bin_entries * n_faces
    setup = n_faces * 150.0
    sort = 8.0 * n_entries * max(math.log2(max(n_entries, 2)), 1.0)
    # every ACTIVE tile pays its k=0 step (act_cap bounds them; the
    # round-4 compacted worklist schedules no inactive-tile steps);
    # only segment-covered steps do work — upper bound: all entries
    # touched once + per-tile big sweep ignored
    steps = n_entries / chunk + (act_cap if act_cap is not None else n_tiles)
    kernel = steps * (3 * 2.0 * tile_px * chunk)
    flops = n_frames * (setup + sort + kernel)
    bytes_ = n_frames * (n_entries * 13 * 4.0        # sorted edge gather
                         + n_tiles * tile_px * 4.0)  # z-buffer out
    # seq_steps mirrors the WORKLIST grid (exact n_blocks + act_cap
    # entries, rasterize_tiled); the old dense n_tiles*max_chunks grid no
    # longer exists, so max_chunks no longer enters the step count
    del max_chunks
    return StageCount(name, flops, bytes_, int(steps))


def report(stage: StageCount, seconds: float, dispatches: int = 1) -> str:
    """One human line: achieved GFLOP/s (% of the FP32 peak), GB/s (%HBM
    upper bound), per-seq-step latency, and the binding-resource verdict."""
    gflops = stage.flops / seconds / 1e9
    gbs = stage.hbm_bytes / seconds / 1e9
    pct_f32 = 100.0 * stage.flops / seconds / PEAK_F32_FLOPS
    pct_hbm = 100.0 * stage.hbm_bytes / seconds / PEAK_HBM_BPS
    step_us = seconds / max(stage.seq_steps, 1) * 1e6
    if dispatches * DISPATCH_FLOOR_S > 0.5 * seconds:
        bind = "host-dispatch latency"
    elif pct_f32 < 2.0 and pct_hbm < 10.0:
        bind = "device scheduling/latency (tiny dense blocks)"
    elif pct_hbm > pct_f32:
        bind = "HBM bandwidth"
    else:
        bind = "FP32 compute"
    return (f"roofline[{stage.name}]: {seconds * 1e3:.0f} ms, "
            f"{gflops:.1f} GFLOP/s ({pct_f32:.2f}% FP32), "
            f"<= {gbs:.1f} GB/s ({pct_hbm:.1f}% HBM), "
            f"{step_us:.0f} us/seq-step x {stage.seq_steps} -> {bind}")
