"""The twin of ``bench.py`` on the card: the headline benchmark of the port.

    python -m smpltpu_torch.bench

Workload (``bench.py``, BASELINE.md's target row: >= 100 frames/s fitted
on a 1000-frame video): keypoints synthesized for BENCH_FRAMES frames from
known smooth poses of the full-width synthetic SMPL model, then the whole
two-stage fit: stage 1, the shared-shape anchor solve (every 10th frame,
150 LM trips), the anchors interpolated into warm starts, stage 2, every
20-frame window (overlap 5, shape locked, 60 trips) solved as one batch.
With more than one visible card, stage 1 runs the frame-sharded LM and
stage 2 shards the windows over the cards (``smpltpu_torch/parallel``),
one process a card, and rank 0 prints.

Measurement boundary, as in bench.py: the timed quantity is the solves
(stage 1 + stage 2) on keypoints already in device memory. Where bench.py
times a "compile+first" call, this runs the same call once, whole and
untimed (the kernels are built and loaded, cuBLAS and the allocator warm),
so that the timed runs start from the state bench.py's do. The CLIs' warm-up
is one LM trip instead. Stage 2 and the fused fit are timed three times
each and the fastest run is kept.

Stdout gets exactly one JSON line, bench.py's:
    {"metric": "solver_throughput_frames_per_sec_1000frame_video",
     "value": N, "unit": "frames/sec", "vs_baseline": N}
with ``vs_baseline = value / 100`` (BASELINE.md's target row for a
1000-frame video). Everything else goes to stderr: the stage times, the
roofline lines (``utils/roofline.py``), the peak device memory, bench.py's
sampled residual and the full-batch residual, the kernels' launch counts
(``smpltpu_torch.ops.LAUNCHES``) and the LM trips by system shape that
imply K1's, and the JSON records of the optional modes under bench.py's
metric names.

Environment variables, all of bench.py's, with its defaults:

- Ported: BENCH_FRAMES (1000); BENCH_LINEAR (pcg: the plain PyTorch CG
  loop; pcg_kernel runs K1, ``csrc/arrow_pcg.cu``; also tridiag, cr,
  pcg_block); BENCH_CG_ITERS (40); BENCH_CG_RTOL (0); BENCH_FUSED (1, the
  fused-cost LM loop); BENCH_CHUNK (0: stage 2 as one batch; N: chunks of
  N windows); BENCH_FUSE_STAGES (1: the fused two-stage fit is the
  headline when there is no mesh and no chunk); BENCH_RENDER (0) and
  BENCH_RENDER_SCALE (0.375): the render of every frame through FK, K2
  and K3; BENCH_STREAM, BENCH_STREAM_SCAN, BENCH_STREAM_PUMP (0) and
  BENCH_STREAM_FRAMES (200): the online fit per frame, its causal replay
  and its request pump; BENCH_SINGLE (0) with BENCH_SINGLE_FRAMES (128),
  _GMM (0, 1: the quality gate, stress), _BETA (20), _MULTISTART (0), _TR
  (chol | eigh | dogleg), _TR_ITERS (0), _CHUNK (0), _ADAPTIVE (0),
  _ADAPTIVE_PX (6), _ORIENT (1) and _PROPAGATE (0).
- Accepted and inert: BENCH_CG_UNROLL (the unroll of XLA's CG loop; the
  port's loops are not compiled) and BENCH_COMPILE_CACHE (XLA's compile
  cache; the port has nothing to compile). One stderr line says so.
- Refused unless at their defaults: BENCH_RASTER_ENTRY_CAP (0),
  BENCH_RASTER_EDGES (rows) and BENCH_RENDER_AUDIT_CAP (0). They set the
  TPU rasterizer's caps and edge modes; K3 bins exactly and has no caps,
  so a run with them set would not be the run asked for.

BENCH_STREAM_PUMP has no host-callback probe: the port's pump stages each
frame through pinned memory into a CUDA graph of one LM trip, and always
runs. No kernel wrapper on these paths falls back to its plain version.

From Python, ``main(device="cpu")`` runs on the CPU (the tests do);
``main(device="cpu", mesh=m)`` runs as rank ``m.rank`` of a mesh.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu_torch.energy import make_skeleton_spec, project, skeleton_joints_cam
from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.energy.reproj import Camera
from smpltpu_torch.io.gmm import load_pose_prior_txt
from smpltpu_torch.models import SMPLModel, make_synthetic_model
from smpltpu_torch.ops import LAUNCHES
from smpltpu_torch.ops.lbs import joint_affines, lbs_torch, prepare_lbs_operands
from smpltpu_torch.parallel import (
    build_sharded_lm_fitter,
    mesh_size,
    sharded_window_fit,
)
from smpltpu_torch.parallel.launch import PACKAGE_ROOT, mesh_main
from smpltpu_torch.pipeline.common import SKIN_BATCH, render_frames
from smpltpu_torch.pipeline.multi import interpolate_from_anchors
from smpltpu_torch.render.zbuffer import face_bbox, face_setup
from smpltpu_torch.solve import (
    LMConfig,
    MultiFrameConfig,
    OnlineConfig,
    OnlinePump,
    build_chunked_window_fit,
    build_fitter,
    build_fused_two_stage,
    build_multi_fitter,
    build_online_scan,
    build_online_step,
    best_of_starts,
    fit_adaptive,
    make_single_frame_problem,
    make_start_set,
)
from smpltpu_torch.utils import default_intrinsics
from smpltpu_torch.utils.roofline import (
    StageCount,
    report,
    stage_lbs,
    stage_single_frame,
    stage_solver,
)
from smpltpu_torch.utils.writeback import params_to_pose

WSIZE, OVERLAP, SKIP = 20, 5, 10
S1_ITERS, S2_ITERS = 150, 60
N_SHAPES = 10
TARGET_FPS = 100.0   # BASELINE.md's target row: >= 100 frames/s, 1000 frames
METRIC = "solver_throughput_frames_per_sec_1000frame_video"
PRIOR_PATH = os.path.join(PACKAGE_ROOT, "data", "avatar-model",
                          "pose_prior.txt")
INERT = ("BENCH_CG_UNROLL", "BENCH_COMPILE_CACHE")
# the TPU rasterizer's knobs, refused unless at these defaults
REFUSED = {"BENCH_RASTER_ENTRY_CAP": "0", "BENCH_RASTER_EDGES": "rows",
           "BENCH_RENDER_AUDIT_CAP": "0"}


class BenchEnv(NamedTuple):
    """bench.py's environment, parsed (``read_env``)."""

    frames: int = 1000
    linear: str = "pcg"
    cg_iters: int = 40
    cg_rtol: float = 0.0
    fused: bool = True
    chunk: int = 0
    fuse_stages: bool = True
    render: bool = False
    render_scale: float = 0.375
    stream: bool = False
    stream_scan: bool = False
    stream_pump: bool = False
    stream_frames: int = 200
    single: bool = False
    single_frames: int = 128
    single_gmm: str = "0"
    single_beta: float = 20.0
    single_multistart: bool = False
    single_tr: str = ""
    single_tr_iters: int = 0
    single_chunk: int = 0
    single_adaptive: bool = False
    single_adaptive_px: float = 6.0
    single_orient: bool = True
    single_propagate: bool = False


def read_env(environ) -> BenchEnv:
    """bench.py's BENCH_* variables from ``environ``, with its defaults
    and its parsing (a flag is on when it is "1"). Raises ValueError for a
    refused variable that is not at its default."""
    for name, default in REFUSED.items():
        if environ.get(name, default) != default:
            raise ValueError(
                f"{name}={environ[name]!r} is not ported: it tunes the TPU "
                "rasterizer's caps and edge modes, which ROADMAP.md lists "
                "under 'Do not port'; K3 bins exactly and has no caps. "
                f"Unset it (default {default!r}).")

    def get(name, default):
        return environ.get(f"BENCH_{name}", default)

    def flag(name, default="0"):
        return get(name, default) == "1"
    return BenchEnv(
        frames=int(get("FRAMES", "1000")),
        linear=get("LINEAR", "pcg"),
        cg_iters=int(get("CG_ITERS", "40")),
        cg_rtol=float(get("CG_RTOL", "0")),
        fused=flag("FUSED", "1"),
        chunk=int(get("CHUNK", "0")),
        fuse_stages=flag("FUSE_STAGES", "1"),
        render=flag("RENDER"),
        render_scale=float(get("RENDER_SCALE", "0.375")),
        stream=flag("STREAM"),
        stream_scan=flag("STREAM_SCAN"),
        stream_pump=flag("STREAM_PUMP"),
        stream_frames=int(get("STREAM_FRAMES", "200")),
        single=flag("SINGLE"),
        single_frames=int(get("SINGLE_FRAMES", "128")),
        single_gmm=get("SINGLE_GMM", "0"),
        single_beta=float(get("SINGLE_BETA", "20")),
        single_multistart=flag("SINGLE_MULTISTART"),
        single_tr=get("SINGLE_TR", ""),
        single_tr_iters=int(get("SINGLE_TR_ITERS", "0")),
        single_chunk=int(get("SINGLE_CHUNK", "0")),
        single_adaptive=flag("SINGLE_ADAPTIVE"),
        single_adaptive_px=float(get("SINGLE_ADAPTIVE_PX", "6")),
        single_orient=flag("SINGLE_ORIENT", "1"),
        single_propagate=flag("SINGLE_PROPAGATE"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@functools.lru_cache(maxsize=None)
def synthetic_model(n_verts=None):
    """bench.py's synthetic SMPL model (seeded), made once per width: its
    host construction takes seconds."""
    return make_synthetic_model(**({} if n_verts is None
                                   else {"n_verts": n_verts}))


def workload(device, n_frames=1000, n_verts=None, *, dtype=torch.float32,
             kp=None):
    """bench.py's synthetic video (bench.py:85-132): smooth ground-truth
    motion, folded past frame 1000 so that the frame count scales the
    video's length and not its motion; projected keypoints with 1 px noise
    from numpy's default_rng(0); the full-width synthetic model (or
    ``n_verts`` vertices); the 720 x 1280 camera; the anchors and the
    window batch. ``kp``: keypoints to take instead of the synthesized
    ones (the tests hand in the reference's).

    -> dict: model, model_dict, cam, spec, r0c, kp (F, K, 4) numpy,
    starts, anchor_idx, kpw (W, WSIZE, K, 4) and vw (W, WSIZE) numpy,
    n_frames, use_smpl, and ``args``: the seven tensors that
    ``build_fused_two_stage``'s run takes (anchor inits, shape, anchor
    keypoints, anchor R0, window keypoints, window R0, window validity);
    stage 1 takes the first four."""
    model_dict = synthetic_model(n_verts)
    model = SMPLModel.from_dict(model_dict, device=device, dtype=dtype)
    cam = default_intrinsics(720, 1280, device=device, dtype=dtype)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    r0c = np.asarray(init_root_rotation(), np.float32)

    if kp is None:
        rng = np.random.default_rng(0)
        base = rng.normal(size=(23, 3)) * 0.15
        drift = rng.normal(size=(23, 3)) * 0.003
        fidx = np.arange(n_frames, dtype=np.float32)
        ph = 1000.0 - np.abs(np.mod(fidx, 2000.0) - 1000.0)
        gt = np.zeros((n_frames, 76), np.float32)
        gt[:, 0] = 1.0                       # scale
        gt[:, 1] = 2e-3 * ph                 # root_aa
        gt[:, 2] = 1e-3 * ph
        gt[:, 4] = 0.1 + 1e-3 * ph           # root_t
        gt[:, 5] = -0.1
        gt[:, 6] = 3.2
        gt[:, 7:] = (base[None] + ph[:, None, None] * drift[None]
                     ).reshape(n_frames, 69).astype(np.float32)
        uv = project(skeleton_joints_cam(
            torch.as_tensor(gt, device=device, dtype=dtype),
            torch.zeros(N_SHAPES, device=device, dtype=dtype), spec),
            cam).cpu().numpy()
        kp = np.zeros((n_frames, N_KP_SLOTS, 4), np.float32)
        kp[:, :, 0] = USE_SMPL
        kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(
            size=(n_frames, N_KP_SLOTS, 2)).astype(np.float32)
        kp[:, :, 3] = 1.0
    kp = np.asarray(kp, np.float32)

    stride = WSIZE - OVERLAP
    starts = list(range(0, n_frames, stride))
    kpw = np.zeros((len(starts), WSIZE, N_KP_SLOTS, 4), np.float32)
    kpw[:, :, :, 0] = USE_SMPL
    vw = np.zeros((len(starts), WSIZE), np.float32)
    for i, s in enumerate(starts):
        e = min(s + WSIZE, n_frames)
        kpw[i, :e - s] = kp[s:e]
        vw[i, :e - s] = 1.0
    anchor_idx = np.arange(0, n_frames, SKIP)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)
    n_a = len(anchor_idx)
    args = (init_frame_params(device=device, dtype=dtype).repeat(n_a, 1),
            torch.zeros(N_SHAPES, device=device, dtype=dtype),
            t(kp[anchor_idx]), t(np.tile(r0c, (n_a, 1, 1))), t(kpw),
            t(np.tile(r0c, (len(starts), WSIZE, 1, 1))), t(vw))
    return {"model": model, "model_dict": model_dict, "cam": cam,
            "spec": spec, "r0c": r0c, "kp": kp, "starts": starts,
            "anchor_idx": anchor_idx, "kpw": kpw, "vw": vw, "args": args,
            "n_frames": n_frames, "use_smpl": USE_SMPL}


def stage_configs(linear="pcg", cg_iters=40, cg_rtol=0.0, fused=True,
                  s1_iters=S1_ITERS, s2_iters=S2_ITERS):
    """bench.py's two stage configs (bench.py:169-172, :216-219): stage 1
    with the shape prior 25, stage 2 with the shape locked (1e5)."""
    common = dict(beta_pose=5.0, lambda_temporal=3.0, linear=linear,
                  cg_iters=cg_iters, cg_rtol=cg_rtol, fused_cost=fused)
    return (MultiFrameConfig(beta_shape=25.0, max_iters=s1_iters, **common),
            MultiFrameConfig(beta_shape=1e5, max_iters=s2_iters, **common))


def build_stage1(w, cfg1, mesh=None, *, dtype=torch.float32):
    """Stage 1 (bench.py:173-194): -> (fit, args). Without a mesh,
    ``build_multi_fitter`` on the anchors; with one, the frame-sharded LM
    with the anchors padded to a multiple of the ranks (frame_valid 0,
    masked keypoints)."""
    n_a = len(w["anchor_idx"])
    if mesh is None:
        fit = build_multi_fitter(w["spec"], w["cam"], cfg1, N_SHAPES,
                                 device=w["cam"].fx.device, dtype=dtype)
        return fit, w["args"][:4]
    dev = mesh.device
    pad = (-n_a) % mesh.size
    a_p = np.tile(init_frame_params(device="cpu", dtype=torch.float32
                                    ).numpy(), (n_a + pad, 1))
    a_k = np.zeros((n_a + pad,) + w["kp"].shape[1:], np.float32)
    a_k[:n_a] = w["kp"][w["anchor_idx"]]
    a_r = np.tile(np.eye(3, dtype=np.float32), (n_a + pad, 1, 1))
    a_r[:n_a] = w["r0c"]
    a_v = np.zeros(n_a + pad, np.float32)
    a_v[:n_a] = 1.0

    def t(a):
        return torch.as_tensor(a, device=dev).to(dtype)
    fit = build_sharded_lm_fitter(mesh, w["spec"], w["cam"], cfg1, N_SHAPES,
                                  dtype=dtype)
    return fit, (t(a_p), torch.zeros(N_SHAPES, device=dev, dtype=dtype),
                 t(a_k), t(a_r), t(a_v))


def stage2_inputs(w, poses, shape, n_ranks=1, *, dtype=torch.float32):
    """Stage 2's batch (bench.py:222-236): each window's frames from the
    interpolated ``poses``, the rest and the dummy windows that pad the
    batch to a multiple of ``n_ranks`` at the blind init; ``shape`` (nS,)
    for every window. -> (params0, shape0, kp, r0, frame_valid), tensors
    on shape's device."""
    starts, n = w["starts"], w["n_frames"]
    n_win = len(starts)
    n_batch = n_win + (-n_win) % n_ranks
    p0 = np.tile(init_frame_params(device="cpu", dtype=torch.float32
                                   ).numpy().astype(poses.dtype),
                 (n_batch, WSIZE, 1))
    for i, s in enumerate(starts):
        e = min(s + WSIZE, n)
        p0[i, :e - s] = poses[s:e]
    kpw_b = np.zeros((n_batch,) + w["kpw"].shape[1:], np.float32)
    kpw_b[:n_win] = w["kpw"]
    vw_b = np.zeros((n_batch, WSIZE), np.float32)
    vw_b[:n_win] = w["vw"]
    dev = shape.device

    def t(a):
        return torch.as_tensor(a, device=dev).to(dtype)
    return (t(p0), shape.to(dtype).expand(n_batch, -1).contiguous(),
            t(kpw_b), t(np.tile(w["r0c"], (n_batch, WSIZE, 1, 1))), t(vw_b))


def build_stage2(w, cfg2, chunk=0, mesh=None, *, dtype=torch.float32):
    """Stage 2 (bench.py:220, :238-245): the batched fitter on all
    windows; chunks of ``chunk`` windows (``build_chunked_window_fit``);
    or, with a mesh, window data parallelism with ``chunk=`` in each
    rank."""
    dev = w["cam"].fx.device if mesh is None else mesh.device
    fit = build_multi_fitter(w["spec"], w["cam"], cfg2, N_SHAPES, device=dev,
                             dtype=dtype)
    if mesh is not None:
        return lambda *a: sharded_window_fit(mesh, fit, *a, chunk=chunk)
    if chunk > 0:
        return build_chunked_window_fit(fit, chunk)
    return fit


def window_trips(iters_run, chunk=0) -> dict:
    """LM loop trips by K1 system shape ("WxF") of a window batch whose
    windows ran ``iters_run`` trips each: solved as one batch, or in
    chunks of ``chunk`` windows; a batch runs until its slowest window
    stops, one K1 launch a trip under ``linear="pcg_kernel"``."""
    its = np.asarray(iters_run).reshape(-1)
    step = chunk if chunk > 0 else len(its)
    out: dict = {}
    for s in range(0, len(its), step):
        part = its[s:s + step]
        key = f"{len(part)}x{WSIZE}"
        out[key] = out.get(key, 0) + int(part.max())
    return out


def write_back(w, st2):
    """Per-frame params: the first `stride` frames of each window, the
    whole tail of the last one (bench.py:366-373); the shape of window 0.
    -> (frame_params (F, P), shape (nS,)) tensors."""
    n = w["n_frames"]
    stride = WSIZE - OVERLAP
    fp = torch.zeros((n, st2.params.shape[-1]), dtype=st2.params.dtype,
                     device=st2.params.device)
    for i, s in enumerate(w["starts"]):
        e = min(s + WSIZE, n)
        take = (e - s) if i == len(w["starts"]) - 1 else min(stride, e - s)
        fp[s:s + take] = st2.params[i, :take]
    return fp, st2.shape[0]


def sampled_residual(w, params, shape) -> float:
    """bench.py's residual (bench.py:329-343), its estimator as it is:
    every (n_win // 8)-th window, every 5th of its frames, the mean over
    the 17 slots of the keypoint distance in pixels, each window under its
    own shape ``shape[i]``. params (W, WSIZE, P), shape (W, nS)."""
    starts, n = w["starts"], w["n_frames"]
    n_win = len(starts)
    errs = []
    for i in range(0, n_win, max(1, n_win // 8)):
        s = starts[i]
        e = min(s + WSIZE, n)
        uvs = project(skeleton_joints_cam(
            params[i][:e - s], shape[i][None].expand(e - s, -1), w["spec"]),
            w["cam"]).cpu().numpy()
        for k in range(0, e - s, 5):
            errs.append(np.linalg.norm(
                uvs[k][USE_SMPL] - w["kp"][s + k, :, 1:3], axis=-1).mean())
    return float(np.mean(errs))


def full_batch_residual(w, frame_params, shp, frames=None) -> float:
    """Mean keypoint reprojection error in pixels over all frames and
    slots, under the solver's skeleton model (the estimator bench.py
    samples); ``frames``: the video's frames that ``frame_params`` holds
    (the anchors), if not all."""
    uv = project(skeleton_joints_cam(frame_params, shp, w["spec"]), w["cam"])
    kp = torch.as_tensor(w["kp"] if frames is None else w["kp"][frames],
                         device=uv.device)
    d = torch.linalg.norm(uv[:, w["use_smpl"]] - kp[:, :, 1:3], dim=-1)
    return float(d.mean())


def single_problem(w, dtype, gmm=None, beta_pose=20.0, beta_shape=30.0):
    """bench.py's single-frame problem (bench.py:670-675) on the
    workload's model and camera, cast to ``dtype``."""
    import copy
    model, cam = w["model"], w["cam"]
    if dtype != model.v_template.dtype:
        model = copy.deepcopy(model).to(dtype)
        cam = type(cam)(*(c.to(dtype) for c in cam))
    return make_single_frame_problem(model, w["r0c"], cam,
                                     beta_pose=beta_pose,
                                     beta_shape=beta_shape, gmm_dict=gmm)


def single_px(prob, x, kp) -> float:
    """bench.py's single-frame residual (bench.py:774-779, :805-813): the
    mean keypoint distance over every frame and slot, zero shape."""
    x = torch.as_tensor(np.asarray(x)).to(device=prob.spec.r0.device,
                                          dtype=prob.spec.r0.dtype)
    uv = project(skeleton_joints_cam(x, x.new_zeros(prob.n_shapes),
                                     prob.spec), prob.cam).cpu().numpy()
    return float(np.linalg.norm(uv[:, USE_SMPL] - kp[:, :, 1:3],
                                axis=-1).mean())


def gmm_gate_keypoints(w, gmm_d, n_s):
    """bench.py's GMM quality-gate workload (bench.py:686-708): ground
    truth near the prior's dominant component (numpy default_rng(11)),
    projected with 1 px noise."""
    rng_g = np.random.default_rng(11)
    c_kg = (-np.log(np.asarray(gmm_d["weights"]))
            + 0.5 * np.asarray(gmm_d["logdet_cov"]))
    top_g = int(np.argmin(c_kg))
    ell_g = np.linalg.cholesky(np.asarray(gmm_d["covs"], np.float64))[top_g]
    aa_g = (np.asarray(gmm_d["means"], np.float64)[top_g]
            + 0.3 * (ell_g @ rng_g.normal(size=(ell_g.shape[-1], n_s))).T)
    gt_g = np.zeros((n_s, 76), np.float32)
    gt_g[:, 0] = 1.0
    gt_g[:, 4:6] = rng_g.normal(size=(n_s, 2)) * 0.1
    gt_g[:, 6] = 3.2
    gt_g[:, 7:] = aa_g.astype(np.float32)
    dev, dt = w["cam"].fx.device, w["cam"].fx.dtype
    uv_g = project(skeleton_joints_cam(
        torch.as_tensor(gt_g, device=dev, dtype=dt),
        torch.zeros(N_SHAPES, device=dev, dtype=dt), w["spec"]),
        w["cam"]).cpu().numpy()
    kp_s = np.zeros((n_s, N_KP_SLOTS, 4), np.float32)
    kp_s[:, :, 0] = USE_SMPL
    kp_s[:, :, 1:3] = uv_g[:, USE_SMPL] + rng_g.normal(
        size=(n_s, N_KP_SLOTS, 2)).astype(np.float32)
    kp_s[:, :, 3] = 1.0
    return kp_s


def _timed(fn, device):
    """(fn(), wall seconds), the device synchronized after."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _ms_list(ts):
    return [f"{t * 1e3:.0f}ms" for t in ts]


def _latency_line(label, n, lat_ms):
    return (f"bench: {label} {n} frames: latency mean {lat_ms.mean():.1f} ms,"
            f" p50 {np.percentile(lat_ms, 50):.1f} ms, p95 "
            f"{np.percentile(lat_ms, 95):.1f} ms -> "
            f"{1e3 / max(lat_ms.mean(), 1e-9):.0f} frames/s sustained")


def run(env: BenchEnv, device, mesh=None) -> int:
    """bench.py's main (bench.py:60-857) on ``device`` in float32, as
    ``mesh``'s rank when one is given; rank 0 writes the logs and the
    stdout line."""
    dtype = torch.float32
    dev = torch.device(device)
    rank = 0 if mesh is None else mesh.rank
    say = log if rank == 0 else (lambda *a: None)
    n_frames = env.frames
    LAUNCHES.clear()
    trips: Counter = Counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
    else:
        names = ["cpu"]
    say(f"bench: devices = {names} -> mesh size "
        f"{1 if mesh is None else mesh.size}")
    present = [v for v in INERT if v in os.environ]
    if present:
        say(f"bench: {', '.join(present)} accepted and inert: they set XLA's "
            "CG unroll and compile cache; the port compiles nothing")

    w = workload(dev, n_frames, dtype=dtype)
    n_a, n_win = len(w["anchor_idx"]), len(w["starts"])
    if env.chunk > 0 and mesh is not None:
        say(f"bench: BENCH_CHUNK={env.chunk} under a {mesh.size}-rank mesh: "
            "each rank fits its windows in chunks of that many, each chunk "
            "with its own convergence exit")
    if env.chunk > 0 and env.cg_rtol > 0:
        say("bench: BENCH_CHUNK with BENCH_CG_RTOL>0: the port's CG exits "
            "on each window's own residual, so chunks and one batch solve "
            "the same steps (build_chunked_window_fit)")
    cfg1, cfg2 = stage_configs(env.linear, env.cg_iters, env.cg_rtol,
                               env.fused)

    # the LM trips of each run by K1 system shape: K1's launches under
    # linear="pcg_kernel", one a trip
    def tally_stage1(st):
        if mesh is None:    # the sharded LM runs its own CG, no K1
            trips[f"1x{n_a}"] += int(st.iters_run)

    def tally_windows(st):
        its = st.iters_run.cpu().numpy().reshape(-1)
        if mesh is not None:    # this rank's block of windows
            k = len(its) // mesh.size
            its = its[mesh.rank * k:(mesh.rank + 1) * k]
        trips.update(window_trips(its, env.chunk))

    # ---- stage 1: the shared-shape anchor solve (every 10th frame) ----
    fit1, args1 = build_stage1(w, cfg1, mesh, dtype=dtype)
    say(f"bench: stage-1 {n_a} anchors x {S1_ITERS} iters "
        f"({'sharded LM' if mesh is not None else 'single-device'}); "
        "first run...")
    st1, first_s = _timed(lambda: fit1(*args1), dev)
    tally_stage1(st1)
    say(f"bench: stage-1 first run {first_s:.1f}s")
    st1, dt1 = _timed(lambda: fit1(*args1), dev)
    tally_stage1(st1)

    # ---- stage 2: all windows, shape locked ----
    # bench.py's host interpolation (:205-213), by the multi CLI's loop
    anchor_params = st1.params[:n_a].cpu().numpy()
    poses = np.zeros((n_frames, anchor_params.shape[1]), anchor_params.dtype)
    interpolate_from_anchors(poses, w["anchor_idx"], anchor_params)
    n_ranks = 1 if mesh is None else mesh.size
    args2 = stage2_inputs(w, poses, st1.shape, n_ranks, dtype=dtype)
    bfit = build_stage2(w, cfg2, env.chunk, mesh, dtype=dtype)
    pad_w = len(args2[0]) - n_win
    say(f"bench: {n_win} windows (+{pad_w} pad) x {WSIZE} frames x "
        f"{S2_ITERS} LM iters on {n_ranks} device(s)"
        + (f", chunked x{env.chunk}" if env.chunk > 0 else "")
        + "; first run...")
    st, first_s = _timed(lambda: bfit(*args2), dev)
    tally_windows(st)
    say(f"bench: stage-2 first run {first_s:.1f}s")
    times = []
    for _ in range(3):
        st, t = _timed(lambda: bfit(*args2), dev)
        tally_windows(st)
        times.append(t)
    dt = dt1 + min(times)    # the whole pipeline: stage 1 + all windows
    fps = n_frames / dt
    say(f"bench: stage-1 {dt1 * 1e3:.0f} ms + stage-2 {min(times) * 1e3:.0f}"
        f" ms -> {fps:.0f} frames/s end-to-end; stage-2 runs: "
        f"{_ms_list(times)}")

    # the fused two-stage fit (solve/two_stage.py): stage 1, the anchor
    # interpolation on the device, stage 2, in one call; the headline for
    # one device without chunks, as in bench.py (:268-303)
    if mesh is None and env.chunk == 0 and env.fuse_stages:
        fused_fit = build_fused_two_stage(
            w["spec"], w["cam"], cfg1, cfg2, N_SHAPES, w["anchor_idx"],
            w["starts"], WSIZE, n_frames, device=dev, dtype=dtype)
        times_f = []
        for k in range(4):
            (f1, f2), t = _timed(lambda: fused_fit(*w["args"]), dev)
            tally_stage1(f1)
            tally_windows(f2)
            if k == 0:
                say(f"bench: fused two-stage first run {t:.1f}s")
            else:
                times_f.append(t)
        fps_f = n_frames / min(times_f)
        say(f"bench: fused two-stage pipeline {min(times_f) * 1e3:.0f} ms -> "
            f"{fps_f:.0f} frames/s (sequential: {fps:.0f}) — the headline; "
            f"runs: {_ms_list(times_f)}")
        say(json.dumps({"metric": "fused_two_stage_frames_per_sec",
                        "value": round(fps_f, 1), "unit": "frames/sec",
                        "sequential_fps": round(fps, 1)}))
        fps = fps_f
        st = f2   # the residual and the render reflect the headline's fit

    if dev.type == "cuda":
        gib = 2 ** 30
        say(f"bench: device memory peak "
            f"{torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB (in use "
            f"{torch.cuda.memory_allocated(dev) / gib:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved(dev) / gib:.2f} GiB)")

    # roofline accounting (utils/roofline.py), from the measured trips
    p_dim = int(args2[0].shape[-1])
    kp_rows = 2 * N_KP_SLOTS
    it1 = float(np.mean(st1.iters_run.cpu().numpy()))
    it2 = float(np.mean(st.iters_run.cpu().numpy().reshape(-1)[:n_win]))
    say("bench: " + report(stage_solver(
        "stage1", 1, n_a, p_dim, N_SHAPES, kp_rows, it1, env.cg_iters,
        env.linear), dt1))
    say("bench: " + report(stage_solver(
        "stage2", n_win, WSIZE, p_dim, N_SHAPES, kp_rows, it2, env.cg_iters,
        env.linear), min(times)))

    px = sampled_residual(w, st.params, st.shape)
    say(f"bench: residual pixel error {px:.4f}px (obs noise 1.4px)")
    frame_params, shp = write_back(w, st)
    px_full = full_batch_residual(w, frame_params, shp)
    say(f"bench: full-batch residual pixel error {px_full:.4f}px "
        f"({n_frames} frames x {N_KP_SLOTS} slots)")

    if env.render and rank == 0:
        render_pass(w, frame_params, shp, env.render_scale, dt, dev)
    if (env.stream or env.stream_scan or env.stream_pump) and rank == 0:
        stream_pass(w, env, st1.shape, dev, dtype)
    if env.single and rank == 0:
        single_pass(w, env, kp_rows, dev, dtype)

    say(f"bench: LM trips by system shape {json.dumps(trips, sort_keys=True)}")
    say(f"bench: kernel launches {json.dumps(dict(LAUNCHES), sort_keys=True)}")
    if rank == 0:
        print(json.dumps({"metric": METRIC, "value": round(fps, 1),
                          "unit": "frames/sec",
                          "vs_baseline": round(fps / TARGET_FPS, 3)}),
              flush=True)
    return 0


def render_pass(w, frame_params, shp, scale, solve_s, dev):
    """bench.py's BENCH_RENDER (bench.py:345-511): every frame skinned and
    rasterized on the device, ``render_frames`` (FK, K2, then K3, a chunk
    of 100 frames at a time) at ``scale`` of the 720 x 1280 camera. One
    untimed chunk first, then all frames timed."""
    model = w["model"]
    n = w["n_frames"]
    w_r, h_r = int(720 * scale), int(1280 * scale)
    cam_r = Camera(*(float(c) * scale for c in w["cam"]))
    _, first_s = _timed(lambda: render_frames(
        model, frame_params[:SKIN_BATCH], shp, w["r0c"], cam_r, h_r, w_r), dev)
    log(f"bench: render first chunk {first_s:.1f}s")
    (gray, covered), dtr = _timed(lambda: render_frames(
        model, frame_params, shp, w["r0c"], cam_r, h_r, w_r), dev)
    drawn = int(sum(int(covered[s:s + SKIN_BATCH].flatten(1).any(1).sum())
                    for s in range(0, n, SKIN_BATCH)))
    log(f"bench: render {n} frames at {w_r}x{h_r} in {dtr * 1e3:.0f} ms "
        f"({n / dtr:.0f} frames/s raster, {drawn} frames drawn) -> "
        f"solve+render end-to-end {n / (solve_s + dtr):.0f} frames/s")
    n_chunks = -(-n // SKIN_BATCH)
    log("bench: " + report(stage_lbs("lbs", n, int(model.num_verts)), dtr))
    log("bench: " + report(raster_count(model, frame_params, shp, w["r0c"],
                                        cam_r, h_r, w_r), dtr,
                           dispatches=n_chunks))
    del gray, covered


def raster_count(model, frame_params, shp, r0, cam, height, width):
    """K3's work in ``render_frames`` on these frames (bench.py's raster
    roofline line, bench.py:503-511, counted for K3 and not for the TPU
    kernel's tiles), as chip_smoke.py's ``k3_bounds`` counts it: 12 float32
    operations (3 edge functions, 2 products and 2 sums each) for every
    pixel of every kept face's bounding box clipped to the frame
    (``face_bbox``), which is what K3 walks, and ~150 a face for its setup;
    bytes: each chunk's vertices and the faces read once, gray and covered
    written once. The vertices are skinned again by the plain LBS, untimed
    and not a K2 launch. -> StageCount, one sequential step a chunk."""
    dev, dt = model.v_template.device, model.v_template.dtype
    ops = prepare_lbs_operands(model)
    faces = torch.as_tensor(model.faces, device=dev)
    intr = [float(c) for c in cam]
    r0 = torch.as_tensor(np.asarray(r0), device=dev, dtype=dt)
    n, n_faces = frame_params.shape[0], int(faces.shape[0])
    box_px, n_chunks = 0, 0
    for s in range(0, n, SKIN_BATCH):
        e = min(s + SKIN_BATCH, n)
        pose = params_to_pose(frame_params[s:e], r0.expand(e - s, 3, 3),
                              model.num_joints)
        sh = shp.expand(e - s, -1).contiguous()
        g_aff, _ = joint_affines(model, sh, pose.rotations, pose.root_pos)
        verts = lbs_torch(sh, g_aff, ops).transpose(1, 2)
        bb = face_bbox(face_setup(verts, faces, *intr), height, width).long()
        box_px += int((bb[..., 2] * bb[..., 3]).sum())
        n_chunks += 1
    flops = 12.0 * box_px + 150.0 * n * n_faces
    bytes_ = (4.0 * n * int(model.num_verts) * 3 + n_chunks * 12.0 * n_faces
              + 2.0 * n * height * width)
    return StageCount("raster", flops, bytes_, n_chunks)


def stream_pass(w, env, shp0, dev, dtype):
    """bench.py's BENCH_STREAM, _SCAN and _PUMP (bench.py:513-631) on
    ``solve/online.py``, by the stream CLI's routes
    (``pipeline/stream.py``): the eager per-frame step, the causal replay
    on the CUDA graph of one LM trip, and the request pump on it (no
    probe: the pump has no host callback). -> {route: (frames, P) numpy}
    of each route run ("stream", "scan", "pump"), its fit of every frame
    in the timed pass."""
    model, spec, cam, kp = w["model"], w["spec"], w["cam"], w["kp"]
    fits = {}
    ocfg = OnlineConfig(beta_pose=5.0, lambda_temporal=3.0, max_iters=20)
    n_st = min(w["n_frames"], env.stream_frames)
    x0 = init_frame_params(device=dev, dtype=dtype)
    if env.stream:
        ostep = build_online_step(spec, cam, ocfg, model.num_joints,
                                  device=dev, dtype=dtype)
        kp_j = torch.as_tensor(kp[:n_st], device=dev).to(dtype)
        zero = torch.zeros(1, device=dev, dtype=dtype)
        _, first_s = _timed(lambda: ostep(x0[None], shp0, kp_j[:1],
                                          x0[None], zero), dev)
        log(f"bench: stream step first run {first_s:.1f}s")
        x_prev, has_prev = x0[None], zero
        lat, xs = [], []
        for i in range(n_st):
            r, t = _timed(lambda: ostep(x_prev, shp0, kp_j[i:i + 1], x_prev,
                                        has_prev), dev)
            lat.append(t)
            xs.append(r.x[0])
            x_prev, has_prev = r.x, torch.ones_like(zero)
        fits["stream"] = torch.stack(xs).cpu().numpy()
        log(_latency_line("stream", n_st, np.asarray(lat) * 1e3))
    if env.stream_scan:
        oscan = build_online_scan(spec, cam, ocfg, model.num_joints,
                                  device=dev, dtype=dtype)
        kp_j = torch.as_tensor(kp[:n_st], device=dev).to(dtype)
        _, first_s = _timed(lambda: oscan(x0, shp0, kp_j, 0.0), dev)
        log(f"bench: stream-scan first run {first_s:.1f}s")
        out, dts = _timed(lambda: oscan(x0, shp0, kp_j, 0.0), dev)
        fits["scan"] = out[0].cpu().numpy()
        log(f"bench: stream-scan {n_st} frames in {dts * 1e3:.0f} ms -> "
            f"{dts * 1e3 / n_st:.2f} ms/frame amortized, "
            f"{n_st / dts:.0f} frames/s causal")
    if env.stream_pump:
        pump = OnlinePump(spec, cam, ocfg, model.num_joints, kp.shape[1],
                          device=dev, dtype=dtype)
        # one sacrificial frame, then a restart: the measured latencies
        # are steady ones (the stream CLI's --pump route)
        t0 = time.perf_counter()
        pump.start(x0, shp0, 0.0)
        pump.submit(kp[0])
        pump.stop()
        log(f"bench: stream-pump first round trip "
            f"{time.perf_counter() - t0:.1f}s")
        pump.start(x0, shp0, 0.0)
        lat_p, xs = [], []
        for i in range(n_st):
            t0 = time.perf_counter()
            xs.append(pump.submit(kp[i])[0])
            lat_p.append(time.perf_counter() - t0)
        pump.stop()
        fits["pump"] = np.stack(xs)
        lat_ms = np.asarray(lat_p) * 1e3
        log(_latency_line("stream-pump", n_st, lat_ms))
        log(json.dumps({
            "metric": "stream_pump_latency_ms",
            "value": round(float(np.percentile(lat_ms, 50)), 2),
            "unit": "ms p50",
            "p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
            "mean_ms": round(float(lat_ms.mean()), 2)}))
    return fits


def single_pass(w, env, kp_rows, dev, dtype):
    """bench.py's BENCH_SINGLE (bench.py:633-850): the first frames of the
    video, each one LM problem (the single CLI's defaults: 100 trips,
    beta_pose 20, beta_shape 30, the exact trust region by Cholesky), one
    batch; the GMM prior, the quality gate, multi-start and the adaptive
    start as bench.py's sub-modes select. -> the residuals it printed, in
    px: {"single": the batch's, "no_gmm": the gate's fit without the GMM,
    "adaptive": the adaptive start's}, each where its mode ran."""
    n_s = min(w["n_frames"], env.single_frames)
    px = {}
    gmm_mode = env.single_gmm
    gmm_d = (load_pose_prior_txt(PRIOR_PATH) if gmm_mode in ("1", "stress")
             else None)
    gate = gmm_d is not None and gmm_mode == "1"
    prob_s = single_problem(w, dtype, gmm=gmm_d, beta_pose=env.single_beta)
    kp_s = w["kp"][:n_s]
    if gate:
        kp_s = gmm_gate_keypoints(w, gmm_d, n_s)
        log("bench: single-frame GMM quality-gate workload (GT near the "
            "prior's dominant mode, prior-seeded multi-start; "
            "BENCH_SINGLE_GMM=stress for the prior-vs-data speed variant)")
    if env.single_multistart or gate:
        starts = make_start_set(kp_s, prob_s.spec, prob_s.cam,
                                pose_seeds=(np.asarray(gmm_d["means"])
                                            if gate else None))
        s_dim = starts.shape[1]
        x0_s = torch.as_tensor(starts.reshape(n_s * s_dim, -1),
                               device=dev).to(dtype)
        kp_fit = np.repeat(kp_s, s_dim, axis=0)
    else:
        s_dim = 1
        x0_s = init_frame_params(device=dev, dtype=dtype).repeat(n_s, 1)
        kp_fit = kp_s
    tr, tr_it = env.single_tr, env.single_tr_iters
    lmcfg = None
    if tr or tr_it:
        # the shipped solver (chol) unless named, so that _TR_ITERS alone
        # sweeps chol's trip cap
        lmcfg = LMConfig(max_iters=100, huber_delta=3.0,
                         tr_solver=tr or "chol",
                         **({"tr_newton_iters": tr_it} if tr_it else {}))
    chunk_s = env.single_chunk
    fitter_s = build_fitter(prob_s, 100, device=dev, dtype=dtype,
                            lm_cfg=lmcfg, chunk=chunk_s)

    if env.single_adaptive:
        a_px = env.single_adaptive_px
        a_orient, a_prop = env.single_orient, env.single_propagate

        def adaptive():
            return fit_adaptive(prob_s, kp_s, 100, px_thresh=a_px,
                                fitter=fitter_s, dtype=dtype,
                                orient=a_orient, propagate=a_prop)
        res_a, first_s = _timed(adaptive, dev)
        log(f"bench: single-adaptive first run {first_s:.1f}s ({n_s} "
            f"frames, {res_a.hard_idx.size} hard @ >{a_px}px, "
            f"orient={'on' if a_orient else 'off'}, "
            f"propagate={'on' if a_prop else 'off'})")
        ts_a = []
        for _ in range(3):
            res_a, t = _timed(adaptive, dev)
            ts_a.append(t)
        fps_a = n_s / min(ts_a)
        px_a = px["adaptive"] = single_px(prob_s, res_a.x, kp_s)
        log(f"bench: single-adaptive {n_s} frames in {min(ts_a) * 1e3:.0f} ms"
            f" -> {fps_a:.0f} frames/s, residual {px_a:.2f}px "
            f"({res_a.hard_idx.size} hard, {int(res_a.escalated.sum())} "
            f"improved); runs: {_ms_list(ts_a)}")
        log(json.dumps({
            "metric": "single_frame_adaptive_throughput_frames_per_sec",
            "value": round(fps_a, 1), "unit": "frames/sec",
            "residual_px": round(px_a, 2),
            "hard_frames": int(res_a.hard_idx.size), "px_thresh": a_px,
            "orient": a_orient, "propagate": a_prop}))

    _, first_s = _timed(lambda: fitter_s(x0_s, kp_fit), dev)
    log(f"bench: single-frame first run {first_s:.1f}s ({n_s} frames x "
        f"{s_dim} starts x 100 iters, "
        f"gmm={'on' if gmm_d is not None else 'off'}, "
        f"tr={tr or 'default'})")
    ts = []
    for _ in range(3):
        st_s, t = _timed(lambda: fitter_s(x0_s, kp_fit), dev)
        ts.append(t)
    fps_s = n_s / min(ts)
    # the residual of each frame's lowest-cost start (bench.py:801-806)
    px_s = px["single"] = single_px(prob_s,
                                    best_of_starts(st_s, n_s, s_dim)[0], kp_s)
    log(f"bench: single-frame {n_s} frames in {min(ts) * 1e3:.0f} ms -> "
        f"{fps_s:.0f} frames/s, residual {px_s:.2f}px; runs: {_ms_list(ts)}")
    if gate:
        # the same modal workload fitted without the GMM (the shipped L2
        # prior): the GMM row must sit within ~1 px of it
        prob_l2 = single_problem(w, dtype)
        fit_l2 = build_fitter(prob_l2, 100, device=dev, dtype=dtype,
                              lm_cfg=lmcfg, chunk=chunk_s)
        st_l2, _ = _timed(lambda: fit_l2(x0_s, kp_fit), dev)
        px_l2 = px["no_gmm"] = single_px(
            prob_l2, best_of_starts(st_l2, n_s, s_dim)[0], kp_s)
        log(f"bench: GMM quality gate: gmm {px_s:.2f}px vs no-gmm "
            f"{px_l2:.2f}px on the same modal workload "
            f"(gap {px_s - px_l2:+.2f}px, budget ~1px)")
    it_s = float(np.mean(st_s.iters_run.cpu().numpy()))
    log("bench: " + report(stage_single_frame(
        "single", n_s * s_dim, int(x0_s.shape[-1]), kp_rows, it_s,
        tr_solver=tr or "chol"), min(ts)))
    log(json.dumps({
        "metric": "single_frame_throughput_frames_per_sec",
        "value": round(fps_s, 1), "unit": "frames/sec",
        "residual_px": round(px_s, 2), "starts": s_dim,
        "gmm": gmm_d is not None, "tr": tr or "default"}))
    return px


def main(argv=None, *, device="cuda", mesh=None) -> int:
    """The benchmark on ``device`` (every visible card: a mesh of them when
    there is more than one, a process a card); ``mesh``: run as this rank
    of a mesh (the launcher's workers pass theirs; tests may run ranks as
    threads). No arguments: bench.py is set by its environment."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        log("usage: [BENCH_*=...] python -m smpltpu_torch.bench  (set by "
            "the environment, as bench.py; see the module's docstring)")
        return 2
    try:
        env = read_env(os.environ)
    except ValueError as e:
        log(f"bench: {e}")
        return 1
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false; the bench "
            "runs on the card (main(device='cpu') runs it on the CPU from "
            "Python)")
        return 1
    workdir = os.path.join(PACKAGE_ROOT, "build", "bench_mesh")
    return mesh_main(lambda m: run(env, dev if m is None else m.device, m),
                     __spec__.name, argv, mesh_size(0, dev), device, workdir,
                     mesh)


if __name__ == "__main__":
    sys.exit(main())
