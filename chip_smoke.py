#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (smpltpu_torch) once on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's kernels from ``smpltpu_torch/csrc`` and runs, in order:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 must be off.
2. build: nvcc time and the compiler's register/spill report.
3. K1 (arrowhead PCG) against its plain PyTorch version in float32 on
   random SPD arrowhead systems at the stage-2 (67 x 20 frames) and stage-1
   (1 x 100 frames) shapes, with 40 CG steps, plus the tolerance exit and
   a window too large for shared memory; kernel and plain times.
4. K2 (blendshapes + skinning) against its plain version, 100 frames of
   the full-width model; both times.
5. the main path: the 1000-frame synthetic workload of bench.py through
   the fused two-stage fit with ``linear="pcg_kernel"`` (one warm-up run,
   whose first LM iteration's K1 systems, one per stage, are also checked
   against the plain version: see ``k1_compare`` for the tolerance on
   these ill-conditioned systems; then a timed run), write-back, skinning
   of all frames
   through K2, two frames rendered with the host painter; then the same
   fit with the plain PCG, which must land within 0.1 px.
6. the render stage: K3 (the z-buffer rasterizer) against its plain
   version, pixel-exact, on one triangle, an occluding pair, culled faces,
   a mesh partly off screen, a near face over most of the frame and 8
   fitted frames, all at 1280 x 720; K3's time per 100-frame launch; then
   all 1000 fitted frames rendered through K2 -> K3 on the device
   (``render_frames``), with the launch counts of that run, every frame's
   coverage, and two frames held against the host painter's coverage.

Every kernel's line carries its bound: the larger of its bytes (inputs
read once, outputs written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM's published peaks.

Each phase prints one line. The line before the last is the kernels' JSON
summary, the last line ``{"ok": true, "device": {...}}``. A failed check
ends the run with exit code 1 and no result line; so does a machine with
no CUDA device, or a directory without the port.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_FRAMES, WSIZE, OVERLAP, SKIP = 1000, 20, 5, 10
S1_ITERS, S2_ITERS, CG_ITERS = 150, 60, 40
K1_TOL = 2e-4        # relative to the solution's scale (tests/test_cg_kernel.py)
K2_ATOL = 1e-5       # metre-scale vertices, float32
RESIDUAL_MAX_PX = 2.0
PLAIN_GAP_MAX_PX = 0.1
H_R, W_R = 1280, 720          # render size: the bench camera at full size
DEV_IN_HOST_MIN, HOST_IN_DEV_MIN = 0.95, 0.80   # tests/test_jax_raster.py
HBM_BYTES_PER_S = 3.35e12     # H100 SXM peaks (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the least time for the bytes and the float32
    operations at the card's peaks."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase(label, /, **fields):
    print(f"phase {label}: {json.dumps(fields)}", flush=True)


class Checks:
    """Collects failed checks so that one run reports all of them."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        if not ok:
            self.failed.append(what)
            print(f"CHECK FAILED: {what}", flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_arrow_system(rng, w, f, device, scale=1.0, p=76, n_s=10):
    """Random SPD arrowhead systems in the solver's layout, float32 on the
    device: the construction of tests/test_cg_kernel.py, batched, with B
    scaled by sqrt(6/F) so the shape Schur complement C - Bt T^-1 B stays
    as far from singular as at its F = 6 (unscaled, B's columns grow with
    sqrt(F) and the system is indefinite past F ~ 12)."""
    import torch

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    a = t(rng.normal(size=(w, f, p, p)) * 0.1)
    d = a @ a.transpose(-1, -2) + 2.0 * torch.eye(p, device=device)
    off = t(-np.abs(rng.normal(size=(w, f - 1))) * 0.05 * scale)
    tm = torch.ones(p, device=device)
    tm[0] = 0.0
    b = t(rng.normal(size=(w, f, p, n_s)) * 0.05 * np.sqrt(6.0 / f))
    cw = t(rng.normal(size=(w, n_s, n_s)) * 0.1)
    c = cw @ cw.transpose(-1, -2) + 1.5 * torch.eye(n_s, device=device)
    return (d.contiguous(), off, tm, b, c.contiguous(),
            t(rng.normal(size=(w, f, p))), t(rng.normal(size=(w, n_s))))


def k1_compare(label, args, iters, rtol, checks, reps=(20, 3),
               real_system=False, phase_no=3):
    """K1 against the plain version on the same f32 inputs, and both
    against a float64 run of the plain version; then both timed.

    Random systems (well conditioned): the kernel must agree with the f32
    plain version within K1_TOL of the solution's scale, as numpy's
    allclose (the tolerance of tests/test_cg_kernel.py).

    The solver's own systems (``real_system``): here 40 truncated CG steps
    in f32 land 0.5-4 % of the scale away from the f64 run for EITHER f32
    implementation (measured on the H100: plain 0.028 and 0.103 of the
    stage-1 and stage-2 first-iteration systems' max-norm deviation), so
    two f32 reduction orders cannot agree to K1_TOL. The check there is
    that the kernel is no further from the f64 solution than twice the
    plain f32 version's own distance, plus K1_TOL of scale; a wrong kernel
    lands O(scale) away."""
    import torch
    from smpltpu_torch.ops import cg

    got = cg.arrow_pcg(*args, iters=iters, rtol=rtol)
    want = cg.arrow_pcg_torch(*args, iters=iters, rtol=rtol)
    ref = cg.arrow_pcg_torch(*(a.double() for a in args), iters=iters, rtol=rtol)
    torch.cuda.synchronize()
    out = {"shape": list(args[5].shape), "iters": iters, "rtol": rtol}
    ok = True
    for part, g, w, r in zip(("p", "w"), got, want, ref):
        scale = float(w.abs().max())
        if part == "w":
            scale = max(scale, 1.0)
        err = (g - w).abs()
        k_dev = float((g.double() - r).abs().max())
        p_dev = float((w.double() - r).abs().max())
        if real_system:
            ok &= k_dev <= 2.0 * p_dev + K1_TOL * scale
        else:
            ok &= bool(torch.all(err <= K1_TOL * scale + K1_TOL * w.abs()))
        ok &= bool(torch.all(torch.isfinite(g)))
        out[f"max_abs_err_{part}"] = float(err.max())
        out[f"scale_{part}"] = scale
        out[f"kernel_vs_f64_{part}"] = k_dev
        out[f"plain_vs_f64_{part}"] = p_dev
    # per CG step and window: the D matvec 2FP^2, the shape border
    # 4FPnS, the tridiagonal couplings 4FP, C 2nS^2, and 11 (FP + nS) for
    # the preconditioner, two dots and three updates (rtol 0 on the main
    # path: every step runs)
    n_w, f, p = args[5].shape
    n_s = args[6].shape[-1]
    flops = iters * n_w * (2 * f * p * p + 4 * f * p * n_s + 4 * f * p
                           + 2 * n_s * n_s + 11 * (f * p + n_s))
    out["bound_ms"], out["bound_by"] = bound(nbytes(*args, *got), flops)
    out["ms"] = cuda_ms(lambda: cg.arrow_pcg(*args, iters=iters, rtol=rtol),
                        reps[0])
    out["plain_ms"] = cuda_ms(
        lambda: cg.arrow_pcg_torch(*args, iters=iters, rtol=rtol), reps[1])
    rule = ("within 2x the plain f32 distance from f64" if real_system
            else f"within {K1_TOL} of scale of the plain version")
    checks(ok, f"K1 {label}: kernel not {rule}")
    phase(f"{phase_no} k1_{label}", ok=ok, **out)
    return out


def bench_workload(device, n_frames=N_FRAMES, n_verts=None):
    """bench.py's synthetic video (bench.py:85-132): smooth ground-truth
    motion, projected keypoints with 1 px noise, numpy default_rng(0),
    full-width synthetic SMPL model, 720 x 1280 camera; anchors and the
    sliding-window batch."""
    import torch
    from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
    from smpltpu_torch.energy import (
        make_skeleton_spec,
        project,
        skeleton_joints_cam,
    )
    from smpltpu_torch.models import SMPLModel, make_synthetic_model
    from smpltpu_torch.utils import default_intrinsics

    f32 = torch.float32
    rng = np.random.default_rng(0)
    kw = {} if n_verts is None else {"n_verts": n_verts}
    model = SMPLModel.from_dict(make_synthetic_model(**kw), device=device,
                                dtype=f32)
    cam = default_intrinsics(720, 1280, device=device, dtype=f32)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    r0c = np.asarray(init_root_rotation(), np.float32)

    base = rng.normal(size=(23, 3)) * 0.15
    drift = rng.normal(size=(23, 3)) * 0.003
    fidx = np.arange(n_frames, dtype=np.float32)
    ph = 1000.0 - np.abs(np.mod(fidx, 2000.0) - 1000.0)
    gt = np.zeros((n_frames, 76), np.float32)
    gt[:, 0] = 1.0
    gt[:, 1] = 2e-3 * ph
    gt[:, 2] = 1e-3 * ph
    gt[:, 4] = 0.1 + 1e-3 * ph
    gt[:, 5] = -0.1
    gt[:, 6] = 3.2
    gt[:, 7:] = (base[None] + ph[:, None, None] * drift[None]
                 ).reshape(n_frames, 69).astype(np.float32)
    uv = project(skeleton_joints_cam(torch.as_tensor(gt, device=device),
                                     torch.zeros(10, device=device), spec),
                 cam).cpu().numpy()
    kp = np.zeros((n_frames, N_KP_SLOTS, 4), np.float32)
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(
        size=(n_frames, N_KP_SLOTS, 2)).astype(np.float32)
    kp[:, :, 3] = 1.0

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
    from smpltpu_torch.energy.params import init_frame_params

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    n_a = len(anchor_idx)
    args = (init_frame_params(device=device, dtype=f32).repeat(n_a, 1),
            torch.zeros(10, device=device), t(kp[anchor_idx]),
            t(np.tile(r0c, (n_a, 1, 1))), t(kpw),
            t(np.tile(r0c, (len(starts), WSIZE, 1, 1))), t(vw))
    return {"model": model, "cam": cam, "spec": spec, "r0c": r0c, "kp": kp,
            "starts": starts, "anchor_idx": anchor_idx, "args": args,
            "n_frames": n_frames, "use_smpl": USE_SMPL}


def build_fit(w, linear, device):
    """The port's fused two-stage fit with bench.py's configs
    (bench.py:169-172, :216-219), fused cost, 40 CG steps."""
    import torch
    from smpltpu_torch.solve import MultiFrameConfig, build_fused_two_stage

    common = dict(beta_pose=5.0, lambda_temporal=3.0, linear=linear,
                  cg_iters=CG_ITERS, fused_cost=True)
    cfg1 = MultiFrameConfig(beta_shape=25.0, max_iters=S1_ITERS, **common)
    cfg2 = MultiFrameConfig(beta_shape=1e5, max_iters=S2_ITERS, **common)
    return build_fused_two_stage(w["spec"], w["cam"], cfg1, cfg2, 10,
                                 w["anchor_idx"], w["starts"], WSIZE,
                                 w["n_frames"], device=device,
                                 dtype=torch.float32)


def write_back(w, st2):
    """Per-frame params: the first `stride` frames of each window, the
    whole tail of the last one (bench.py:366-373); the shape of window 0."""
    import torch
    n = w["n_frames"]
    stride = WSIZE - OVERLAP
    fp = torch.zeros((n, st2.params.shape[-1]), device=st2.params.device)
    for i, s in enumerate(w["starts"]):
        e = min(s + WSIZE, n)
        take = (e - s) if i == len(w["starts"]) - 1 else min(stride, e - s)
        fp[s:s + take] = st2.params[i, :take]
    return fp, st2.shape[0]


def full_batch_residual(w, frame_params, shp):
    """Mean keypoint reprojection error in pixels over ALL frames and
    slots, under the solver's skeleton model (the estimator bench.py
    samples at every 8th window and 5th frame)."""
    import torch
    from smpltpu_torch.energy import project, skeleton_joints_cam
    uv = project(skeleton_joints_cam(frame_params, shp, w["spec"]), w["cam"])
    kp = torch.as_tensor(w["kp"], device=uv.device)
    d = torch.linalg.norm(uv[:, w["use_smpl"]] - kp[:, :, 1:3], dim=-1)
    return float(d.mean())


def k3_bound(setup, height, width):
    """K3's bound on these inputs: the per-face data read once and gray and
    covered written once; 12 float32 operations (3 edges, 2 products and 2
    sums each) for every pixel of every kept face's clipped bounding box."""
    from smpltpu_torch.render.zbuffer import face_bbox
    bb = face_bbox(setup, height, width).long()
    n_px = int((bb[..., 2] * bb[..., 3]).sum())
    b = setup.key.shape[0]
    return bound(nbytes(*setup) + 2 * b * height * width, 12 * n_px), n_px


def k3_case(label, verts, faces, intr, checks, expect):
    """K3 against its plain version on the same face setup, pixel-exact;
    ``expect(covered_px, setup, gray)`` checks the scene's own content."""
    import torch
    from smpltpu_torch.render.zbuffer import (
        face_setup,
        rasterize,
        rasterize_torch,
    )
    st = face_setup(verts, faces, *intr)
    g1, c1 = rasterize(st, H_R, W_R)
    g2, c2 = rasterize_torch(st, H_R, W_R)
    torch.cuda.synchronize()
    d_gray = int((g1 != g2).sum())
    d_cov = int((c1 != c2).sum())
    n_cov = int(c1.sum())
    scene_ok = bool(expect(n_cov, st, g1))
    ok = d_gray == 0 and d_cov == 0 and scene_ok
    checks(ok, f"K3 {label}: {d_gray} gray and {d_cov} covered pixels differ "
               f"from the plain version, scene check {scene_ok}")
    phase(f"6 k3_{label}", ok=ok, frames=int(verts.shape[0]),
          kept_faces=int(st.keep.sum()), covered_px=n_cov,
          differing_gray_px=d_gray, differing_covered_px=d_cov)
    return st


def coverage_agreement(cov_dev, cov_host):
    """(dev_in_host, host_in_dev): the share of each mask within a 1-px
    dilation of the other (tests/test_jax_raster.py:94-104)."""
    def dil(m):
        out = m.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out |= np.roll(np.roll(m, dy, 0), dx, 1)
        return out
    return ((cov_dev & dil(cov_host)).sum() / max(cov_dev.sum(), 1),
            (cov_host & dil(cov_dev)).sum() / max(cov_host.sum(), 1))


def render_phase(w, frame_params, shp, verts, fit_s, checks):
    """Phase 6 on the fitted frames (``verts``: their skinned vertices from
    phase 5, numpy): the K3 cases, K3's time per 100-frame launch, and the
    counted render of every frame. Returns (the K3 numbers, K3's launches
    in the render)."""
    import torch
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.pipeline.common import (
        render_frames,
        render_overlay_image,
    )
    from smpltpu_torch.render.zbuffer import (
        face_setup,
        rasterize,
        rasterize_torch,
    )
    dev = frame_params.device
    n = w["n_frames"]
    intr = tuple(float(c) for c in (w["cam"].fx, w["cam"].fy, w["cam"].cx,
                                    w["cam"].cy))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def faces_of(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    tri = t([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.3, 2.0]])[None]
    # K3 against its plain version, pixel-exact, scene by scene
    k3_case("triangle", tri, faces_of([[0, 2, 1]]), intr, checks,
            lambda cov, st, g: cov > 1000)
    pair = t([[-0.31, -0.29, 2.0], [0.33, -0.27, 2.05], [0.02, 0.41, 1.95],
              [-0.21, -0.19, 1.5], [0.23, -0.22, 1.52],
              [-0.01, 0.26, 1.49]])[None]

    def near_wins(cov, st, g):
        # the near face's own gray at its centroid's pixel
        x = int(st.u[0, 1].mean())
        y = int(st.v[0, 1].mean())
        return cov > 1000 and int(g[0, y, x]) == int(st.key[0, 1]) & 0xFF
    k3_case("occlusion", pair, faces_of([[0, 2, 1], [3, 5, 4]]), intr, checks,
            near_wins)
    culled = t([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.3, 2.0],
                [-0.2, -0.2, -1.0], [0.2, -0.2, -1.0], [0.0, 0.3, -1.0]])[None]
    k3_case("culled", culled, faces_of([[0, 1, 2], [3, 5, 4]]), intr, checks,
            lambda cov, st, g: cov == 0 and not bool(st.keep.any()))
    faces = faces_of(w["model"].faces)
    body = t(verts[:1] + np.array([1.0, 1.3, 0.0]))  # shifted right and down
    k3_case("off_screen", body, faces, intr, checks,
            lambda cov, st, g: cov > 1000 and float(st.u[st.keep].max()) > W_R
            and float(st.v[st.keep].max()) > H_R)
    near = t([[-1.0, -0.8, 0.5], [1.0, -0.8, 0.5], [0.0, 1.2, 0.5]])[None]
    k3_case("near_face", near, faces_of([[0, 2, 1]]), intr, checks,
            lambda cov, st, g: cov >= H_R * W_R // 2)
    k3_case("fitted_8_frames", t(verts[::n // 8]), faces, intr, checks,
            lambda cov, st, g: bool((g.flatten(1) > 0).sum(1).min() > 0))

    # K3's time per 100-frame launch, and its plain version's
    st100 = face_setup(t(verts[:100]), faces, *intr)
    g1, c1 = rasterize(st100, H_R, W_R)
    g2, c2 = rasterize_torch(st100, H_R, W_R)
    k3_diff = int((g1 != g2).sum()) + int((c1 != c2).sum())
    checks(k3_diff == 0, f"K3, 100 frames: {k3_diff} pixels differ")
    del g1, c1, g2, c2
    (k3_bound_ms, k3_bound_by), k3_px = k3_bound(st100, H_R, W_R)
    k3 = {"ms": cuda_ms(lambda: rasterize(st100, H_R, W_R), 20),
          "plain_ms": cuda_ms(lambda: rasterize_torch(st100, H_R, W_R), 2),
          "bound_ms": k3_bound_ms, "bound_by": k3_bound_by}
    phase("6 k3_b100", ok=k3_diff == 0, frames=100, differing_px=k3_diff,
          bbox_px=k3_px, plain_ms_per_frame=k3["plain_ms"] / 100, **k3)
    del st100

    # the render of every fitted frame through K2 -> K3, counted
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gray, covered = render_frames(w["model"], frame_params, shp, w["r0c"],
                                  w["cam"], H_R, W_R)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    k2_render, k3_launches = LAUNCHES["lbs"], LAUNCHES["raster"]
    render_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_chunks = -(-n // 100)
    checks(k3_launches == n_chunks,
           f"K3 launches {k3_launches} != {n_chunks} chunks")
    checks(k2_render == n_chunks,
           f"K2 launches in the render {k2_render} != {n_chunks} chunks")
    checks(tuple(gray.shape) == (n, H_R, W_R) and gray.dtype == torch.uint8
           and tuple(covered.shape) == (n, H_R, W_R), "render output shape")
    per_frame = covered.flatten(1).sum(1)
    checks(bool((per_frame > 0).all()),
           f"{int((per_frame == 0).sum())} rendered frames are empty")
    agree = {}
    for k in (0, n // 2):
        img = np.zeros((H_R, W_R, 3), np.uint8)
        render_overlay_image(w["model"], verts[k], img, w["cam"])
        d_in_h, h_in_d = coverage_agreement(gray[k].cpu().numpy() > 0,
                                            img[..., 0] > 0)
        agree[k] = [float(d_in_h), float(h_in_d)]
        checks(d_in_h >= DEV_IN_HOST_MIN and h_in_d >= HOST_IN_DEV_MIN,
               f"frame {k}: device vs host painter coverage {d_in_h}, {h_in_d}")
    phase("6 render", frames=n, height=H_R, width=W_R, render_s=render_s,
          render_frames_per_s=n / render_s,
          solve_render_frames_per_s=n / (fit_s + render_s),
          k2_launches=k2_render, k3_launches=k3_launches,
          covered_px={str(k): int(per_frame[k]) for k in (0, n // 2, n - 1)},
          min_covered_px=int(per_frame.min()),
          dev_in_host_host_in_dev=agree, peak_gib=render_peak_gib)
    del gray, covered

    # where the render's device time goes: one more pass, profiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_frames(w["model"], frame_params, shp, w["r0c"], w["cam"],
                      H_R, W_R)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    k3_us = sum(v for k, v in dev_us.items()
                if "raster_kernel" in k or "resolve_kernel" in k)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    phase("6 render_profile", wall_ms=prof_ms,
          device_busy_ms=sum(dev_us.values()) / 1e3,
          k3_kernels_ms=k3_us / 1e3, device_kernels=len(dev_us),
          top_kernels_ms=[[k[:90], v / 1e3] for k, v in top])

    return k3, k3_launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import smpltpu_torch
    from smpltpu_torch import _build
    from smpltpu_torch.ops import LAUNCHES, cg, lbs
    from smpltpu_torch.pipeline.common import (
        batched_frame_eval,
        render_overlay_image,
    )

    checks = Checks()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    tf32_off = (not torch.backends.cuda.matmul.allow_tf32
                and not torch.backends.cudnn.allow_tf32)
    checks(tf32_off, "TF32 is on")
    phase("1 device", name=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi_line, torch=torch.__version__,
          cuda=torch.version.cuda, port=smpltpu_torch.__version__,
          tf32_off=tf32_off)

    # 2. build
    _build.load()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    phase("2 build", built=info["built"], seconds=info["seconds"],
          ptxas=ptxas)

    # 3. K1 vs plain on random systems
    rng = np.random.default_rng(1)
    n_win = len(range(0, N_FRAMES, WSIZE - OVERLAP))
    k1_compare("stage2_random", random_arrow_system(rng, n_win, WSIZE, dev),
               CG_ITERS, 0.0, checks)
    k1_compare("stage1_random",
               random_arrow_system(rng, 1, N_FRAMES // SKIP, dev),
               CG_ITERS, 0.0, checks)
    k1_compare("stage2_rtol",
               random_arrow_system(rng, n_win, WSIZE, dev, scale=3.0),
               CG_ITERS, 0.05, checks)
    # 160 frames: the vectors no longer fit in shared memory
    k1_compare("global_scratch", random_arrow_system(rng, 2, 160, dev),
               CG_ITERS, 0.0, checks, reps=(3, 1))

    # 4. K2 vs plain, 100 frames of the full-width model
    from smpltpu_torch.models import SMPLModel, make_synthetic_model
    from smpltpu_torch.models.smpl import rodrigues
    model = SMPLModel.from_dict(make_synthetic_model(), device=dev,
                                dtype=torch.float32)
    ops = lbs.prepare_lbs_operands(model)
    b = 100
    shapes = torch.as_tensor(0.5 * rng.normal(size=(b, 10)),
                             dtype=torch.float32, device=dev)
    rots = rodrigues(torch.as_tensor(0.3 * rng.normal(size=(b, 24, 3)),
                                     dtype=torch.float32, device=dev))
    pos = torch.as_tensor(rng.normal(size=(b, 3)) * 0.2 + [0.0, 0.0, 3.0],
                          dtype=torch.float32, device=dev)
    g_aff, _ = lbs.joint_affines(model, shapes, rots, pos)
    g_aff = g_aff.contiguous()
    got = lbs.lbs(shapes, g_aff, ops)
    want = lbs.lbs_torch(shapes, g_aff, ops)
    torch.cuda.synchronize()
    k2_err = float((got - want).abs().max())
    k2_ok = k2_err <= K2_ATOL and bool(torch.all(torch.isfinite(got)))
    checks(k2_ok, f"K2: kernel vs plain {k2_err} > {K2_ATOL}")
    # per (frame, vertex): blend 6nS + 3, transforms 24nJ, apply 18
    k2_bound = bound(
        nbytes(shapes, g_aff, got, ops["v_template_t"], ops["shapedirs_t"],
               ops["weights_t"]),
        b * model.num_verts * (6 * shapes.shape[1] + 3
                              + 24 * model.num_joints + 18))
    k2 = {"shape": list(got.shape), "max_abs_err": k2_err,
          "ms": cuda_ms(lambda: lbs.lbs(shapes, g_aff, ops), 50),
          "plain_ms": cuda_ms(lambda: lbs.lbs_torch(shapes, g_aff, ops), 10),
          "bound_ms": k2_bound[0], "bound_by": k2_bound[1]}
    phase("4 k2_b100", ok=k2_ok, **k2)

    # 5. main path
    t0 = time.perf_counter()
    w = bench_workload(dev)
    phase("5 workload", frames=N_FRAMES, windows=len(w["starts"]),
          anchors=len(w["anchor_idx"]), verts=w["model"].num_verts,
          faces=w["model"].num_faces, setup_s=time.perf_counter() - t0)
    run = build_fit(w, "pcg_kernel", dev)

    # warm-up run; it also captures each stage's first K1 system
    first = {}
    real_pcg = cg.arrow_pcg

    def capture(*a, **k):
        first.setdefault(tuple(a[5].shape[:2]),
                         ([t.clone() for t in a], k))
        return real_pcg(*a, **k)
    cg.arrow_pcg = capture
    try:
        run(*w["args"])
    finally:
        cg.arrow_pcg = real_pcg
    torch.cuda.synchronize()
    phase("5 warmup", seconds=run.timings)
    k1_main = {}
    for shape, (a, k) in sorted(first.items()):
        label = "stage1_first_lm_iter" if shape[0] == 1 else "stage2_first_lm_iter"
        k1_main[label] = k1_compare(label, a, k["iters"], k["rtol"], checks,
                                    real_system=True, phase_no=5)
    checks(len(k1_main) == 2, f"captured K1 systems of {sorted(first)}")

    # the timed run, with the launch counts of the main path
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st1, st2 = run(*w["args"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    frame_params, shp = write_back(w, st2)
    n = w["n_frames"]
    t0 = time.perf_counter()
    err, verts = batched_frame_eval(
        w["model"], frame_params, shp.expand(n, -1),
        torch.as_tensor(np.tile(w["r0c"], (n, 1, 1)), device=dev), w["kp"],
        w["cam"])
    eval_s = time.perf_counter() - t0
    k1_launches, k2_launches = LAUNCHES["arrow_pcg"], LAUNCHES["lbs"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    trips1, trips2 = int(st1.iters_run), int(st2.iters_run.max())
    checks(k1_launches == trips1 + trips2,
           f"K1 launches {k1_launches} != loop trips {trips1} + {trips2}")
    checks(k2_launches > 0, "K2 was not launched on the main path")
    residual = full_batch_residual(w, frame_params, shp)
    checks(np.isfinite(residual) and residual <= RESIDUAL_MAX_PX,
           f"full-batch residual {residual} px")
    checks(verts.shape == (n, w["model"].num_verts, 3)
           and bool(np.all(np.isfinite(verts))), "skinned vertices")
    checks(bool(np.all(np.isfinite(err))), "frame evaluation errors")
    phase("5 main_path", linear="pcg_kernel", fit_s=fit_s,
          stage1_ms=run.timings["stage1_s"] * 1e3,
          stage2_ms=run.timings["stage2_s"] * 1e3,
          frames_per_s=n / fit_s, stage1_iters_run=trips1,
          stage2_iters_run_max=trips2,
          stage2_iters_run_mean=float(st2.iters_run.float().mean()),
          stage2_converged=int(st2.converged.sum()),
          k1_launches=k1_launches, k2_launches=k2_launches,
          full_batch_residual_px=residual,
          eval_mean_px=float(np.mean(err)), eval_s=eval_s,
          peak_gib=peak_gib)

    covered = []
    for k in (0, n // 2):
        img = np.zeros((1280, 720, 3), np.uint8)
        render_overlay_image(w["model"], verts[k], img, w["cam"])
        covered.append(int(np.count_nonzero(img.any(axis=-1))))
    checks(all(c > 0 for c in covered), f"rendered coverage {covered}")
    phase("5 render", frames=[0, n // 2], covered_px=covered)

    # the same fit with the plain PCG loop
    run_plain = build_fit(w, "pcg", dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st2p = run_plain(*w["args"])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    residual_plain = full_batch_residual(w, *write_back(w, st2p))
    gap = abs(residual - residual_plain)
    checks(gap <= PLAIN_GAP_MAX_PX,
           f"kernel vs plain-PCG residual gap {gap} px")
    phase("5 plain_pcg_fit", fit_s=plain_s,
          stage1_ms=run_plain.timings["stage1_s"] * 1e3,
          stage2_ms=run_plain.timings["stage2_s"] * 1e3,
          frames_per_s=n / plain_s, full_batch_residual_px=residual_plain,
          gap_px=gap)

    k3, k3_launches = render_phase(w, frame_params, shp, verts, fit_s,
                                   checks)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "smpltpu"))
    checks(not foreign, f"JAX or the JAX package was imported: {foreign}")
    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: "
              f"{checks.failed}", flush=True)
        return 1
    s2 = k1_main["stage2_first_lm_iter"]
    print(json.dumps({"kernels": [
        {"name": "arrow_pcg", "route": "cuda",
         "source": "smpltpu_torch/csrc/arrow_pcg.cu",
         "replaces": "smpltpu/ops/cg.py:146", "launches": k1_launches,
         "max_abs_err": max(s2["max_abs_err_p"], s2["max_abs_err_w"]),
         "ms": s2["ms"], "plain_ms": s2["plain_ms"],
         "bound_ms": s2["bound_ms"], "bound_by": s2["bound_by"],
         "library_ms": None},
        {"name": "lbs", "route": "cuda", "source": "smpltpu_torch/csrc/lbs.cu",
         "replaces": "smpltpu/ops/lbs.py:88", "launches": k2_launches,
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "raster", "route": "cuda",
         "source": "smpltpu_torch/csrc/raster.cu",
         "replaces": "smpltpu/render/pallas_raster.py:425",
         "launches": k3_launches, "max_abs_err": 0, "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
