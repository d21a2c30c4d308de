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
   random SPD arrowhead systems, 40 CG steps: a sweep over window counts
   W in {1, 3, 67}, frames per window F in {1, 7, 20, 33, 100, 150, 160,
   400}, nS in {7, 10, 16} and P in {76, 31} (the fit's 76, and the small
   model's 31, which is not a multiple of 4), with the tolerance exit and
   a forced one-CTA plan whose vectors live in global scratch; each case
   printed with its launch plan (cluster size, resident frames, shared
   bytes), run twice and required bitwise identical. Then the stage-2
   (67 x 20) and stage-1 (1 x 100) shapes timed under the plan's cluster
   size and one alternative (the layouts).
4. K2 (blendshapes + skinning) against its plain version: 100 frames of
   the full-width model (timed), 1 and 37 frames (a ragged frame tile),
   the 300-vertex model, and a 7-shape model through the kernel's
   run-time-width instantiation.
5. the main path: the 1000-frame synthetic workload of bench.py through
   the fused two-stage fit with ``linear="pcg_kernel"`` (one warm-up run,
   whose first LM iteration's K1 systems, one per stage, are also checked
   against the plain version: see ``k1_compare`` for the tolerance on
   these ill-conditioned systems; then a timed run), write-back, skinning
   of all frames through K2, two frames rendered with the host painter;
   then the same fit with the plain PCG, which must land within 0.1 px.
6. the render stage: K3 (the z-buffer rasterizer) through both entry
   points, ``rasterize`` from a face setup and ``rasterize_verts`` from the
   vertices, each pixel-exact against the plain version, and the setup
   kernel's key, coefficients and boxes bit for bit against the plain
   setup, on one triangle, an occluding pair, culled faces, a mesh partly
   off screen, a near face over most of the frame, 8 fitted frames, a
   batch with an empty frame in it, a batch of one (all at 1280 x 720) and
   a 250 x 130 frame that no tile divides; 100 fitted frames, run twice
   (identical) and timed through both entry points beside the eager
   setup; then all 1000 fitted frames rendered through K2 -> K3 on the
   device (``render_frames``), with the launch counts and peak memory of
   that run, every frame's coverage, and two frames held against the host
   painter's coverage; then one more pass under the profiler.
7. one more fit under torch.profiler, at a fifth of the depth (30 + 12
   LM iterations: the profiler takes half a minute to digest a full
   fit's records), phase ``5 fit_profile``: device busy ms, K1's ms and
   launches, the idle share; last, so that the profiler's cost touches
   none of the timings above.

    python3 chip_smoke.py --k1-layouts

times K1 instead under every cluster size at the stage shapes and a few
others (phases 1-3, no main path and no result line): the measurement
behind ``ops/cg.py::k1_plan``'s rule.

    python3 chip_smoke.py --k2

runs phases 1, 2 and the 100-frame case of phase 4 only: K2's time by
both measures below. A copy of this script in another checkout of the
port times that checkout's K2 the same way.

Every kernel's line carries its bound: the larger of its bytes (inputs
read once, outputs written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM's published peaks. K2's and K3's
``ms`` is taken with the calls captured into a CUDA graph, so that a
kernel shorter than the host's time to enqueue it is timed on the device;
``event_ms`` beside it is the time between CUDA events around eager calls
of the wrapper, the host's enqueueing included.

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
RENDER_PEAK_MAX_GIB = 2.19   # 0.3 below the render with a z-buffer in device memory
RESIDUAL_MAX_PX = 2.0
PLAIN_GAP_MAX_PX = 0.1
PROFILE_DEPTH = 5             # the profiled fit runs 1/5 of the LM iterations
H_R, W_R = 1280, 720          # render size: the bench camera at full size
DEV_IN_HOST_MIN, HOST_IN_DEV_MIN = 0.95, 0.80   # tests/test_jax_raster.py
HBM_BYTES_PER_S = 3.35e12     # H100 SXM peaks (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12
# phase 3's K1 cases: (label, windows W, frames F, row block P, shapes nS,
# rtol, forced cluster size or None for the plan's own choice)
K1_SWEEP = (
    ("stage2", 67, 20, 76, 10, 0.0, None),
    ("stage1", 1, 100, 76, 10, 0.0, None),
    ("stage2_rtol", 67, 20, 76, 10, 0.05, None),
    ("f1", 1, 1, 76, 10, 0.0, None),
    ("f7_ns16", 3, 7, 76, 16, 0.0, None),
    ("f20_w1_ns16", 1, 20, 76, 16, 0.0, None),
    ("f33", 3, 33, 76, 10, 0.0, None),
    ("stage1_ns16", 1, 100, 76, 16, 0.0, None),
    ("f150", 1, 150, 76, 10, 0.0, None),
    ("f160_ns16", 3, 160, 76, 16, 0.0, None),
    ("f400", 1, 400, 76, 10, 0.0, None),
    ("f400_rtol", 1, 400, 76, 16, 0.05, None),
    ("f160_one_cta_scratch", 2, 160, 76, 10, 0.0, 1),
    ("p31_f100", 1, 100, 31, 10, 0.0, None),
    ("p31_f33_ns7", 3, 33, 31, 7, 0.0, None),
)
# phase 3 layouts: at each stage shape, the plan's cluster size and this
# alternative (one CTA per window in one wave; the largest cluster)
K1_ALTERNATIVE = {(67, 20): 1, (1, 100): 16}
# phase 4's K2 cases: (label, options of the synthetic model, frames)
K2_CASES = (("b100", {}, 100), ("b1", {}, 1), ("b37", {}, 37),
            ("b37_nv300", {"n_verts": 300}, 37),
            ("b37_ns7", {"n_shapes": 7}, 37))
# --k1-layouts: every cluster size at these (W, F, P) shapes
K1_LAYOUT_SHAPES = ((67, 20, 76), (1, 100, 76), (3, 33, 76), (1, 150, 76),
                    (1, 400, 76), (1, 100, 31))


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the least time for the bytes and the float32
    operations at the card's peaks."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


T_START = time.perf_counter()


def phase(label, /, **fields):
    """One phase's line; ``at_s`` is the script's wall time when it ends."""
    fields["at_s"] = time.perf_counter() - T_START
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


def graph_ms(fn, reps):
    """Device milliseconds per call of fn(): reps calls captured into one
    CUDA graph and replayed between two events, so the kernels run back to
    back and the host's time to enqueue them (more than a short kernel
    takes) is not in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
               real_system=False, phase_no=3, cluster=None):
    """K1 against the plain version on the same f32 inputs, and both
    against a float64 run of the plain version; then both timed. The
    kernel runs twice and the two outputs must be bitwise identical (the
    cluster reductions sum in a fixed order). ``cluster`` forces the
    plan's cluster size.

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

    n_w, f, p = args[5].shape
    n_s = args[6].shape[-1]
    plan = cg.k1_plan(n_w, f, p, n_s, **cg.device_limits(args[5].device),
                      cluster=cluster)

    def kernel():
        return cg.arrow_pcg_planned(plan, *args, iters=iters, rtol=rtol)
    got = kernel()
    again = kernel()
    want = cg.arrow_pcg_torch(*args, iters=iters, rtol=rtol)
    ref = cg.arrow_pcg_torch(*(a.double() for a in args), iters=iters, rtol=rtol)
    torch.cuda.synchronize()
    repeat_ok = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    checks(repeat_ok, f"K1 {label}: two launches differ")
    out = {"shape": list(args[5].shape), "n_s": n_s, "iters": iters,
           "rtol": rtol, "plan": plan._asdict(), "bitwise_repeat": repeat_ok}
    ok = repeat_ok
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
    flops = iters * n_w * (2 * f * p * p + 4 * f * p * n_s + 4 * f * p
                           + 2 * n_s * n_s + 11 * (f * p + n_s))
    out["bound_ms"], out["bound_by"] = bound(nbytes(*args, *got), flops)
    out["ms"] = cuda_ms(kernel, reps[0])
    out["plain_ms"] = cuda_ms(
        lambda: cg.arrow_pcg_torch(*args, iters=iters, rtol=rtol), reps[1])
    rule = ("within 2x the plain f32 distance from f64" if real_system
            else f"within {K1_TOL} of scale of the plain version")
    checks(ok, f"K1 {label}: kernel not {rule}")
    phase(f"{phase_no} k1_{label}", ok=ok, **out)
    return out


def k1_layouts(rng, dev, checks, every=False):
    """K1's time under the plan's cluster size and K1_ALTERNATIVE's at the
    two stage shapes or, ``every``, under every cluster size at
    K1_LAYOUT_SHAPES; on one random system per shape, in turns (sizes in
    order, then in reverse), each held to K1_TOL against the plain
    version."""
    import torch
    from smpltpu_torch.ops import cg
    limits = cg.device_limits(dev)
    shapes = (K1_LAYOUT_SHAPES if every
              else [(n_w, f, 76) for n_w, f in K1_ALTERNATIVE])
    for n_w, f, p in shapes:
        args = random_arrow_system(rng, n_w, f, dev, p=p)
        want = cg.arrow_pcg_torch(*args, iters=CG_ITERS)
        chosen = cg.k1_plan(n_w, f, p, 10, **limits).cluster
        top = min(limits["max_cluster"], f)
        sizes = (range(1, top + 1) if every
                 else sorted({chosen, min(K1_ALTERNATIVE[n_w, f], top)}))
        plans = {c: cg.k1_plan(n_w, f, p, 10, **limits, cluster=c)
                 for c in sizes}
        ms = {c: [] for c in plans}
        for c in list(plans) + list(plans)[::-1]:
            ms[c].append(cuda_ms(lambda: cg.arrow_pcg_planned(
                plans[c], *args, iters=CG_ITERS), 10))
        errs = {}
        for c, plan in plans.items():
            got = cg.arrow_pcg_planned(plan, *args, iters=CG_ITERS)
            ok = all(bool(torch.all((g - w).abs() <= K1_TOL * max(
                float(w.abs().max()), 1.0) + K1_TOL * w.abs()))
                for g, w in zip(got, want))
            checks(ok, f"K1 layout {n_w}x{f} cluster {c}: not within K1_TOL")
            errs[c] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        phase(f"3 k1_layouts_{n_w}x{f}_p{p}", plan_cluster=chosen,
              ms={str(c): v for c, v in ms.items()},
              max_abs_err={str(c): v for c, v in errs.items()},
              plans={str(c): p._asdict() for c, p in plans.items()})
        del args, want


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


def build_fit(w, linear, device, depth=1):
    """The port's fused two-stage fit with bench.py's configs
    (bench.py:169-172, :216-219), fused cost, 40 CG steps; both stages'
    LM iterations divided by ``depth``."""
    import torch
    from smpltpu_torch.solve import MultiFrameConfig, build_fused_two_stage

    common = dict(beta_pose=5.0, lambda_temporal=3.0, linear=linear,
                  cg_iters=CG_ITERS, fused_cost=True)
    cfg1 = MultiFrameConfig(beta_shape=25.0, max_iters=S1_ITERS // depth,
                            **common)
    cfg2 = MultiFrameConfig(beta_shape=1e5, max_iters=S2_ITERS // depth,
                            **common)
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


def k3_bounds(setup, verts, faces, height, width):
    """K3's two bounds on these inputs. ``rasterize``: the FaceSetup read
    once, gray and covered written once. ``rasterize_verts``: the vertices
    and faces read once, the same two outputs. Both: 12 float32 operations
    (3 edges, 2 products and 2 sums each) for every pixel of every kept
    face's clipped bounding box; the setup's ~150 a face on top for
    ``rasterize_verts``. -> ((ms, by), (ms, by), box pixels)."""
    from smpltpu_torch.render.zbuffer import face_bbox
    bb = face_bbox(setup, height, width).long()
    n_px = int((bb[..., 2] * bb[..., 3]).sum())
    b = setup.key.shape[0]
    out = 2 * b * height * width
    return (bound(nbytes(*setup) + out, 12 * n_px),
            bound(nbytes(verts) + 4 * faces.numel() + out,
                  12 * n_px + 150 * setup.key.numel()), n_px)


def k3_setup_diff(verts, faces, intr, height, width):
    """``rasterize_verts`` on the card, its images and what its setup
    stage left: (gray, covered, differing key words, differing box words,
    differing coefficient words) against ``face_setup`` and ``face_bbox``,
    compared as bits. The boxes are compared on every face (which faces
    have a record, kept and on screen, with them); keys and coefficients
    on the faces that have one: nothing is kept, or read, of the others."""
    import torch
    from smpltpu_torch.render import zbuffer
    st = zbuffer.face_setup(verts, faces, *intr)
    bb = zbuffer.face_bbox(st, height, width)
    gray, covered, scratch = zbuffer._rasterize_verts_cuda(
        verts, faces, *intr, height, width, None)
    got = zbuffer.kernel_setup(scratch)
    on = bb[..., 2] > 0
    as_bits = torch.int32
    return (gray, covered, int((got["key"] != st.key)[on].sum()),
            int((got["bbox"] != bb).sum()) + int((got["has_box"] != on).sum()),
            int((got["coef"].view(as_bits) != st.coef.view(as_bits))[on].sum()))


def k3_case(label, verts, faces, intr, checks, expect, height=H_R,
            width=W_R):
    """K3 through both entry points against its plain version on the same
    face setup, pixel-exact (``rasterize``, ``rasterize_verts``, and the
    launch whose scratch is read), and its setup stage against the plain
    setup, bit for bit; ``expect(covered_px, setup, gray)`` checks the
    scene's own content."""
    import torch
    from smpltpu_torch.render.zbuffer import (
        face_setup,
        rasterize,
        rasterize_torch,
        rasterize_verts,
    )
    st = face_setup(verts, faces, *intr)
    g1, c1 = rasterize(st, height, width)
    g2, c2 = rasterize_torch(st, height, width)
    g3, c3 = rasterize_verts(verts, faces, *intr, height, width)
    g4, c4, d_key, d_box, d_coef = k3_setup_diff(verts, faces, intr, height,
                                                 width)
    torch.cuda.synchronize()
    d_gray = [int((g != g2).sum()) for g in (g1, g3, g4)]
    d_cov = [int((c != c2).sum()) for c in (c1, c3, c4)]
    n_cov = int(c1.sum())
    scene_ok = bool(expect(n_cov, st, g1))
    ok = (not any(d_gray + d_cov + [d_key, d_box, d_coef])) and scene_ok
    checks(ok, f"K3 {label}: gray {d_gray} and covered {d_cov} pixels differ "
               f"from the plain version (rasterize, rasterize_verts, the "
               f"launch read for its setup); setup "
               f"words differing: key {d_key}, box {d_box}, coef {d_coef}; "
               f"scene check {scene_ok}")
    phase(f"6 k3_{label}", ok=ok, frames=int(verts.shape[0]), height=height,
          width=width, kept_faces=int(st.keep.sum()), covered_px=n_cov,
          differing_gray_px=d_gray, differing_covered_px=d_cov,
          differing_setup_words={"key": d_key, "box": d_box, "coef": d_coef})
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


def fit_profile(w, dev, checks):
    """Phase 5 fit_profile, run after phase 6: a fit of 1/PROFILE_DEPTH of
    the LM iterations under torch.profiler, device activity only (the
    host's operators are not recorded, which keeps the profiler's cost out
    of the wall time); the device's busy time (the sum of its kernels'
    self time), K1's share and the idle share of the profiled wall time.
    The run's K1 launches, by the wrapper's own count, must be its loop
    trips, and the profiler's records of K1 as many. The profiler loses a
    buffer of records now and then (1 % of a full fit's ~143 000, in one
    run of five on an H100): a run that lost some is made once more, and
    if that one falls short too, ``records_complete`` is false, its busy
    and K1 times are lower bounds, and its count is held to nine tenths of
    the wrapper's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from smpltpu_torch.ops import LAUNCHES
    run = build_fit(w, "pcg_kernel", dev, depth=PROFILE_DEPTH)
    run(*w["args"])
    for attempt in (1, 2):
        before = LAUNCHES["arrow_pcg"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st1, st2 = run(*w["args"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        k1 = [e for e in dev_ev if "arrow_pcg_kernel" in e.key]
        k1_seen = sum(e.count for e in k1)
        k1_run = LAUNCHES["arrow_pcg"] - before
        if k1_seen == k1_run:
            break
    busy_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3
    trips = int(st1.iters_run) + int(st2.iters_run.max())
    checks(k1_run == trips and trips > 0,
           f"profiled fit: {k1_run} K1 launches, {trips} loop trips")
    checks(busy_ms > 0 and 0.9 * k1_run <= k1_seen <= k1_run,
           f"profiled fit: {busy_ms} ms busy, {k1_seen} K1 launches in the "
           f"profiler's records, {k1_run} launched")
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    phase("5 fit_profile", depth=f"1/{PROFILE_DEPTH}", attempts=attempt,
          records_complete=k1_seen == k1_run, wall_ms=wall_ms,
          device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
          k1_ms=sum(e.self_device_time_total for e in k1) / 1e3,
          k1_launches=k1_run, k1_launches_recorded=k1_seen,
          device_launches=sum(e.count for e in dev_ev),
          device_busy_ms_per_trip=busy_ms / max(trips, 1),
          top_kernels_ms=[[e.key[:90], e.self_device_time_total / 1e3,
                           e.count] for e in top])


def render_phase(w, frame_params, shp, verts, fit_s, checks):
    """Phase 6 on the fitted frames (``verts``: their skinned vertices from
    phase 5, numpy): the K3 cases, K3's time per 100-frame launch, and the
    counted render of every frame. Returns (the K3 numbers by entry point,
    K3's launches in the render, those of them with the setup stage)."""
    import torch
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.pipeline.common import (
        render_frames,
        render_overlay_image,
    )
    from smpltpu_torch.render.zbuffer import (
        face_bbox,
        face_setup,
        rasterize,
        rasterize_torch,
        rasterize_verts,
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
    # a frame with no kept face (the body behind the camera) between two
    # that have some
    mixed = t(verts[[0, 1, 2]])
    mixed[1, :, 2] = -mixed[1, :, 2]
    k3_case("empty_frame_in_batch", mixed, faces, intr, checks,
            lambda cov, st, g: not bool(st.keep[1].any())
            and int((g[1] > 0).sum()) == 0 and int((g[0] > 0).sum()) > 1000
            and int((g[2] > 0).sum()) > 1000)
    k3_case("batch_of_one", t(verts[n // 2:n // 2 + 1]), faces, intr, checks,
            lambda cov, st, g: cov > 1000)
    # a frame that no tile divides: the camera scaled to 250 x 130
    small = tuple(c * 130.0 / W_R for c in intr)
    k3_case("ragged_250x130", t(verts[::n // 4]), faces, small, checks,
            lambda cov, st, g: cov > 100, height=250, width=130)

    # 100 fitted frames: both entry points against the plain version, twice
    # (a z-buffer minimum does not depend on the order of the tiles' lists),
    # then timed beside the eager setup and the plain rasterizer
    v100 = t(verts[:100])
    st100 = face_setup(v100, faces, *intr)
    g2, c2 = rasterize_torch(st100, H_R, W_R)
    g1, c1 = rasterize(st100, H_R, W_R)
    g3, c3, d_key, d_box, d_coef = k3_setup_diff(v100, faces, intr, H_R, W_R)
    g4, c4 = rasterize_verts(v100, faces, *intr, H_R, W_R)
    torch.cuda.synchronize()
    k3_diff = [int((g != g2).sum()) + int((c != c2).sum())
               for g, c in ((g1, c1), (g3, c3))]
    repeat_ok = bool(torch.equal(g3, g4)) and bool(torch.equal(c3, c4))
    k3_ok = not any(k3_diff + [d_key, d_box, d_coef]) and repeat_ok
    checks(k3_ok, f"K3, 100 frames: {k3_diff} pixels differ (rasterize, "
                  f"rasterize_verts); setup words differing: key {d_key}, box "
                  f"{d_box}, coef {d_coef}; two runs identical: {repeat_ok}")
    out = (g4, c4)
    del g1, c1, g2, c2, g3, c3
    bound_setup, bound_verts, k3_px = k3_bounds(st100, v100, faces, H_R, W_R)
    ms_setup = graph_ms(lambda: rasterize(st100, H_R, W_R, out=out), 10)
    ms_verts = graph_ms(
        lambda: rasterize_verts(v100, faces, *intr, H_R, W_R, out=out), 10)
    plain_ms = cuda_ms(lambda: rasterize_torch(st100, H_R, W_R), 2)
    plain_setup_ms = cuda_ms(
        lambda: face_bbox(face_setup(v100, faces, *intr), H_R, W_R), 5)
    k3 = {"raster": {
              "ms": ms_setup, "plain_ms": plain_ms,
              "bound_ms": bound_setup[0], "bound_by": bound_setup[1],
              "event_ms": cuda_ms(
                  lambda: rasterize(st100, H_R, W_R, out=out), 20)},
          "raster_verts": {
              "ms": ms_verts, "plain_ms": plain_setup_ms + plain_ms,
              "bound_ms": bound_verts[0], "bound_by": bound_verts[1],
              "event_ms": cuda_ms(lambda: rasterize_verts(
                  v100, faces, *intr, H_R, W_R, out=out), 20)}}
    phase("6 k3_b100", ok=k3_ok, frames=100, differing_px=k3_diff,
          differing_setup_words={"key": d_key, "box": d_box, "coef": d_coef},
          two_runs_identical=repeat_ok, bbox_px=k3_px,
          kept_faces=int(st100.keep.sum()), plain_setup_ms=plain_setup_ms,
          plain_ms_per_frame=plain_ms / 100, **k3)
    del st100, v100, out, g4, c4

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
    k3_setup_launches = LAUNCHES["raster_setup"]
    render_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_chunks = -(-n // 100)
    checks(k3_launches == n_chunks and k3_setup_launches == n_chunks,
           f"K3 launches {k3_launches}, with the setup stage "
           f"{k3_setup_launches} != {n_chunks} chunks")
    # no (B, H, W) int32 z-buffer, no eager setup intermediates
    checks(render_peak_gib < RENDER_PEAK_MAX_GIB,
           f"render peak {render_peak_gib} GiB >= {RENDER_PEAK_MAX_GIB}")
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
          k3_setup_launches=k3_setup_launches,
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
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in dev_ev}
    k3_ms = {name: sum(v for k, v in dev_us.items() if name in k) / 1e3
             for name in ("setup_kernel", "scan_kernel", "fill_kernel",
                          "tile_kernel")}
    k2_ms = sum(v for k, v in dev_us.items() if "lbs_kernel" in k) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    phase("6 render_profile", wall_ms=prof_ms,
          device_busy_ms=sum(dev_us.values()) / 1e3,
          k3_kernels_ms=sum(k3_ms.values()), k3_by_kernel_ms=k3_ms,
          k2_kernel_ms=k2_ms, device_kernels=len(dev_us),
          device_launches=sum(e.count for e in dev_ev),
          top_kernels_ms=[[k[:90], v / 1e3] for k, v in top])

    return k3, k3_launches, k3_setup_launches


def k2_phase(rng, dev, checks, cases):
    """Phase 4: K2 against its plain version within K2_ATOL on each of
    ``cases`` (label, model options, frames); the 100-frame case timed.
    Returns that case's numbers."""
    import torch
    from smpltpu_torch.models import SMPLModel, make_synthetic_model
    from smpltpu_torch.models.smpl import rodrigues
    from smpltpu_torch.ops import lbs
    k2, models = None, {}
    for label, kw, b in cases:
        key = tuple(sorted(kw.items()))
        if key not in models:
            models[key] = SMPLModel.from_dict(
                make_synthetic_model(**kw), device=dev, dtype=torch.float32)
        model = models[key]
        ops = lbs.prepare_lbs_operands(model)
        n_s = model.shapedirs.shape[-1]
        shapes = torch.as_tensor(0.5 * rng.normal(size=(b, n_s)),
                                 dtype=torch.float32, device=dev)
        rots = rodrigues(torch.as_tensor(
            0.3 * rng.normal(size=(b, model.num_joints, 3)),
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
        checks(k2_ok, f"K2 {label}: kernel vs plain {k2_err} > {K2_ATOL}")
        out = {"shape": list(got.shape), "n_joints": model.num_joints,
               "n_shapes": n_s, "max_abs_err": k2_err}
        if label == "b100":
            # per (frame, vertex): blend 6nS + 3, transforms 24nJ, apply 18
            k2_bound = bound(
                nbytes(shapes, g_aff, got, ops["v_template_t"],
                       ops["shapedirs_t"], ops["weights_t"]),
                b * model.num_verts * (6 * n_s + 3 + 24 * model.num_joints
                                       + 18))
            out.update(
                ms=graph_ms(lambda: lbs.lbs(shapes, g_aff, ops), 50),
                event_ms=cuda_ms(lambda: lbs.lbs(shapes, g_aff, ops), 50),
                plain_ms=cuda_ms(lambda: lbs.lbs_torch(shapes, g_aff, ops),
                                 10),
                bound_ms=k2_bound[0], bound_by=k2_bound[1])
            k2 = out
        phase(f"4 k2_{label}", ok=k2_ok, **out)
    return k2


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import smpltpu_torch
    from smpltpu_torch import _build
    from smpltpu_torch.ops import LAUNCHES, cg
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

    rng = np.random.default_rng(1)
    if argv == ["--k2"]:
        k2_phase(rng, dev, checks, K2_CASES[:1])
        return 1 if checks.failed else 0

    # 3. K1 vs plain on random systems, then the layouts
    phase("3 k1_limits", **cg.device_limits(dev))
    if argv == ["--k1-layouts"]:
        k1_layouts(rng, dev, checks, every=True)
        return 1 if checks.failed else 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    for label, n_w, f, p, n_s, rtol, cluster in K1_SWEEP:
        sys_args = random_arrow_system(rng, n_w, f, dev, p=p, n_s=n_s,
                                       scale=3.0 if rtol else 1.0)
        k1_compare(label, sys_args, CG_ITERS, rtol, checks, reps=(5, 1),
                   cluster=cluster)
        del sys_args
    k1_layouts(rng, dev, checks)

    # 4. K2 vs plain: the full-width model at 100 (timed), 1 and 37 frames,
    # the 300-vertex model, and 7 shapes (the run-time-width instantiation)
    k2 = k2_phase(rng, dev, checks, K2_CASES)

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
    k1_stage = {"stage1": LAUNCHES[f"arrow_pcg@1x{len(w['anchor_idx'])}"],
                "stage2": LAUNCHES[f"arrow_pcg@{len(w['starts'])}x{WSIZE}"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    trips1, trips2 = int(st1.iters_run), int(st2.iters_run.max())
    checks(k1_launches == trips1 + trips2,
           f"K1 launches {k1_launches} != loop trips {trips1} + {trips2}")
    checks(k1_stage["stage1"] == trips1 and k1_stage["stage2"] == trips2,
           f"K1 launches by stage {k1_stage} != trips {trips1}, {trips2}")
    s1_plan = k1_main["stage1_first_lm_iter"]["plan"]
    checks(s1_plan["cluster"] > 1,
           f"stage 1's K1 plan runs on one SM: {s1_plan}")
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
          k1_launches=k1_launches, k1_launches_by_stage=k1_stage,
          k2_launches=k2_launches, full_batch_residual_px=residual,
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

    k3, k3_launches, k3_setup_launches = render_phase(
        w, frame_params, shp, verts, fit_s, checks)
    fit_profile(w, dev, checks)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "smpltpu"))
    checks(not foreign, f"JAX or the JAX package was imported: {foreign}")
    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: "
              f"{checks.failed}", flush=True)
        return 1
    # K1 at each stage's shape, on that stage's first real system; its
    # launches are the main path's count at that shape
    k1_lines = [
        {"name": f"arrow_pcg_{stage}", "route": "cuda",
         "source": "smpltpu_torch/csrc/arrow_pcg.cu",
         "replaces": "smpltpu/ops/cg.py:146", "launches": k1_stage[stage],
         "max_abs_err": max(c["max_abs_err_p"], c["max_abs_err_w"]),
         "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": None}
        for stage, c in (("stage1", k1_main["stage1_first_lm_iter"]),
                         ("stage2", k1_main["stage2_first_lm_iter"]))]
    print(json.dumps({"kernels": k1_lines + [
        {"name": "lbs", "route": "cuda", "source": "smpltpu_torch/csrc/lbs.cu",
         "replaces": "smpltpu/ops/lbs.py:88", "launches": k2_launches,
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
    ] + [
        # K3 by entry point: binning and tiles from a face setup, and the
        # same behind the setup stage, from the vertices
        {"name": name, "route": "cuda",
         "source": "smpltpu_torch/csrc/raster.cu",
         "replaces": "smpltpu/render/pallas_raster.py:425",
         "launches": launches, "max_abs_err": 0, "ms": k3[name]["ms"],
         "plain_ms": k3[name]["plain_ms"], "bound_ms": k3[name]["bound_ms"],
         "bound_by": k3[name]["bound_by"], "library_ms": None}
        for name, launches in (("raster", k3_launches),
                               ("raster_verts", k3_setup_launches))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
