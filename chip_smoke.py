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
    from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
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
    k2 = {"shape": list(got.shape), "max_abs_err": k2_err,
          "ms": cuda_ms(lambda: lbs.lbs(shapes, g_aff, ops), 50),
          "plain_ms": cuda_ms(lambda: lbs.lbs_torch(shapes, g_aff, ops), 10)}
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

    checks("jax" not in sys.modules, "JAX was imported")
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
         "ms": s2["ms"], "plain_ms": s2["plain_ms"]},
        {"name": "lbs", "route": "cuda", "source": "smpltpu_torch/csrc/lbs.cu",
         "replaces": "smpltpu/ops/lbs.py:88", "launches": k2_launches,
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
