"""``3dba_single``-compatible CLI on the card (port of
``smpltpu/pipeline/single.py``): per-frame independent SMPL fitting.

    python -m smpltpu_torch.pipeline.single <SMPL.npz> <kps_folder>
        <images_folder> <out_dir> [max_iters=100] [beta_pose=20]
        [beta_shape=30] [flags]

Up to three numeric optionals are consumed in order (max_iters, beta_pose,
beta_shape), interleaved anywhere with the flags; unknown tokens warn and
are ignored, as in the reference's parser. It writes ``log.csv`` (a row
per frame with keypoints), one overlay ``frame_<i>_render.png`` per such
frame, ``params_single.npz`` and ``loss_curve.txt``. Every frame is one LM
problem and all of them are solved as one batch on the card
(``solve/single_frame.py``); ``time_ms`` is each frame's share of the
batched solve. The evaluation skins every frame through K2, and with
``--jax-render`` each frame is rasterized by K3. From Python,
``main(argv, device="cpu")`` runs it on the CPU (the tests do); nothing
falls back to the CPU by itself, and with no CUDA device the command says
so and exits non-zero.

Framework extensions, as in the JAX package: --opt-shape, --use-gmm,
--pose-prior, --jax-render, --multi-start (the data-driven init under
root-yaw hypotheses, the blind init and, with the GMM, a start per
component mean; the lowest-cost start is kept per frame),
--adaptive-start / --adaptive-thresh (multi-start only the frames left
above the threshold), --adaptive-propagate (then walk the neighbours'
optima along the sequence through the streaming scan), --no-orient-init,
--freeze-scale, --frame-chunk, --profile (torch.profiler traces under
out_dir/profile), --metrics-jsonl, --mesh N.

``--mesh N`` (N > 1; 0 means every visible card, one rank on the CPU)
shards the frame batch (and the adaptive path's every call) over the
ranks, padded by repeating the last row with its keypoints masked
(``parallel/sharded.py::sharded_frame_fit``): per-frame problems are
independent, so nothing is exchanged until the gather. Ranks and
processes as in the multi CLI; rank 0 does the evaluation, the render and
every write.

Differences from the JAX CLI:
  * a warm-up call runs one LM trip of the solve it precedes (the JAX CLI
    runs the whole solve once to compile it), so ``time_ms`` excludes the
    kernels' build and the fit is not run twice;
  * ``--jax-render`` has no fallback to another rasterizer.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from smpltpu_torch.constants import init_root_rotation
from smpltpu_torch.energy.params import N_FRAME_PARAMS, init_frame_params
from smpltpu_torch.models.smpl import UnsupportedModelError, require_smpl_width
from smpltpu_torch.pipeline.common import (
    StageTimer,
    append_log,
    batched_frame_eval,
    is_number,
    load_dataset,
    render_overlay_image,
    save_params,
)
from smpltpu_torch.parallel import mesh_size, sharded_frame_fit
from smpltpu_torch.parallel.launch import mesh_main
from smpltpu_torch.solve.init import best_of_starts, fit_adaptive, make_start_set
from smpltpu_torch.solve.lm import LMResult
from smpltpu_torch.solve.single_frame import build_fitter, make_single_frame_problem
from smpltpu_torch.utils.image import imread
from smpltpu_torch.utils.obs import MetricsLogger, profile_trace

USAGE = """usage: python -m smpltpu_torch.pipeline.single <SMPL.npz> <kps_folder> <images_folder> <out_dir>
                   [max_iters=100] [beta_pose=20] [beta_shape=30]
                   [--opt-shape] [--use-gmm] [--mesh N] [--frame-chunk N]
                   [--multi-start] [--adaptive-start] [--adaptive-thresh PX]
                   [--adaptive-propagate] [--no-orient-init]
                   [--profile] [--metrics-jsonl FILE]
"""

# --use-gmm beta_pose at which the JAX CLI warns that the hard-assignment
# GMM objective itself prefers parking poses in the dominant component
# (its note at smpltpu/pipeline/single.py:56-63)
GMM_BETA_WARN = 10.0


def parse_args(argv):
    """The JAX CLI's parser, option for option (the reference's semantics,
    src/main_single_frame.cpp:115-155)."""
    if len(argv) < 4:
        return None
    opts = {
        "smpl_path": argv[0], "kps_folder": argv[1],
        "img_folder": argv[2], "out_dir": argv[3],
        "max_iters": 100, "beta_pose": 20.0, "beta_shape": 30.0,
        "opt_shape": False, "use_gmm": False, "pose_prior": None,
        "jax_render": False, "multi_start": False, "freeze_scale": False,
        "mesh": 0,
        "frame_chunk": 0,
        "adaptive_start": False,
        "adaptive_thresh": 6.0,
        "adaptive_propagate": False,
        "profile": False, "metrics_jsonl": None,
        "orient_init": True,
    }
    seen_numeric = 0
    rest = list(argv[4:])
    while rest:
        a = rest.pop(0)
        if a == "--opt-shape":
            opts["opt_shape"] = True
        elif a == "--use-gmm":
            opts["use_gmm"] = True
        elif a == "--pose-prior" and rest:
            opts["pose_prior"] = rest.pop(0)
        elif a == "--jax-render":
            opts["jax_render"] = True
        elif a == "--multi-start":
            opts["multi_start"] = True
        elif a == "--adaptive-start":
            opts["adaptive_start"] = True
        elif a == "--adaptive-thresh" and rest:
            opts["adaptive_thresh"] = float(rest.pop(0))
        elif a == "--adaptive-propagate":
            opts["adaptive_propagate"] = True
        elif a == "--profile":
            opts["profile"] = True
        elif a == "--metrics-jsonl" and rest:
            opts["metrics_jsonl"] = rest.pop(0)
        elif a == "--no-orient-init":
            opts["orient_init"] = False
        elif a == "--freeze-scale":
            opts["freeze_scale"] = True
        elif a == "--mesh" and rest:
            opts["mesh"] = max(0, int(float(rest.pop(0))))
        elif a == "--frame-chunk" and rest:
            opts["frame_chunk"] = max(0, int(float(rest.pop(0))))
        elif is_number(a):
            if seen_numeric == 0:
                opts["max_iters"] = max(1, int(float(a)))
            elif seen_numeric == 1:
                opts["beta_pose"] = float(a)
            elif seen_numeric == 2:
                opts["beta_shape"] = float(a)
            seen_numeric += 1
        else:
            print(f"[WARN] Unknown arg ignored: {a}", file=sys.stderr)
    return opts


def main(argv=None, *, device="cuda", mesh=None) -> int:
    """The CLI on ``device``. ``mesh``: run as this rank of a mesh (the
    launcher's workers pass theirs; tests may run ranks as threads); else
    ``--mesh N`` makes one, starting a process a rank when it has more
    than one."""
    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    if opts is None:
        print(USAGE, end="")
        return 0
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false; this CLI "
              "runs on the card (main(argv, device='cpu') runs it on the "
              "CPU from Python)", file=sys.stderr)
        return 1
    # --mesh 0: every visible card (one rank on the CPU)
    mesh_n = opts["mesh"] if opts["mesh"] > 0 else mesh_size(0, dev)
    return mesh_main(lambda m: _run(opts, dev if m is None else m.device,
                                    mesh_n, m),
                     __spec__.name, argv, mesh_n, device, opts["out_dir"],
                     mesh)


def _run(opts, dev, mesh_n, mesh) -> int:
    """The run, on ``mesh``'s rank when there is one (then ranks other than
    0 leave after the last sharded call)."""
    print(f"[ARGS] max_iters={opts['max_iters']}  beta_pose={opts['beta_pose']}"
          f"  beta_shape={opts['beta_shape']}  opt_shape={str(opts['opt_shape']).lower()}"
          f"  use_gmm={str(opts['use_gmm']).lower()}")

    os.makedirs(opts["out_dir"], exist_ok=True)
    dtype = torch.float32
    try:
        # the single-frame main's own loader defaults midpoint visibility
        # to 0.0 (src/main_single_frame.cpp:78)
        ds = load_dataset(opts["smpl_path"], opts["kps_folder"],
                          opts["img_folder"], midpoint_default_vis=0.0,
                          device=dev, dtype=dtype,
                          pose_prior_path=opts["pose_prior"])
        require_smpl_width(ds["model"].num_joints, ds["model"].hand_pca(),
                           "the single-frame CLI (SMPL's held joints)")
    except UnsupportedModelError as e:
        print(f"UnsupportedModelError: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    model, cam = ds["model"], ds["cam"]
    gmm = ds["gmm"] if opts["use_gmm"] else None
    n_comps = 0 if ds["gmm"] is None else len(ds["gmm"]["weights"])
    print(f"Pose prior components: {n_comps}  "
          f"(GMM {'ON' if opts['use_gmm'] else 'OFF'})")
    if opts["use_gmm"] and gmm is None:
        print("[WARN] --use-gmm requested but no pose_prior.txt found; "
              "falling back to L2 pose prior", file=sys.stderr)
    if opts["use_gmm"] and gmm is not None \
            and opts["beta_pose"] >= GMM_BETA_WARN:
        print(f"[WARN] --use-gmm at beta_pose={opts['beta_pose']:g} >= "
              f"{GMM_BETA_WARN:g}: the hard-assignment GMM objective "
              "measurably prefers parking non-dominant-component poses in "
              "the dominant basin at this weight (tens of px data error; "
              "docs/ROADMAP.md GMM entry). Consider a lower beta_pose "
              "and/or --multi-start (prior-seeded starts).",
              file=sys.stderr)

    prob = make_single_frame_problem(
        model, init_root_rotation(), cam,
        beta_pose=opts["beta_pose"], beta_shape=opts["beta_shape"],
        opt_shape=opts["opt_shape"], gmm_dict=gmm,
        freeze_scale=opts["freeze_scale"])
    kp = ds["kp_batch"]
    n_frames = kp.shape[0]
    print(f"[INFO] devices visible: {mesh_size(0, dev)}  mesh size: "
          f"{mesh_n if mesh is not None else 1}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def fitter_of(max_iters):
        if mesh is None:
            return build_fitter(prob, max_iters=max_iters, device=dev,
                                dtype=dtype, chunk=opts["frame_chunk"])
        # the frame batch sharded over the mesh, each call padded to a
        # multiple of the mesh size with rows of masked keypoints (they
        # converge at once to their init) and the pad stripped; the
        # chunking happens on each rank's block
        base = build_fitter(prob, max_iters=max_iters, device=dev,
                            dtype=dtype)
        multiple = math.lcm(mesh_n, mesh.size)

        def fit(x0_b, kp_b):
            n = x0_b.shape[0]
            pad = (-n) % multiple
            x0_b = torch.cat([x0_b, x0_b[-1:].expand(pad, -1)])
            kp_b = torch.cat([kp_b, kp_b.new_zeros((pad,) + kp_b.shape[1:])])
            st = sharded_frame_fit(mesh, base, x0_b, kp_b,
                                   chunk=opts["frame_chunk"])
            return LMResult(*(f[:n] for f in st))
        return fit

    if opts["adaptive_start"]:
        return _main_adaptive(opts, ds, prob, kp, fitter_of, sync, dtype,
                              mesh)

    if opts["multi_start"]:
        # data-driven init x root-yaw hypotheses [+ a start per GMM
        # component mean], all fitted as one batch, the lowest-cost start
        # kept per frame (solve/init.py)
        n_extra = model.num_shapes if opts["opt_shape"] else 0
        seeds = (np.asarray(gmm["means"])
                 if gmm is not None and opts["beta_pose"] > 0.0 else None)
        starts = make_start_set(kp, prob.spec, cam, n_extra_dims=n_extra,
                                pose_seeds=seeds,
                                orient=opts["orient_init"])
        s_dim = starts.shape[1]
        x0 = starts.reshape(n_frames * s_dim, -1)
        kp_fit = np.repeat(kp, s_dim, axis=0)
    else:
        s_dim = 1
        x0_one = init_frame_params(device="cpu", dtype=dtype).numpy()
        if opts["opt_shape"]:
            x0_one = np.concatenate([x0_one, np.zeros(model.num_shapes,
                                                      np.float32)])
        x0 = np.tile(x0_one, (n_frames, 1))
        kp_fit = kp
    x0 = torch.as_tensor(np.asarray(x0)).to(device=dev, dtype=dtype)
    kp_dev = torch.as_tensor(kp_fit).to(device=dev, dtype=dtype)

    rank = 0 if mesh is None else mesh.rank
    metrics = MetricsLogger(jsonl_path=opts["metrics_jsonl"] if rank == 0
                            else None)
    profile_dir = (os.path.join(opts["out_dir"], "profile")
                   if opts["profile"] and rank == 0 else None)
    timer = StageTimer()
    fitter_of(1)(x0, kp_dev)        # warm-up: one LM trip of the same solve
    sync()
    warm_ms = timer.ms()
    timer = StageTimer()
    with profile_trace(profile_dir):
        state = fitter_of(opts["max_iters"])(x0, kp_dev)
        sync()
    total_ms = timer.ms()
    print(f"[INFO] batched solve: {total_ms:.1f} ms for {n_frames} frames"
          f"{f' x {s_dim} starts' if s_dim > 1 else ''} "
          f"(+{warm_ms:.0f} ms one-trip warm-up)")
    per_frame_ms = total_ms / max(n_frames, 1)
    metrics.log("single_solve", ms=total_ms, frames=n_frames,
                starts=s_dim, warmup_ms=warm_ms)
    metrics.close()
    if rank:
        return 0

    if s_dim > 1:
        best_x, best_cost, best_idx = best_of_starts(state, n_frames, s_dim)
        x_final = best_x
        # converged flag and loss history of the selected start of each
        # frame (not start 0, not a minimum across starts)
        rows_sel = np.arange(n_frames)
        conv = state.converged.cpu().numpy().reshape(
            n_frames, s_dim)[rows_sel, best_idx]
        cost = best_cost
        hist_src = state.cost_history.cpu().numpy().reshape(
            n_frames, s_dim, -1)[rows_sel, best_idx]
    else:
        x_final = state.x.cpu().numpy()
        conv = state.converged.cpu().numpy()
        cost = state.cost.cpu().numpy()
        hist_src = state.cost_history.cpu().numpy()
    return _emit_outputs(opts, ds, model, cam, kp, x_final, conv, cost,
                         hist_src, per_frame_ms)


def _main_adaptive(opts, ds, prob, kp, fitter_of, sync, dtype,
                   mesh) -> int:
    """--adaptive-start (solve/init.py::fit_adaptive)."""
    model, cam = ds["model"], ds["cam"]
    n_frames = kp.shape[0]
    if opts["multi_start"]:
        print("[WARN] --adaptive-start supersedes --multi-start",
              file=sys.stderr)

    def run(fitter):
        return fit_adaptive(prob, kp, opts["max_iters"],
                            px_thresh=opts["adaptive_thresh"],
                            fitter=fitter, dtype=dtype,
                            orient=opts["orient_init"],
                            propagate=opts["adaptive_propagate"])
    timer = StageTimer()
    run(fitter_of(1))               # warm-up: one LM trip a phase
    sync()
    warm_ms = timer.ms()
    timer = StageTimer()
    res = run(fitter_of(opts["max_iters"]))
    sync()
    total_ms = timer.ms()
    print(f"[INFO] adaptive solve: {total_ms:.1f} ms for {n_frames} frames "
          f"({res.hard_idx.size} above {opts['adaptive_thresh']:.1f}px "
          f"multi-started, {int(res.escalated.sum())} improved; "
          f"+{warm_ms:.0f} ms one-trip warm-up)")
    if mesh is not None and mesh.rank:
        return 0
    per_frame_ms = total_ms / max(n_frames, 1)
    return _emit_outputs(opts, ds, model, cam, kp, res.x, res.converged,
                         res.cost, res.cost_history, per_frame_ms)


def _emit_outputs(opts, ds, model, cam, kp, x_final, conv, cost, hist_src,
                  per_frame_ms) -> int:
    """Shared output tail: per-frame evaluation, renders, log.csv, params
    npz, loss_curve.txt."""
    n_frames = kp.shape[0]
    params = x_final[:, :N_FRAME_PARAMS]
    shapes = (x_final[:, N_FRAME_PARAMS:] if opts["opt_shape"]
              else np.zeros((n_frames, model.num_shapes)))
    r0 = np.asarray(init_root_rotation())
    errors, verts = batched_frame_eval(
        model, params, shapes, np.tile(r0, (n_frames, 1, 1)), kp, cam)

    rows = []
    valid_frames = kp[:, :, 3].sum(axis=1) > 0
    for i in range(n_frames):
        if i >= len(ds["images"]):
            # the reference stops at the first missing image
            # (src/main_single_frame.cpp:194 'break')
            print(f"No image for frame {i}", file=sys.stderr)
            break
        # the reference skips a frame whose image it cannot read (:195
        # 'continue'): no log row either
        img = imread(ds["images"][i])
        if img is None:
            print(f"Failed to read {ds['images'][i]}", file=sys.stderr)
            continue
        if not valid_frames[i]:
            print(f"Frame {i} has no valid keypoints; skipping.", file=sys.stderr)
            continue
        rows.append((i, float(errors[i]), per_frame_ms))
        render_overlay_image(
            model, verts[i], ds["images"][i],
            os.path.join(opts["out_dir"], f"frame_{i}_render.png"), cam,
            use_jax=opts["jax_render"], img=img)
    append_log(opts["out_dir"], rows)
    save_params(opts["out_dir"], "params_single.npz", params, shapes,
                extra={"converged": conv, "cost": cost})
    # per-trip loss curve, the mean over frames with keypoints
    hist = hist_src[valid_frames].mean(axis=0)
    with open(os.path.join(opts["out_dir"], "loss_curve.txt"), "w") as f:
        f.write("iteration,loss\n")
        for it, c in enumerate(hist):
            f.write(f"{it},{c}\n")
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
