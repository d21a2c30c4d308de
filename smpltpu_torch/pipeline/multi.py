"""``3dba_multi``-compatible CLI on the card (port of
``smpltpu/pipeline/multi.py``): two-stage multi-frame fitting, anchor
frames with a shared shape, then sliding-window refinement.

    python -m smpltpu_torch.pipeline.multi <SMPL.npz> <kps_folder>
        <image_folder> <out_dir> [max_iters_s1=1000] [max_iters_s2=500]
        [anchor_skip=10] [window=20] [overlap=5] [beta_pose=5.0]
        [beta_shape=25.0] [lambda_temp=3.0] [flags]

The model may be SMPL or SMPL-X (an SMPL-X npz, or ``synthetic_smplx``):
SMPL-X is fitted in its whole-body layout (P = 94: the body's 21 joint
angles and 12 PCA coefficients a hand) to 47 keypoint slots, whose frame
files are MediaPipe Holistic objects (``io/keypoints.py``); the paths
built for SMPL's joints (``--multi-start``, ``--data-init``, ``--mesh``)
refuse it with ``UnsupportedModelError``.

It reads MediaPipe JSONs and frames, fits, and writes ``log.csv``
(anchors, then every frame), ``params_multi.npz``, ``loss_curve.txt``, one
overlay ``frame_<i>_multi.png`` per frame and a checkpoint per window.
Everything runs on the card: the fit (with K1 under
``--linear pcg_kernel``), the evaluation's skinning (K2), and with
``--jax-render`` each frame's raster (K3). From Python, ``main(argv,
device="cpu")`` runs it on the CPU (the tests do); nothing falls back to
the CPU or to a plain version by itself, and with no CUDA device the
command says so and exits non-zero.

Reference quirks reproduced deliberately, as in the JAX package
(SURVEY.md section 2.1):
  * max_iters_s2 is parsed but stage 2 runs a hard-coded 60 iterations
    (src/main_multi_frame.cpp:30 vs :186); --s2-iters overrides it;
  * stage-1 anchor poses are NOT copied back into the global pose array
    (:113-119): anchors contribute through the shared shape and each
    anchor's root orientation r[0] only;
  * the per-frame fixed root orientation accumulates across solves
    (r[0] <- R(rootAA) @ r[0], MultiFrameBA.h:163) while the pose array
    keeps the optimized rootAA; ``r0_fit`` keeps the R0 each pose was
    fitted under, for its evaluation and render;
  * stage 2 keeps betaShape = 1e5 as a shape lock (:163,183), and one
    shape is carried across windows;
  * log.csv rows carry each window's time amortized over its frames.

Framework extensions, as in the JAX package: --batched-windows (all
windows as one batch), --init-from-anchors, --fused-stages (stage 1,
interpolation and stage 2 in one call of solve/two_stage.py; it needs
--batched-windows --init-from-anchors and no --window-chunk, else a
warning and the sequential stages), --window-chunk N, --resume,
--metrics-jsonl, --profile (torch.profiler traces under out_dir/profile),
--jax-render, --pose-prior, --linear tridiag|cr|pcg|pcg_block|pcg_kernel,
--cg-rtol, --multi-start (every frame seeded by its best-of-starts
single-frame fit), --data-init, --orient-init, --s2-iters, --mesh N.

``--mesh N`` (N > 1; 0 means every visible card, one rank on the CPU)
takes the reference's sharded route (``parallel/sharded.py``): stage 1 is
the frame-sharded LM on the anchors, padded to a multiple of N with
frame_valid = 0 rows, and the batched stage 2 is window data parallelism,
padded with all-invalid windows (``--window-chunk`` composes with it). On
CUDA it runs ``min(N, cards)`` ranks over NCCL, one process a card; on the
CPU N ranks over gloo, one process each (``parallel/launch.py``); with
one card it is one rank in this process. Rank 0 does the evaluation, the
render and every write.

Differences from the JAX CLI:
  * the fused path is timed after a warm-up call, as the sequential
    stages are: on the card the first call builds the kernels, so its
    ``time_ms`` excludes that (the JAX fused path's includes its compile);
  * a warm-up call runs one LM trip of the solve it precedes (the JAX
    CLI's run the whole solve, which XLA compiles for its iteration
    count): one trip launches every kernel and library call of the solve,
    so the fit is not run twice;
  * --ckpt-backend orbax is not ported (orbax is a JAX library): the
    command exits with a message naming its ROADMAP.md entry;
  * ``--jax-render`` has no fallback to another rasterizer;
  * ``--window-chunk`` with ``--cg-rtol`` gives each window the result of
    the unchunked batch (the port's PCG, plain and K1, ends each window's
    CG on its own residual), so the JAX CLI's warning that chunk width
    changes the optima there is not printed;
  * more than 128 windows in one batch: the note says that on the card one
    batch is the faster route and ``--window-chunk`` bounds device memory
    (the JAX CLI advises chunks of 67 against the slowest window's tail,
    from TPU measurements).
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from smpltpu_torch.constants import init_root_rotation
from smpltpu_torch.energy import make_skeleton_spec
from smpltpu_torch.energy.params import hand_comps, init_frame_params
from smpltpu_torch.models.smpl import UnsupportedModelError, require_smpl_width
from smpltpu_torch.parallel import (
    build_sharded_lm_fitter,
    mesh_size,
    sharded_window_fit,
)
from smpltpu_torch.parallel.launch import mesh_main
from smpltpu_torch.pipeline.common import (
    StageTimer,
    append_log,
    batched_frame_eval,
    load_dataset,
    np_rodrigues,
    render_overlay_image,
    save_params,
)
from smpltpu_torch.solve import (
    MultiFrameConfig,
    build_chunked_window_fit,
    build_fused_two_stage,
    build_multi_fitter,
)
from smpltpu_torch.solve.init import (
    best_of_starts,
    estimate_frame_init_batch,
    make_start_set,
    rest_joints_cam,
)
from smpltpu_torch.solve.single_frame import build_fitter, make_single_frame_problem
from smpltpu_torch.utils.ckpt import ORBAX_REFUSED, load_checkpoint, save_checkpoint
from smpltpu_torch.utils.obs import MetricsLogger, profile_trace

USAGE = """usage: python -m smpltpu_torch.pipeline.multi <SMPL.npz|SMPLX.npz|synthetic[_smplx]> <kps_folder> <image_folder> <out_dir>
             [max_iters=120] [max_iters_stage2=120] [anchor_skip=15] [window=30] [overlap=10]
             [beta_pose=5.0] [beta_shape=25.0]
"""

SHAPE_LOCK = 1e5  # src/main_multi_frame.cpp:163
S2_ITERS_DEFAULT = 60  # hard-coded in the reference (:186)


def parse_args(argv):
    """The JAX CLI's argv parser, option for option (the port refuses some
    of the values it accepts later, in :func:`refused`)."""
    if len(argv) < 4:
        return None
    opts = {
        "smpl_path": argv[0], "kps_folder": argv[1],
        "img_folder": argv[2], "out_dir": argv[3],
        "max_iters_s1": 1000, "max_iters_s2": 500, "skip": 10,
        "wsize": 20, "overlap": 5, "beta_pose": 5.0, "beta_shape": 25.0,
        "lambda_t": 3.0, "s2_iters": S2_ITERS_DEFAULT,
        "batched_windows": False, "pose_prior": None,
        "resume": False, "profile": False, "metrics_jsonl": None,
        "init_from_anchors": False, "jax_render": False, "data_init": False,
        "multi_start": False,
        "orient_init": False,
        "mesh": 0,
        # arrowhead linear solver (MultiFrameConfig.linear); "tridiag" is
        # the library default, the exact elimination
        "linear": "tridiag",
        # pcg tolerance exit (MultiFrameConfig.cg_rtol); 0 = fixed trips
        "cg_rtol": 0.0,
        "ckpt_backend": "npz",
        # --batched-windows chunk size (0 = one batch)
        "window_chunk": 0,
        "fused_stages": False,
    }
    positional = ["max_iters_s1", "max_iters_s2", "skip", "wsize", "overlap",
                  "beta_pose", "beta_shape", "lambda_t"]
    ints = {"max_iters_s1", "max_iters_s2", "skip", "wsize", "overlap"}
    pos_idx = 0
    rest = list(argv[4:])
    while rest:
        a = rest.pop(0)
        if a == "--batched-windows":
            opts["batched_windows"] = True
        elif a == "--resume":
            opts["resume"] = True
        elif a == "--init-from-anchors":
            opts["init_from_anchors"] = True
        elif a == "--data-init":
            opts["data_init"] = True
        elif a == "--multi-start":
            opts["multi_start"] = True
        elif a == "--orient-init":
            opts["orient_init"] = True
        elif a == "--fused-stages":
            opts["fused_stages"] = True
        elif a == "--no-orient-init":
            opts["orient_init"] = False
        elif a == "--jax-render":
            opts["jax_render"] = True
        elif a == "--profile":
            opts["profile"] = True
        elif a == "--metrics-jsonl" and rest:
            opts["metrics_jsonl"] = rest.pop(0)
        elif a == "--s2-iters" and rest:
            opts["s2_iters"] = max(1, int(float(rest.pop(0))))
        elif a == "--mesh" and rest:
            opts["mesh"] = max(0, int(float(rest.pop(0))))
        elif a == "--window-chunk" and rest:
            opts["window_chunk"] = max(0, int(float(rest.pop(0))))
        elif a == "--pose-prior" and rest:
            opts["pose_prior"] = rest.pop(0)
        elif a == "--cg-rtol" and rest:
            opts["cg_rtol"] = float(rest.pop(0))
        elif a == "--linear" and rest:
            opts["linear"] = rest.pop(0)
            if opts["linear"] not in ("tridiag", "cr", "pcg", "pcg_block",
                                      "pcg_kernel"):
                print(f"--linear must be tridiag|cr|pcg|pcg_block|"
                      f"pcg_kernel, got {opts['linear']!r}", file=sys.stderr)
                return None
        elif a == "--ckpt-backend" and rest:
            opts["ckpt_backend"] = rest.pop(0)
            if opts["ckpt_backend"] not in ("npz", "orbax"):
                print(f"--ckpt-backend must be npz|orbax, got "
                      f"{opts['ckpt_backend']!r}", file=sys.stderr)
                return None
        elif pos_idx < len(positional):
            key = positional[pos_idx]
            opts[key] = int(float(a)) if key in ints else float(a)
            pos_idx += 1
        else:
            print(f"[WARN] Unknown arg ignored: {a}", file=sys.stderr)
    return opts


def refused(opts) -> str | None:
    """Why the port cannot run these options, or None."""
    if opts["ckpt_backend"] == "orbax":
        return f"--ckpt-backend orbax: {ORBAX_REFUSED}"
    return None


def _pad_window(arr, start, end, wsize):
    """Slice [start:end) padded to wsize along axis 0."""
    out = np.zeros((wsize,) + arr.shape[1:], dtype=arr.dtype)
    out[:end - start] = arr[start:end]
    return out


def interpolate_from_anchors(poses, anchor_idx, anchor_params):
    """``--init-from-anchors``: seed every frame of ``poses`` (N, P), in
    place, from the anchor optima (A, P), linearly between consecutive
    anchors and holding the last anchor to the video's end."""
    n_frames, n_a = len(poses), len(anchor_idx)
    for k, fid in enumerate(anchor_idx):
        a = fid
        b = anchor_idx[k + 1] if k + 1 < n_a else n_frames
        pb = anchor_params[k + 1] if k + 1 < n_a else anchor_params[k]
        poses[a] = anchor_params[k]
        for i in range(a + 1, min(b, n_frames)):
            w = (i - a) / max(b - a, 1)
            poses[i] = (1.0 - w) * anchor_params[k] + w * pb


def window_inputs(s, wsize, poses, r0, kp, default_pose):
    """(end, params, keypoints, R0, frame_valid) of the window at frame
    s, numpy, padded to wsize."""
    n_frames = len(poses)
    e = min(s + wsize, n_frames)
    valid = np.zeros(wsize, np.float32)
    valid[:e - s] = 1.0
    # pad with the DEFAULT pose (scale 1, z 3), not zeros: a zero pose
    # puts padded joints at z=0 whose residuals would blow up the cost
    wp = np.tile(default_pose, (wsize, 1))
    wp[:e - s] = poses[s:e]
    wr = np.tile(np.eye(3, dtype=np.float32), (wsize, 1, 1))
    wr[:e - s] = r0[s:e]
    return e, wp, _pad_window(kp, s, e, wsize), wr, valid


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
    why = refused(opts)
    if why is not None:
        print(why, file=sys.stderr)
        return 1
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false; this CLI "
              "runs on the card (main(argv, device='cpu') runs it on the "
              "CPU from Python)", file=sys.stderr)
        return 1
    os.makedirs(opts["out_dir"], exist_ok=True)
    # --mesh 0: every visible card (one rank on the CPU)
    mesh_n = opts["mesh"] if opts["mesh"] > 0 else mesh_size(0, dev)
    return mesh_main(lambda m: _run(opts, dev if m is None else m.device,
                                    mesh_n, m),
                     __spec__.name, argv, mesh_n, device, opts["out_dir"],
                     mesh)


def _run(opts, dev, mesh_n, mesh) -> int:
    """The run, on ``mesh``'s rank when there is one (then ranks other than
    0 leave after the last sharded call)."""
    rank = 0 if mesh is None else mesh.rank
    dtype = torch.float32
    try:
        ds = load_dataset(opts["smpl_path"], opts["kps_folder"],
                          opts["img_folder"], midpoint_default_vis=1.0,
                          device=dev, dtype=dtype,
                          pose_prior_path=opts["pose_prior"])
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if len(ds["images"]) != len(ds["json_paths"]):
        print("image / json count mismatch", file=sys.stderr)
        return 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    def one_trip(cfg):
        return cfg._replace(max_iters=1)

    def warm_up(spec_w, cfg, args):
        """One LM trip of the solve ``cfg`` runs, on ``args``: the kernels
        are built and the libraries' handles made before the timed call."""
        build_multi_fitter(spec_w, cam, one_trip(cfg), model.num_betas,
                           device=dev, dtype=dtype)(*args)

    model, cam = ds["model"], ds["cam"]
    # a whole-body model (SMPL-X) runs the fit and the render; the paths
    # built for SMPL's joints refuse it by name
    smpl_only = [what for on, what in (
        (opts["multi_start"], "--multi-start (single-frame fits)"),
        (opts["data_init"], "--data-init (SMPL's rest joints)"),
        (mesh is not None, "--mesh (the sharded solvers)")) if on]
    for what in smpl_only:
        try:
            require_smpl_width(model.num_joints, model.hand_pca(), what)
        except UnsupportedModelError as e:
            print(f"UnsupportedModelError: {e}", file=sys.stderr)
            return 1
    n_frames = ds["kp_batch"].shape[0]
    print(f"[INFO] frames: {opts['img_folder']}  = {n_frames:4d}\n"
          f"[INFO] anchor skip     : {opts['skip']}\n"
          f"[INFO] window / overlap: {opts['wsize']} / {opts['overlap']}\n"
          f"[INFO] beta_pose={opts['beta_pose']}  beta_shape={opts['beta_shape']}"
          f"  lambda_temp={opts['lambda_t']}")
    print(f"[INFO] devices visible: {mesh_size(0, dev)}  mesh size: "
          f"{mesh_n if mesh is not None else 1}")
    if opts["window_chunk"] > 0 and not opts["batched_windows"]:
        print("[WARN] --window-chunk only applies with "
              "--batched-windows; ignored on the sequential path",
              file=sys.stderr)

    # Reference parity: stage 1 gets a null jointShapeReg when betaShape
    # == 0 (MultiFrameBA.h:88), leaving shape inert; stage 2 always passes
    # the 1e5 shape lock, so its spec keeps the shape dependence.
    spec = make_skeleton_spec(model, init_root_rotation(),
                              with_shape=opts["beta_shape"] > 0)
    spec_s2 = (spec if opts["beta_shape"] > 0 else
               make_skeleton_spec(model, init_root_rotation(), with_shape=True))
    kp = ds["kp_batch"].astype(np.float32)
    default_pose = init_frame_params(
        model.num_joints, device="cpu", dtype=torch.float32,
        n_hand_comps=hand_comps(spec.hands)).numpy()
    poses = np.tile(default_pose, (n_frames, 1))
    if opts["multi_start"]:
        # framework extension: seed every frame with its best-of-starts
        # single-frame fit (one batched multi-start solve, solve/init.py::
        # make_start_set) before the two-stage chain. freeze_scale=True:
        # the chain freezes the per-frame scale and the log.csv evaluation
        # discards it, and projection is invariant to a uniform scaling
        # about the camera centre, so a (1, t / s) optimum exists for any
        # (s, t) one
        prob_ms = make_single_frame_problem(
            model, init_root_rotation(), cam,
            beta_pose=opts["beta_pose"], beta_shape=opts["beta_shape"],
            freeze_scale=True)
        starts = make_start_set(kp, prob_ms.spec, cam,
                                orient=opts["orient_init"])
        s_dim = starts.shape[1]
        fit_ms = build_fitter(prob_ms, max_iters=100, device=dev, dtype=dtype,
                              chunk=0 if n_frames * s_dim <= 640 else 128)
        st_ms = fit_ms(t(starts.reshape(n_frames * s_dim, -1)),
                       t(np.repeat(kp, s_dim, axis=0)))
        xb, _, _ = best_of_starts(st_ms, n_frames, s_dim)
        poses = np.asarray(xb, np.float32).copy()
        print(f"[INFO] multi-start seeding: {n_frames} frames x {s_dim} "
              "starts, best-of-starts params seed the two-stage chain")
    elif opts["data_init"]:
        # framework extension (the reference inits every frame blindly at
        # s=1, t=(0,0,3)): closed-form per-frame depth and translation from
        # the detections (solve/init.py), seeding both the anchors and the
        # windows; --orient-init adds the root-orientation estimate
        rest = rest_joints_cam(spec)
        n_j = len(spec.parents)
        poses[:] = estimate_frame_init_batch(
            kp[:n_frames], rest, cam, n_joints=n_j,
            orient=opts["orient_init"]).astype(np.float32)
    r0 = np.tile(np.asarray(init_root_rotation(), dtype=np.float32),
                 (n_frames, 1, 1))
    shape_w = np.zeros(model.num_betas, dtype=np.float32)

    metrics = MetricsLogger(jsonl_path=opts["metrics_jsonl"] if rank == 0
                            else None)
    profile_dir = (os.path.join(opts["out_dir"], "profile")
                   if opts["profile"] and rank == 0 else None)

    ckpt_base = os.path.join(opts["out_dir"], "checkpoint_multi")
    ck = None
    if opts["resume"]:
        ck = load_checkpoint(ckpt_base, backend="auto")
        if ck is not None:
            print(f"[INFO] resuming from {ckpt_base}.* "
                  f"(next window start {int(ck['next_start'])})")

    rendered = np.zeros(n_frames, dtype=bool)
    # r0 accumulates write-backs; r0_fit[i] is the R0 in effect when
    # poses[i] was last fitted: evaluation and render pair poses[i] with
    # r0_fit[i] (pairing with the updated r0 would apply rootAA twice)
    r0_fit = r0.copy()
    resume_start = 0
    loss_curve = None

    # ===================== stage 1: anchors =====================
    if ck is not None:
        poses = ck["poses"]
        r0 = ck["r0"]
        r0_fit = ck["r0_fit"]
        shape_w = ck["shape_w"]
        rendered = ck["rendered"].astype(bool)
        resume_start = int(ck["next_start"])
        fused_active = False   # resumed runs keep the sequential stages
        if opts["fused_stages"]:
            print("[WARN] --fused-stages does not apply to a resumed run; "
                  "sequential stages", file=sys.stderr)
    else:
        anchor_idx = list(range(0, n_frames, opts["skip"]))
        print(f"[INFO] stage-1  anchor frames = {len(anchor_idx)}")
        cfg1 = MultiFrameConfig(beta_pose=opts["beta_pose"],
                                beta_shape=opts["beta_shape"],
                                lambda_temporal=opts["lambda_t"],
                                max_iters=opts["max_iters_s1"],
                                linear=opts["linear"],
                                cg_rtol=opts["cg_rtol"])
        n_a = len(anchor_idx)
        fused_active = (opts["fused_stages"] and opts["batched_windows"]
                        and opts["init_from_anchors"] and mesh is None
                        and opts["window_chunk"] == 0)
        if opts["fused_stages"] and not fused_active:
            print("[WARN] --fused-stages needs --batched-windows "
                  "--init-from-anchors on a single chip without "
                  "--window-chunk; falling back to the sequential stages",
                  file=sys.stderr)
        if fused_active:
            # the stage-1 solve and its bookkeeping happen inside the fused
            # call (stage-2 section); --init-from-anchors means no anchor
            # r0 write-back, so r0_fit is just a snapshot
            r0_fit = r0.copy()
        elif mesh is not None:
            # frames sharded over the mesh: the anchor batch padded to a
            # multiple of the mesh size with frame_valid = 0 rows
            if opts["linear"] in ("tridiag", "cr"):
                # the exact elimination is sequential across frame shards
                print(f"[INFO] --linear {opts['linear']} applies to the "
                      "single-chip/window solves; sharded stage-1 uses the "
                      "distributed PCG", file=sys.stderr)
            pad = (-n_a) % math.lcm(mesh_n, mesh.size)
            a_p = np.tile(default_pose, (n_a + pad, 1))
            a_p[:n_a] = poses[anchor_idx]
            a_k = np.zeros((n_a + pad,) + kp.shape[1:], kp.dtype)
            a_k[:n_a] = kp[anchor_idx]
            a_r = np.tile(np.eye(3, dtype=np.float32), (n_a + pad, 1, 1))
            a_r[:n_a] = r0[anchor_idx]
            a_v = np.zeros(n_a + pad, np.float32)
            a_v[:n_a] = 1.0
            fit1 = build_sharded_lm_fitter(mesh, spec, cam, cfg1,
                                           model.num_betas, dtype=dtype)
            args1 = (t(a_p), t(shape_w), t(a_k), t(a_r), t(a_v))
            build_sharded_lm_fitter(mesh, spec, cam, one_trip(cfg1),
                                    model.num_betas, dtype=dtype)(*args1)
            sync()
        else:
            fit1 = build_multi_fitter(spec, cam, cfg1, model.num_betas,
                                      device=dev, dtype=dtype)
            args1 = (t(poses[anchor_idx]), t(shape_w), t(kp[anchor_idx]),
                     t(r0[anchor_idx]))
            warm_up(spec, cfg1, args1)
            sync()
        if not fused_active:
            t1 = StageTimer()
            with profile_trace(profile_dir):
                st1 = fit1(*args1)
                sync()
            ms_anchor = t1.ms()
            ok = bool(torch.isfinite(st1.cost))
            print(f"[INFO] stage-1 done  ({'success' if ok else 'fail'})"
                  f"  in {ms_anchor} ms\n"
                  f"accepted steps: {int(st1.n_accepted)}, final cost: "
                  f"{float(st1.cost):.3f}")
            metrics.log("stage1", ms=ms_anchor, cost=float(st1.cost),
                        accepted=int(st1.n_accepted), anchors=len(anchor_idx))

            anchor_params = st1.params.cpu().numpy()[:n_a]
            shape_w = st1.shape.cpu().numpy()
            loss_curve = st1.cost_history.cpu().numpy()
            if rank == 0:
                anchor_errs, _ = batched_frame_eval(
                    model, anchor_params,
                    np.tile(shape_w, (len(anchor_idx), 1)), r0[anchor_idx],
                    kp[anchor_idx], cam, want_verts=False)
                append_log(opts["out_dir"],
                           [(fid, float(anchor_errs[k]),
                             ms_anchor / len(anchor_idx))
                            for k, fid in enumerate(anchor_idx)])

            if opts["init_from_anchors"]:
                # framework extension: seed the windows from the anchor
                # poses, linearly interpolated between consecutive anchors
                # (R0 untouched, so the interpolated rootAA stays
                # consistent)
                interpolate_from_anchors(poses, anchor_idx, anchor_params)
            else:
                # write-back effects, and only these: anchor poses are
                # deliberately not copied into `poses` (reference quirk)
                for k, fid in enumerate(anchor_idx):
                    r0[fid] = np_rodrigues(anchor_params[k, 1:4]) @ r0[fid]
            r0_fit = r0.copy()

    # ===================== stage 2: sliding windows =====================
    stride = opts["wsize"] - opts["overlap"]
    if stride <= 0:
        print("window must exceed overlap", file=sys.stderr)
        return 1
    starts = list(range(0, n_frames, stride))
    cfg2 = MultiFrameConfig(beta_pose=opts["beta_pose"],
                            beta_shape=SHAPE_LOCK,
                            lambda_temporal=opts["lambda_t"],
                            max_iters=opts["s2_iters"],
                            linear=opts["linear"],
                            cg_rtol=opts["cg_rtol"])
    fit2 = build_multi_fitter(spec_s2, cam, cfg2, model.num_betas,
                              device=dev, dtype=dtype)
    wsize = opts["wsize"]
    eye3 = np.eye(3, dtype=np.float32)

    def save_ckpt(next_start):
        save_checkpoint(ckpt_base,
                        dict(poses=poses, r0=r0, r0_fit=r0_fit,
                             shape_w=shape_w, rendered=rendered,
                             next_start=np.int64(next_start)),
                        backend=opts["ckpt_backend"])

    def finish_window(s, e, fitted, ms_win, r0_solve):
        """Write-back, logging and render of one solved window; r0_solve is
        the per-frame R0 the solve used (in batched mode all windows share
        the post-stage-1 R0 snapshot)."""
        n_w = e - s
        errs, verts = batched_frame_eval(
            model, fitted[:n_w], np.tile(shape_w, (n_w, 1)),
            r0_solve[:n_w], kp[s:e], cam)
        append_log(opts["out_dir"],
                   [(i, float(errs[i - s]), ms_win / n_w) for i in range(s, e)])
        metrics.log("window", start=s, end=e, ms=ms_win,
                    mean_px=float(np.mean(errs)))
        # write-back: poses keep the optimized values; r0 absorbs rootAA
        poses[s:e] = fitted[:n_w]
        r0_fit[s:e] = r0_solve[:n_w]
        for i in range(s, e):
            r0[i] = np_rodrigues(fitted[i - s, 1:4]) @ r0_solve[i - s]
        # render frames no later window touches
        last_fixed = min(e, s + stride)
        for i in range(s, last_fixed):
            if rendered[i] or i >= len(ds["images"]):
                continue
            render_overlay_image(
                model, verts[i - s], ds["images"][i],
                os.path.join(opts["out_dir"], f"frame_{i}_multi.png"), cam,
                use_jax=opts["jax_render"])
            rendered[i] = True
        save_ckpt(next_start=s + stride)

    if resume_start > 0:
        starts = [s for s in starts if s >= resume_start]
    if mesh is not None and mesh.rank and not opts["batched_windows"]:
        return 0    # the sequential windows are rank 0's
    if opts["batched_windows"]:
        packs = [window_inputs(s, wsize, poses, r0, kp, default_pose)
                 for s in starts]
        if opts["window_chunk"] == 0 and mesh is None and len(packs) > 128:
            print(f"[INFO] {len(packs)} windows in one batch: on the card "
                  "one batch is faster than chunks (fewer host-bound LM "
                  "trips); `--window-chunk N` bounds the device memory "
                  "(PERF.md)", file=sys.stderr)
        if mesh is not None:   # all-invalid dummy windows fill the mesh
            packs = packs + [(0, np.tile(default_pose, (wsize, 1)),
                              np.zeros_like(packs[0][2]),
                              np.tile(eye3, (wsize, 1, 1)),
                              np.zeros(wsize, np.float32))] * (
                (-len(packs)) % math.lcm(mesh_n, mesh.size))
        bp, bk, br, bv = (t(np.stack([p[j] for p in packs]))
                          for j in (1, 2, 3, 4))
        bw = t(np.tile(shape_w, (len(packs), 1)))
        if fused_active:
            # stage 1, the anchor interpolation and all windows in one
            # call (solve/two_stage.py); bp and bw are not consumed, the
            # window starts and the shared shape come out of stage 1
            fufit = build_fused_two_stage(
                spec, cam, cfg1, cfg2, model.num_betas, anchor_idx,
                starts, wsize, n_frames, device=dev, dtype=dtype,
                spec2=spec_s2)
            fu_args = (t(poses[anchor_idx]), t(shape_w), t(kp[anchor_idx]),
                       t(r0[anchor_idx]), bk, br, bv)
            print("[INFO] fused two-stage: anchors, interpolation and "
                  "windows in one call (timed after a warm-up call)")
            build_fused_two_stage(
                spec, cam, one_trip(cfg1), one_trip(cfg2), model.num_betas,
                anchor_idx, starts, wsize, n_frames, device=dev, dtype=dtype,
                spec2=spec_s2)(*fu_args)
            sync()
        t2 = StageTimer()
        with profile_trace(profile_dir):
            if fused_active:
                st1f, st2 = fufit(*fu_args)
            elif mesh is not None:
                # data parallelism over the windows; --window-chunk
                # composes (each rank's block in chunks)
                st2 = sharded_window_fit(mesh, fit2, bp, bw, bk, br, bv,
                                         chunk=opts["window_chunk"])
            elif opts["window_chunk"] > 0:
                st2 = build_chunked_window_fit(
                    fit2, opts["window_chunk"])(bp, bw, bk, br, bv)
            else:
                st2 = fit2(bp, bw, bk, br, bv)
            sync()
        ms_total = t2.ms()
        if rank:
            return 0
        params2 = st2.params.cpu().numpy()
        if fused_active:
            # deferred stage-1 bookkeeping: the single call has no stage
            # split, so every log.csv row (anchors and window frames) gets
            # the same amortized per-frame time
            shape_w = st1f.shape.cpu().numpy()
            loss_curve = st1f.cost_history.cpu().numpy()
            anchor_params = st1f.params.cpu().numpy()
            metrics.log("fused_two_stage", ms=ms_total,
                        cost=float(st1f.cost),
                        accepted=int(st1f.n_accepted),
                        anchors=len(anchor_idx), windows=len(starts))
            anchor_errs, _ = batched_frame_eval(
                model, anchor_params,
                np.tile(shape_w, (len(anchor_idx), 1)),
                r0[anchor_idx], kp[anchor_idx], cam, want_verts=False)
            denom = len(anchor_idx) + sum(
                pk[0] - st for pk, st in zip(packs, starts))
            per_frame_ms = ms_total / max(denom, 1)
            append_log(opts["out_dir"],
                       [(fid, float(anchor_errs[k]), per_frame_ms)
                        for k, fid in enumerate(anchor_idx)])
        for wi, s in enumerate(starts):
            e = packs[wi][0]
            ms_w = (per_frame_ms * (e - s) if fused_active
                    else ms_total / len(starts))
            finish_window(s, e, params2[wi], ms_w, packs[wi][3])
    else:
        first = True
        with profile_trace(profile_dir):
            for s in starts:
                e, wp, wk, wr, wv = window_inputs(s, wsize, poses, r0, kp,
                                                  default_pose)
                args2 = (t(wp), t(shape_w), t(wk), t(wr), t(wv))
                if first:  # warm-up, so the first window's time is real
                    warm_up(spec_s2, cfg2, args2)
                    sync()
                    first = False
                print(f"[INFO] window [{s},{e})  solving ...", flush=True)
                t2 = StageTimer()
                st2 = fit2(*args2)
                sync()
                ms_win = t2.ms()
                ok = bool(torch.isfinite(st2.cost))
                print(f"  -> {'OK' if ok else 'FAIL'}  ({ms_win} ms)")
                shape_w = st2.shape.cpu().numpy()  # moves ~0 under the lock
                finish_window(s, e, st2.params.cpu().numpy(), ms_win, wr)

    # tail frames (the last OVERLAP ones): their verts in one batch
    tail = [i for i in range(n_frames)
            if not rendered[i] and i < len(ds["images"])]
    if tail:
        _, tail_verts = batched_frame_eval(
            model, poses[tail], np.tile(shape_w, (len(tail), 1)),
            r0_fit[tail], kp[tail], cam)
        for k, i in enumerate(tail):
            render_overlay_image(
                model, tail_verts[k], ds["images"][i],
                os.path.join(opts["out_dir"], f"frame_{i}_multi.png"), cam,
                use_jax=opts["jax_render"])
            rendered[i] = True
    save_ckpt(next_start=n_frames)

    save_params(opts["out_dir"], "params_multi.npz", poses, shape_w,
                extra={"r0_fit": r0_fit})
    if loss_curve is not None:
        with open(os.path.join(opts["out_dir"], "loss_curve.txt"), "w") as f:
            f.write("iteration,loss\n")
            for it, c in enumerate(loss_curve):
                f.write(f"{it},{c}\n")
    metrics.close()
    print(f"[INFO] rendering finished, saved to  {opts['out_dir']}")
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
