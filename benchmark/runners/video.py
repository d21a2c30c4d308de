"""Whole videos, back to back from one client (configuration ``multi_k1``,
traffic of kind ``videos``).

Each video runs the multi CLI's route under ``--fused-stages
--batched-windows --init-from-anchors --linear pcg_kernel --jax-render``:
from the host keypoints array, the CLI's window packing
(``pipeline.multi.window_inputs``), the fused two-stage fit
(``solve.build_fused_two_stage``, built once in set-up and called once a
video), the per-frame parameters back on the host, written back window
by window as the CLI does (each frame from the last window that holds
it), then every frame rendered on the device
(``pipeline.common.render_frames``: FK, K2, K3). The video ends when its
frames are on the device. The window closes at the end of the first video
to finish after ``seconds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, gen, judge
from benchmark import reference as ref
from benchmark.runners import common


def _program(cfg, model, device):
    """The program's objects for this configuration, made in set-up."""
    from smpltpu_torch.energy import make_skeleton_spec
    from smpltpu_torch.energy.reproj import Camera
    from smpltpu_torch.models.smpl import SMPLModel

    m = SMPLModel(model["v_template"], model["shapedirs"], model["J_regressor"],
                  model["weights"], model["joint_shape_reg"], model["posedirs"],
                  model["faces"].cpu().numpy(), model["parents"].cpu().numpy())
    c = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    cam = Camera(*(torch.tensor(v, device=device, dtype=torch.float32) for v in c))
    spec = make_skeleton_spec(m, ref.R0, with_shape=True)
    return m, cam, spec


def cg_steps(cfg, n_frames: int) -> int:
    fit = cfg["fit"]
    return (fit["cg_iters_long"] if n_frames > fit["long_from_frames"]
            else fit["cg_iters"])


def build(cfg, traffic, device):
    """-> (one_video(kp numpy, sampled frames) -> record, the model's
    arrays)."""
    from smpltpu_torch.pipeline.common import render_frames
    from smpltpu_torch.pipeline.multi import window_inputs
    from smpltpu_torch.solve import MultiFrameConfig, build_fused_two_stage

    n = traffic["frames"]
    lay = judge.Layout.of(cfg, n)
    fit = cfg["fit"]
    cg = cg_steps(cfg, n)
    s1, s2 = fit["stage1"], fit["stage2"]
    common_kw = dict(linear=fit["linear"], cg_iters=cg, fused_cost=fit["fused_cost"])
    cfg1 = MultiFrameConfig(beta_pose=s1["beta_pose"], beta_shape=s1["beta_shape"],
                            lambda_temporal=s1["lambda_t"], max_iters=s1["max_iters"],
                            **common_kw)
    cfg2 = MultiFrameConfig(beta_pose=s2["beta_pose"], beta_shape=s2["beta_shape"],
                            lambda_temporal=s2["lambda_t"], max_iters=s2["max_iters"],
                            **common_kw)
    model = gen.make_model(device, gen.sub_seed(traffic["seed"], 0), **cfg["model_sizes"])
    m, cam, spec = _program(cfg, model, device)
    n_s = int(model["shapedirs"].shape[-1])
    fused = build_fused_two_stage(spec, cam, cfg1, cfg2, n_s, lay.anchor_idx,
                                  list(lay.starts), lay.wsize, n, device=device,
                                  dtype=torch.float32)
    rc = cfg["render"]
    r0c = np.asarray(ref.R0, np.float32)
    r0_all = np.tile(r0c, (n, 1, 1))
    default = np.zeros(ref.P_DIM, np.float32)
    default[0], default[6] = 1.0, ref.INIT_DEPTH
    poses = np.tile(default, (n, 1))
    sync = common.syncer(device)

    def t(a):
        return torch.as_tensor(a, device=device, dtype=torch.float32)

    def one_video(kp_np, sample_idx=None):
        t0 = time.perf_counter()
        packs = [window_inputs(s, lay.wsize, poses, r0_all, kp_np, default)
                 for s in lay.starts]
        bk, br, bv = (t(np.stack([p[j] for p in packs])) for j in (2, 3, 4))
        args = (t(poses[lay.anchor_idx]), torch.zeros(n_s, device=device),
                t(kp_np[lay.anchor_idx]), t(r0_all[lay.anchor_idx]), bk, br, bv)
        st1, st2 = fused(*args)
        timings = dict(fused.timings)
        params2 = st2.params.cpu().numpy()
        shape = st1.shape.cpu().numpy()
        frame_params = np.empty((n, params2.shape[-1]), np.float32)
        for wi, s in enumerate(lay.starts):
            e = packs[wi][0]
            frame_params[s:e] = params2[wi][:e - s]
        t1 = time.perf_counter()
        gray, covered = render_frames(m, frame_params, shape, r0c, cam,
                                      rc["height"], rc["width"])
        sync()
        t2 = time.perf_counter()
        out = judge.VideoOut(
            kp=torch.as_tensor(kp_np), s1_params=st1.params, s1_shape=st1.shape,
            s1_cost=st1.cost, s1_iters=st1.iters_run, s2_params=st2.params,
            s2_shape=st2.shape, s2_cost=st2.cost, s2_iters=st2.iters_run,
            frame_params=torch.as_tensor(frame_params),
            shape=torch.as_tensor(shape), sample_idx=sample_idx,
            gray=None if sample_idx is None else gray[sample_idx],
            covered=None if sample_idx is None else covered[sample_idx])
        del gray, covered
        return {"out": out, "frames": n, "seconds": t2 - t0,
                "stage1_s": timings["stage1_s"], "stage2_s": timings["stage2_s"],
                "render_s": t2 - t1, "trips1": int(st1.iters_run),
                "trips2": int(st2.iters_run.max()), "windows": len(lay.starts)}

    return one_video, model


def run(cfg, traffic, seed, seconds, trace, clock, device):
    traffic = dict(traffic, seed=seed)
    dev = torch.device(device)
    n = traffic["frames"]
    marks = [("start, imports", clock.since_start())]
    one_video, model = build(cfg, traffic, dev)
    marks.append(("model, program", clock.since_start()))
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    pool = [gen.video_keypoints(model, cam, traffic, seed, k, dev).cpu().numpy()
            for k in range(traffic["videos"] + 1)]
    rng = np.random.default_rng(gen.sub_seed(seed, 3))
    marks.append(("inputs", clock.since_start()))
    one_video(pool[-1])                       # warm-up: every shape once, untimed
    common.reset_peak(dev)
    setup_s = clock.since_start()
    marks.append(("warm-up video", setup_s))
    common.log_setup(marks)
    videos = []
    t0 = time.perf_counter()
    while True:
        k = len(videos)
        if k == traffic["videos"]:
            raise RuntimeError(f"the window holds more than the traffic's "
                               f"{traffic['videos']} videos: raise its 'videos'")
        idx = None
        if k < traffic["render_checked_videos"]:
            idx = torch.as_tensor(np.sort(rng.choice(n, traffic["render_checked_frames"],
                                                     replace=False)), device=dev)
        videos.append(one_video(pool[k], idx))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    frames = sum(v["frames"] for v in videos)
    common.log("benchmark: videos " + " ".join(
        f"{v['seconds']:.3f}s({v['stage1_s']:.3f}+{v['stage2_s']:.3f}+{v['render_s']:.3f};"
        f"{v['trips1']}+{v['trips2']})" for v in videos))
    e2e = {"video_fps": frames / window_s, "setup_s": setup_s}
    ctx = {"videos": videos, "window_s": window_s, "cfg": cfg,
           "model_sizes": cfg["model_sizes"]}
    traced = None
    if trace:
        traced = common.trace_unit(lambda: one_video(pool[-1]))
        ctx.update(traced_video=traced["result"], trace=traced["trace"])
    peak = common.peak_bytes(dev)
    outs = [v["out"] for v in videos]
    for v in videos:
        del v["out"]
    del one_video
    common.free(dev)
    checks = judge.video_checks(cfg, model, outs,
                                [o for o in outs if o.sample_idx is not None], dev)
    if trace:
        _render_work(ctx, cfg, model, outs, dev)
    return common.Result(
        e2e=e2e, ctx=ctx, checks=checks, attempted=len(videos),
        failed=sum(1 for o in outs if not torch.isfinite(o.frame_params).all()),
        peak_bytes=peak, traced=traced)


def _render_work(ctx, cfg, model, outs, dev):
    """The per-layer readers' counts that depend on the inputs of the
    render: the box pixels of every video of the window (``box_px``) and
    of the traced one (``traced_box_px``), from the reference's
    vertices."""
    body = ref.make_body(model, ref.F64, dev)
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    rc = cfg["render"]
    r0 = torch.as_tensor(ref.R0, device=dev, dtype=torch.float64)

    def box(o):
        fp = o.frame_params.to(dev, torch.float64)
        sh = o.shape.to(dev, torch.float64)
        return sum(ref.box_pixels(ref.smpl_vertices(body, fp[s:s + 100], sh, r0),
                                  body.faces, cam, rc["height"], rc["width"])
                   for s in range(0, fp.shape[0], 100))
    ctx["box_px"] = [box(o) for o in outs]
    ctx["traced_box_px"] = box(ctx["traced_video"]["out"])


def video_work(v: dict, box_px: int, cfg: dict) -> counts.Work:
    """The analytic work of one video: both stages' LM trips as run (every
    window of a batch computes on every trip of the batch), the skinning
    and the raster of every frame."""
    sz = cfg["model_sizes"]
    n = v["frames"]
    n_a = len(range(0, n, cfg["fit"]["anchor_every"]))
    cg = cg_steps(cfg, n)
    kp_rows = 2 * 17
    w1 = counts.stage_solver(1, n_a, ref.P_DIM, ref.N_SHAPES, kp_rows, v["trips1"], cg, "pcg_kernel")
    w2 = counts.stage_solver(v["windows"], cfg["fit"]["window"], ref.P_DIM, ref.N_SHAPES,
                             kp_rows, v["trips2"], cg, "pcg_kernel")
    chunks = -(-n // 100)
    w3 = counts.stage_lbs(n, sz["n_verts"])
    rc = cfg["render"]
    w4 = counts.k3_work(n, chunks, sz["n_verts"], sz["n_faces"], box_px,
                        rc["height"], rc["width"])
    return counts.Work(w1.flops + w2.flops + w3.flops + w4.flops,
                       w1.bytes + w2.bytes + w3.bytes + w4.bytes)
