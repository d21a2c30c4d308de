"""The control of ``correct``: the plain reference put in the program's
place, computed in another precision, and judged by the same comparison.

    python3 -m benchmark.control --workload <cell> --seeds <n> ... [--prec tf32|f32] [--seconds s]

For a video cell it fits and renders the first video of each seed
(``--video k``: the k-th), the same model, keypoints and sampled frames a
benchmark run of that seed makes, by ``reference.py``'s two-stage fit
(stage 1 on the anchors, the anchors interpolated into the window starts,
stage 2 on every window, the configuration's dogleg and CG steps) and its
render. For a live feed it calibrates the shape on the first frames and
fits the frames of a ``--seconds`` window one by one, on the feed the cell
replays with its ``data_seed`` set to the seed (three seeds, three feeds).
``tf32`` rounds every matrix product's operands to TF32 (the nearest
precision below the float32 the configurations state, TF32 off): the
control, which has to come out not correct. ``f32``: the same in float32,
which has to pass. One JSON line a seed on stdout: the numbers compared
and their limits.

The benchmark's own runs never run this; it needs a CUDA device unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from benchmark import gen, judge, spec
from benchmark import reference as ref


def reference_video(cfg, model, kp, sample_idx, prec: ref.Prec, device):
    """The configuration's video path by the reference: -> judge.VideoOut."""
    body = ref.make_body(model, prec, device)
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    c1, c2 = judge.stage_cfgs(cfg)
    fit = cfg["fit"]
    from benchmark.runners.video import cg_steps
    n = kp.shape[0]
    cg = cg_steps(cfg, n)
    lay = judge.Layout.of(cfg, n)
    dt = prec.dtype
    kp = kp.to(device=device, dtype=dt)
    r0 = torch.as_tensor(ref.R0, device=device, dtype=dt)
    n_a = len(lay.anchor_idx)
    s1 = ref.multi_lm(body, cam, c1, ref.init_params(n_a, device, dt)[None],
                      torch.zeros((1, ref.N_SHAPES), device=device, dtype=dt),
                      kp[lay.anchor_idx][None], r0.expand(1, n_a, 3, 3),
                      torch.ones((1, n_a), device=device, dtype=dt),
                      fit["stage1"]["max_iters"], cg)
    p0w = judge.interp_starts(lay, s1.params[0], ref.init_params(1, device, dt)[0])
    kpw, vw = lay.windows(kp)
    w_n = len(lay.starts)
    s2 = ref.multi_lm(body, cam, c2, p0w, s1.shape.expand(w_n, -1), kpw,
                      r0.expand(w_n, lay.wsize, 3, 3), vw,
                      fit["stage2"]["max_iters"], cg)
    fp = torch.empty((n, ref.P_DIM), device=device, dtype=dt)
    for wi, s in enumerate(lay.starts):
        e = min(s + lay.wsize, n)
        fp[s:e] = s2.params[wi, :e - s]
    rc = cfg["render"]
    verts = ref.smpl_vertices(body, fp[sample_idx], s1.shape[0], r0)
    gray, covered = ref.rasterize(verts, body.faces, cam, rc["height"], rc["width"])
    return judge.VideoOut(
        kp=kp, s1_params=s1.params[0], s1_shape=s1.shape[0], s1_cost=s1.cost[0],
        s1_iters=s1.iters[0], s2_params=s2.params, s2_shape=s2.shape,
        s2_cost=s2.cost, s2_iters=s2.iters, frame_params=fp, shape=s1.shape[0],
        sample_idx=sample_idx, gray=gray, covered=covered)


def video_control(cell, seed, prec, device, video=0):
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    n = tr["frames"]
    model = gen.make_model(dev, gen.sub_seed(seed, 0), **cfg["model_sizes"])
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    kp = gen.video_keypoints(model, cam, tr, seed, video, dev)
    rng = np.random.default_rng(gen.sub_seed(seed, 3))
    idx = torch.as_tensor(np.sort(rng.choice(n, tr["render_checked_frames"],
                                             replace=False)), device=dev)
    out = reference_video(cfg, model, kp, idx, prec, dev)
    return judge.video_checks(cfg, model, [out], [out], dev)


def stream_control(cell, seed, prec, device, seconds):
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    tr = dict(tr, data_seed=seed)
    model = gen.make_model(dev, gen.sub_seed(seed, 0), **cfg["model_sizes"])
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    count = int(np.ceil(seconds * tr["rate_fps"]))
    n_cal = cfg["calibration"]["frames"]
    kp = gen.feed_keypoints(model, cam, tr, n_cal + count, dev)
    body = ref.make_body(model, prec, dev)
    dt = prec.dtype
    kp = kp.to(dt)
    r0 = torch.as_tensor(ref.R0, device=dev, dtype=dt)
    on, cal = cfg["online"], cfg["calibration"]
    ccfg = ref.MultiCfg(on["beta_pose"], cal["beta_shape"], on["lambda_t"])
    c = ref.multi_lm(body, cam, ccfg, ref.init_params(n_cal, dev, dt)[None],
                     torch.zeros((1, ref.N_SHAPES), device=dev, dtype=dt),
                     kp[:n_cal][None], r0.expand(1, n_cal, 3, 3),
                     torch.ones((1, n_cal), device=dev, dtype=dt), cal["max_iters"], 0)
    shape = c.shape[0]
    ocfg = ref.OnlineCfg(on["beta_pose"], on["lambda_t"])
    prev = c.params[0, -1:]
    one = torch.ones(1, device=dev, dtype=dt)
    xs, costs, iters = [], [], []
    for f in range(n_cal, n_cal + count):
        r = ref.online_lm(body, cam, ocfg, prev, shape, kp[f:f + 1], prev, one, r0,
                          on["max_iters"])
        xs.append(r.params[0])
        costs.append(r.cost[0])
        iters.append(r.iters[0])
        prev = r.params
    out = judge.StreamOut(kp=kp[n_cal:], x=torch.stack(xs), cost=torch.stack(costs),
                          iters=torch.stack(iters), x_start=c.params[0, -1],
                          shape=shape, calib_kp=kp[:n_cal], calib_params=c.params[0])
    return judge.stream_checks(cfg, model, out, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--prec", default="tf32", choices=("tf32", "f32"))
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--video", type=int, default=0,
                   help="which video of the seed's pool (video cells)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = spec.cell(spec.load_bench(root), args.workload, root)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = ref.Prec(args.prec)
    for seed in args.seeds:
        if cell.config["runner"] == "stream":
            secs = args.seconds or spec.load_bench(root)["run_seconds"]
            checks = stream_control(cell, seed, prec, args.device, secs)
        else:
            checks = video_control(cell, seed, prec, args.device, args.video)
        print(json.dumps({"workload": cell.name, "seed": seed, "prec": args.prec,
                          "correct": all(c.ok for c in checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
