"""The control of ``correct`` for configuration ``multi_smplx``: the plain
SMPL-X reference in the program's place, in another precision, judged by
the same comparison (``control.py``'s video control on this model).

    python3 -m benchmark.control_smplx --workload video10k_smplx --seeds <n> ... [--prec tf32|f32] [--video k]

For each seed it fits and renders the seed's first video (``--video k``:
the k-th), the model, keypoints and sampled frames a benchmark run of
that seed makes, by ``reference_smplx.py``'s two-stage fit and render.
``tf32`` rounds every matrix product's operands to TF32 and has to come
out not correct; ``f32`` has to pass. One JSON line a seed on stdout.
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

from benchmark import gen, gen_smplx, judge, spec
from benchmark import reference as ref
from benchmark import reference_smplx as refx
from benchmark.runners.video import cg_steps


def reference_video(cfg, model, kp, sample_idx, prec: ref.Prec, device):
    """The configuration's video path by the reference: -> judge.VideoOut."""
    body = refx.make_body(model, prec, device)
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    c1, c2 = judge.stage_cfgs(cfg)
    fit = cfg["fit"]
    n = kp.shape[0]
    cg = cg_steps(cfg, n)
    lay = judge.Layout.of(cfg, n)
    dt = prec.dtype
    kp = kp.to(device=device, dtype=dt)
    r0 = torch.as_tensor(ref.R0, device=device, dtype=dt)
    n_a = len(lay.anchor_idx)
    s1 = refx.multi_lm(body, cam, c1, refx.init_params(n_a, device, dt)[None],
                       torch.zeros((1, refx.N_BETAS), device=device, dtype=dt),
                       kp[lay.anchor_idx][None], r0.expand(1, n_a, 3, 3),
                       torch.ones((1, n_a), device=device, dtype=dt),
                       fit["stage1"]["max_iters"], cg)
    p0w = judge.interp_starts(lay, s1.params[0], refx.init_params(1, device, dt)[0])
    kpw, vw = lay.windows(kp)
    w_n = len(lay.starts)
    s2 = refx.multi_lm(body, cam, c2, p0w, s1.shape.expand(w_n, -1), kpw,
                       r0.expand(w_n, lay.wsize, 3, 3), vw,
                       fit["stage2"]["max_iters"], cg)
    fp = torch.empty((n, refx.P_DIM), device=device, dtype=dt)
    for wi, s in enumerate(lay.starts):
        e = min(s + lay.wsize, n)
        fp[s:e] = s2.params[wi, :e - s]
    rc = cfg["render"]
    verts = refx.smplx_vertices(body, fp[sample_idx], s1.shape[0], r0)
    gray, covered = ref.rasterize(verts, body.faces, cam, rc["height"], rc["width"])
    return judge.VideoOut(
        kp=kp, s1_params=s1.params[0], s1_shape=s1.shape[0], s1_cost=s1.cost[0],
        s1_iters=s1.iters[0], s2_params=s2.params, s2_shape=s2.shape,
        s2_cost=s2.cost, s2_iters=s2.iters, frame_params=fp, shape=s1.shape[0],
        sample_idx=sample_idx, gray=gray, covered=covered)


def video_control(cell, seed, prec, device, video=0):
    cfg, tr = cell.config, dict(cell.traffic, seed=seed)
    dev = torch.device(device)
    n = tr["frames"]
    model = gen_smplx.make_model(dev, gen.sub_seed(seed, 0), **cfg["model_sizes"])
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    kp = gen_smplx.video_keypoints(model, cam, tr, seed, video, dev)
    rng = np.random.default_rng(gen.sub_seed(seed, 3))
    idx = torch.as_tensor(np.sort(rng.choice(n, tr["render_checked_frames"],
                                             replace=False)), device=dev)
    out = reference_video(cfg, model, kp, idx, prec, dev)
    return refx.video_checks(cfg, model, [out], [out], dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control_smplx")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--prec", default="tf32", choices=("tf32", "f32"))
    p.add_argument("--video", type=int, default=0)
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
        checks = video_control(cell, seed, prec, args.device, args.video)
        print(json.dumps({"workload": cell.name, "seed": seed, "prec": args.prec,
                          "correct": all(c.ok for c in checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
