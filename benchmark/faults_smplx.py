"""Faults planted under the timed path of ``video10k_smplx`` (``faults.py``'s
``plant``), and the judge's readings of them at the cell's size on the
card, for configuration ``multi_smplx``.

    python3 -m benchmark.faults_smplx --workload video10k_smplx --seeds <n> ... [--videos 2] [--fault half|noanchor]

For each seed: the cell's program built as a benchmark run builds it
(``runners/video_smplx.py``), its first ``--videos`` videos fitted and
rendered through the timed path, and one JSON line with the numbers
compared and the readings they come from. Without ``--fault`` these are
sound runs. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import faults, gen_smplx, spec
from benchmark import reference as ref
from benchmark import reference_smplx as refx
from benchmark.runners import common, video_smplx


def readings(cell, seed: int, n_videos: int, device) -> dict:
    cfg = cell.config
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    tr = dict(cell.traffic, seed=seed)
    one_video, model = video_smplx.build(cfg, tr, device)
    outs = [one_video(gen_smplx.video_keypoints(model, cam, tr, seed, k, device)
                      .cpu().numpy())["out"] for k in range(n_videos)]
    del one_video
    common.free(device)
    r = refx.video_readings(cfg, model, outs, device)
    checks = refx.video_checks(cfg, model, outs, [], device)
    return {"correct": all(c.ok for c in checks),
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks},
            "problems": int(r["capped"].numel()), "capped": int(r["capped"].sum()),
            "start_share_q50_90_99_max": faults._q(r["start_share"], [0.5, 0.9, 0.99, 1.0]),
            "newton_uncapped_q50_90_max": faults._q(r["newton_gap"][~r["capped"]],
                                                     [0.5, 0.9, 1.0]),
            "cost_gap_max": float(r["cost_gap"].max()),
            "fit_px": [float(x) for x in r["fit_px"]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.faults_smplx")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--videos", type=int, default=2)
    p.add_argument("--fault", choices=faults.FAULTS, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        faults.plant(args.fault)
    cell = spec.cell(spec.load_bench(), args.workload)
    for seed in args.seeds:
        line = readings(cell, seed, args.videos, torch.device(args.device))
        print(json.dumps(dict(workload=cell.name, seed=seed, fault=args.fault, **line)),
              flush=True)
        common.free(torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
