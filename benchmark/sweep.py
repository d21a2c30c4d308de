"""The live feed's knee, found by a sweep on the card.

    python3 -m benchmark.sweep --workload stream_steady --seed <n> --rates 26 30 ... [--frames 1400]

One set-up (as a benchmark run of the cell), then, at each rate in turn,
the pump restarted from the calibrated state and fed the cell's frames
after the calibration, ``--frames`` of them, each due at that rate. For
each rate one JSON line: latency p50 and p95 (ms, from the due time), how
late the submits started in the first and in the last tenth (their
medians, ms), and ``backlog``: whether that lateness grew by more than a
frame's period. The knee is the highest rate the pump sustains: no growing
backlog, and a p95 within 1.5 times the lowest rate's (above it, queues
that form in the feed's harder stretches set the tail). The cell's rate
is four fifths of the knee (of the lower, where two sweeps disagree).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark import spec
from benchmark.runners import stream


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=1750)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = spec.cell(spec.load_bench(root), args.workload, root)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    cfg = cell.config
    n_cal = cfg["calibration"]["frames"]
    tr = dict(cell.traffic, seed=args.seed, frames=n_cal + args.frames)
    fitter, _, kp = stream.build(cfg, tr, torch.device("cuda"))
    fitter.calibrate(kp[:n_cal], max_iters=cfg["calibration"]["max_iters"],
                     beta_shape=cfg["calibration"]["beta_shape"])
    pump = fitter.make_pump()
    pump.start(fitter.prev, fitter.shape, fitter.has_prev)
    pump.submit(kp[0])
    pump.stop()
    for rate in args.rates:
        pump.start(fitter.prev, fitter.shape, fitter.has_prev)
        _, _, trips, lat, late = stream.feed(pump, kp, n_cal, args.frames, rate,
                                             time.perf_counter())
        pump.stop()
        k = max(1, args.frames // 10)
        l0, l1 = float(np.median(late[:k])), float(np.median(late[-k:]))
        print(json.dumps({
            "rate_fps": rate, "frames": args.frames,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "late_start_ms": l0 * 1e3, "late_end_ms": l1 * 1e3,
            "trips_mean": float(np.mean(trips)),
            "backlog": bool(l1 - l0 > 1.0 / rate)}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
