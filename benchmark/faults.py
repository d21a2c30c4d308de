"""Faults planted under a video cell's timed path, and the judge's readings
of them at the cell's own size on the card.

    python3 -m benchmark.faults --workload video1k --seeds <n> ... [--videos 3] [--fault half|noanchor]

For each seed: the cell's program built as a benchmark run builds it, its
first ``--videos`` videos fitted and rendered through the timed path, and
one JSON line with the numbers compared and the readings they come from
(quantiles of ``start_share`` and of ``newton_gap`` over the uncapped
problems). Without ``--fault`` these are sound runs, from which the lower
readings come. The faults (``plant``):

* ``half``: stage 2 solves the first half of the windows and hands back
  the other half at their starts, with zero trips (half of the batch
  left out);
* ``noanchor``: every window starts from the default pose instead of
  stage 1's anchors interpolated.

The benchmark's own runs never run this; ``test_bm_faults.py`` plants
the same faults at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import gen, judge, spec
from benchmark import reference as ref
from benchmark.runners import common, video

FAULTS = ("half", "noanchor")


def plant(fault: str, setattr_=setattr) -> None:
    """Break the fused two-stage fit underneath the timed path;
    ``setattr_`` sets each patch (a test's ``monkeypatch.setattr``)."""
    import smpltpu_torch.solve.two_stage as two_stage
    from smpltpu_torch.solve.multi_frame import MultiFrameResult
    if fault == "half":
        real = two_stage.build_multi_fitter
        built = []

        def build(spec_, cam, cfg, n_shapes, *, device, dtype):
            fit = real(spec_, cam, cfg, n_shapes, device=device, dtype=dtype)
            built.append(fit)
            if len(built) % 2 == 1:                  # stage 1
                return fit
            zero = real(spec_, cam, cfg._replace(max_iters=0), n_shapes,
                        device=device, dtype=dtype)

            def half(p0, shape0, kp, r0, valid):     # shape0 (nS,) is every window's
                st = fit(p0, shape0, kp, r0, valid)
                h = p0.shape[0] // 2
                rest = zero(p0[h:], shape0, kp[h:], r0[h:], valid[h:])
                joined = [torch.cat([s[:h], r]) for s, r in zip(st[:-1], rest[:-1])]
                return MultiFrameResult(*joined, cost_history=st.cost_history)
            return half
        setattr_(two_stage, "build_multi_fitter", build)
    elif fault == "noanchor":
        def default(ap, seg, hi, t):
            return ref.init_params(t.shape[0], ap.device, ap.dtype)
        setattr_(two_stage, "interpolate_anchors", default)
    else:
        raise ValueError(f"no fault {fault!r}; there are {FAULTS}")


def _q(v: torch.Tensor, qs):
    v = v.double()
    return [float(torch.quantile(v, q)) for q in qs] if v.numel() else []


def readings(cell, seed: int, n_videos: int, device) -> dict:
    cfg = cell.config
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    tr = dict(cell.traffic, seed=seed)
    one_video, model = video.build(cfg, tr, device)
    outs = [one_video(gen.video_keypoints(model, cam, tr, seed, k, device).cpu().numpy())["out"]
            for k in range(n_videos)]
    del one_video
    common.free(device)
    r = judge.video_readings(cfg, model, outs, device)
    checks = judge.video_checks(cfg, model, outs, [], device)
    return {"correct": all(c.ok for c in checks),
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks},
            "problems": int(r["capped"].numel()), "capped": int(r["capped"].sum()),
            "start_share_q50_90_99_max": _q(r["start_share"], [0.5, 0.9, 0.99, 1.0]),
            "newton_uncapped_q50_90_max": _q(r["newton_gap"][~r["capped"]], [0.5, 0.9, 1.0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--videos", type=int, default=3)
    p.add_argument("--fault", choices=FAULTS, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        plant(args.fault)
    cell = spec.cell(spec.load_bench(), args.workload)
    for seed in args.seeds:
        line = readings(cell, seed, args.videos, torch.device(args.device))
        print(json.dumps(dict(workload=cell.name, seed=seed, fault=args.fault, **line)),
              flush=True)
        common.free(torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
