"""The multi-device path across every visible card: a correctness check
for a machine with several CUDA GPUs (``chip_smoke.py`` phase 11 runs the
same code as one rank on one card).

    python3 scripts/mesh_cards_check.py

From the root of a checkout. It prints the cards (``nvidia-smi``), runs
``smpltpu_torch.graft_entry.dryrun_multichip`` over all of them (ranks as
threads, NCCL, the halo by send/receive), then the multi and single CLIs
of ``chip_smoke.py``'s ``CLI_MESH_RUNS`` with ``--mesh <cards>`` as
commands (``parallel/launch.py``: a process a card) on video1, each run's
log.csv mean beside the port's CPU run of the same argv at ``--mesh 2``
(the pin in ``CLI_MESH_RUNS``). Exit code 1 if a run fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import chip_smoke
    from smpltpu_torch import _build, graft_entry

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout, flush=True)
    cards = torch.cuda.device_count()
    print("cards", cards, "torch", torch.__version__, flush=True)
    _build.load()
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(cards, "cuda")
    print("dryrun", time.perf_counter() - t0, json.dumps(out), flush=True)
    kps = os.path.join(HERE, "data", "keypoints", "video1")
    frames = os.path.join(HERE, "data", "frames_annotated", "video1")
    failed = 0
    for label, cli, argv, cpu_mean in chip_smoke.CLI_MESH_RUNS:
        argv = argv[:argv.index("--mesh")] + ["--mesh", str(cards)]
        run = os.path.join(HERE, "build", f"mesh_cards_{label}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"smpltpu_torch.pipeline.{cli}",
             "synthetic", kps, frames, run] + argv
            + ["--metrics-jsonl", run + ".jsonl"],
            capture_output=True, text=True, timeout=600, cwd=HERE)
        wall = time.perf_counter() - t0
        if proc.returncode:
            failed += 1
            print(label, "rc", proc.returncode, proc.stdout[-2000:],
                  proc.stderr[-2000:], flush=True)
            continue
        rows = open(os.path.join(run, "log.csv")).read().splitlines()[1:]
        errs = np.array([float(r.split(",")[1]) for r in rows])
        events = [json.loads(line) for line in open(run + ".jsonl")]
        print(json.dumps({
            "run": label, "mesh": cards, "wall_s": wall, "rows": len(rows),
            "mean_px": float(errs.mean()), "cpu_mesh2_mean_px": cpu_mean,
            "gap_px": abs(float(errs.mean()) - cpu_mean),
            "stage_ms": {e["event"]: e["ms"] for e in events
                         if e["event"] in ("stage1", "single_solve")}}),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
