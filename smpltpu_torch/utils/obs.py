"""Observability (port of ``smpltpu/utils/obs.py``): metrics sinks and
profiling.

  * MetricsLogger — per-event metrics to a JSONL sink and/or wandb (when
    the package is importable), beside the pipeline's log.csv; a copy of
    the reference's class;
  * profile_trace — a context manager that records ``torch.profiler``
    (host operators, and the card's kernels where there is one) and
    writes a Chrome trace into a directory (--profile on the multi CLI).

The reference's ``enable_compile_cache`` configures JAX's compilation
cache and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Tiny multi-sink metrics logger. All sinks optional; no-ops cleanly."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 use_wandb: bool = False, run_name: str = "smpltpu"):
        self._jsonl = None
        self._wandb = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        if use_wandb:
            try:
                import wandb  # type: ignore
                self._wandb = wandb
                wandb.init(project="smpltpu", name=run_name)
            except Exception:
                self._wandb = None

    def log(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({f"{event}/{k}": v for k, v in fields.items()
                             if isinstance(v, (int, float))})

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str]):
    """Record the block under ``torch.profiler`` and write its Chrome trace
    to ``out_dir/trace_<k>.json`` (k counts the traces already there, so
    each profiled stage of a run keeps its own file); no-op when out_dir
    is None."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    k = len(glob.glob(os.path.join(out_dir, "trace_*.json")))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{k}.json"))
