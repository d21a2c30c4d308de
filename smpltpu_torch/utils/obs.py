"""Observability (port of ``smpltpu/utils/obs.py``): metrics sink, spans
and profiling.

  * MetricsLogger — per-event metrics to a JSONL sink beside the
    pipeline's log.csv (--metrics-jsonl); the reference's class without
    its wandb sink;
  * span — a named range of the program (``torch.profiler.record_function``)
    while a profiler records, and nothing otherwise;
  * profile_trace — a context manager that records ``torch.profiler``
    (host operators, the program's spans, and the card's kernels where
    there is one) and writes a Chrome trace into a directory (--profile on
    the multi CLI).

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

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` over its block in the trace of an
    active ``torch.profiler`` (host time on the profiler's clock; the
    block's device work nests under it), or a shared no-op when no profiler
    records. Unguarded, ``record_function`` costs about two aten calls even
    with no profiler; the guard costs one flag read."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class MetricsLogger:
    """Tiny metrics logger: one JSON line an event to ``jsonl_path``; a
    no-op without one."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._jsonl = open(jsonl_path, "a")

    def log(self, event: str, **fields) -> None:
        if self._jsonl is not None:
            rec = {"ts": time.time(), "event": event, **fields}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str]):
    """Record the block under ``torch.profiler`` and write its Chrome trace
    to ``out_dir/trace_<k>.json`` (k counts the traces already there, so
    each profiled stage of a run keeps its own file); no-op when out_dir
    is None."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    k = len(glob.glob(os.path.join(out_dir, "trace_*.json")))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{k}.json"))
