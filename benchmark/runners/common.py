"""What the runners share: the result they hand the harness, device
synchronization, peak memory and the traced unit."""

from __future__ import annotations

import gc
import sys
from typing import NamedTuple, Optional

import torch

from benchmark import trace as tr


class Result(NamedTuple):
    e2e: dict            # end-to-end metrics by name
    ctx: dict            # what the per-layer readers read
    checks: list         # judge.Check of every number compared
    attempted: int
    failed: int
    peak_bytes: int
    traced: Optional[dict]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def log_setup(marks) -> None:
    """One line on stderr: set-up's parts, each (name, seconds since the
    process started at its end), as the seconds each took."""
    prev, parts = 0.0, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log(f"benchmark: setup {prev:.3f} s: " + ", ".join(parts))


def syncer(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def reset_peak(device) -> None:
    """Start the window's reading of the peak device memory."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def trace_unit(fn) -> dict:
    """Run ``fn()`` once under the profiler. -> {"result": fn's result,
    "trace": the digested trace}."""
    out: list = []
    with tr.traced(out):
        res = fn()
    return {"result": res, "trace": out[0]}
