"""Reading a ``torch.profiler`` trace of a stretch of the run: the device's
operations (kernels, copies, fills) with their intervals, the host's
operations, and what the per-layer readers take from them: busy seconds
(the union of the device's intervals), device time by kernel name, the
operations that took most time and the idle gaps by what the host was
doing. The trace's raw records are read once (``kineto_results``); no
Chrome trace is written.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import Counter
from typing import List, NamedTuple, Tuple

import torch

WINDOW = "bm.window"


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: List[Op]       # sorted by start
    host: List[Op]         # host operations and annotations
    start_ns: int          # the traced window
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _annotation(ev) -> bool:
    """A span the program or the benchmark marked, not an operation."""
    try:
        return bool(ev.is_user_annotation())
    except (AttributeError, RuntimeError):
        return False


def _on_device(ev) -> bool:
    return "cuda" in str(ev.device_type()).lower()


@contextlib.contextmanager
def traced(out: list):
    """Profile the block (host and device), then append its ``Trace`` to
    ``out``. The block's span is marked by the ``bm.window`` annotation."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out.append(digest(prof))


def digest(prof) -> Trace:
    device, host = [], []
    start = end = None
    for ev in prof.profiler.kineto_results.events():
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        name = ev.name()
        if _on_device(ev):
            if name != WINDOW and not _annotation(ev):
                device.append(Op(name, s, e))
            continue
        if name == WINDOW:
            start, end = s, e
        host.append(Op(name, s, e))
    device.sort(key=lambda o: o.start_ns)
    if start is None:
        every = device + host
        start = min(o.start_ns for o in every)
        end = max(o.end_ns for o in every)
    end = max([end] + [o.end_ns for o in device])
    return Trace(device, host, start, end)


def busy(tr: Trace) -> List[Tuple[int, int]]:
    """The union of the device's intervals inside the window."""
    out: List[Tuple[int, int]] = []
    for o in tr.device:
        s, e = max(o.start_ns, tr.start_ns), min(o.end_ns, tr.end_ns)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in busy(tr)) * 1e-9


def kernel_time(tr: Trace, patterns) -> Tuple[float, int]:
    """(device seconds, operations) of the device operations whose name
    matches any of the regular expressions ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    sel = [o for o in tr.device if any(r.search(o.name) for r in rx)]
    return sum(o.end_ns - o.start_ns for o in sel) * 1e-9, len(sel)


def top_ops(tr: Trace, n: int = 10):
    """[[name, device seconds]] of the ``n`` operations that took most."""
    tot: Counter = Counter()
    for o in tr.device:
        tot[o.name[:160]] += (o.end_ns - o.start_ns) * 1e-9
    return [[k, v] for k, v in tot.most_common(n)]


def idle_gaps(tr: Trace, n: int = 10):
    """[[what the host was doing, idle seconds]] of the ``n`` host
    activities under which the device sat idle longest: each gap between
    busy intervals is charged to the innermost host operation running at
    its middle."""
    spans = busy(tr)
    edges = [tr.start_ns] + [x for se in spans for x in se] + [tr.end_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host = sorted((o for o in tr.host if o.name != WINDOW),
                  key=lambda o: o.start_ns)
    starts = [o.start_ns for o in host]
    tot: Counter = Counter()
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for o in reversed(host[max(0, i - 400):i]):
            if o.end_ns >= mid and (best is None or
                                    o.end_ns - o.start_ns < best.end_ns - best.start_ns):
                best = o
        tot[(best.name[:120] if best else "python (no traced host op)")] += (e - s) * 1e-9
    return [[k, v] for k, v in tot.most_common(n)]
