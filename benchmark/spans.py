"""The program's own spans in a digested trace, and what the span metrics
read from them.

The port marks its layer boundaries with ``smpltpu_torch.utils.obs.span``
(``torch.profiler.record_function`` while a profiler records). The digest
keeps those ranges among the host's operations (``trace.Trace.host``), on
the profiler's one clock with the runtime's launch calls and the device's
intervals. The names are frozen here: a span renamed in the program
reads as absent, and the metrics that read it give None, as they do on a
program that has no spans.
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Sequence, Tuple

from benchmark import trace as tr

# solve/two_stage.py::build_fused_two_stage's run
STAGE1, INTERP, STAGE2 = "two_stage.stage1", "two_stage.interp", "two_stage.stage2"
# solve/multi_frame.py::build_multi_fitter's fit: the fit, each trip's
# enqueueing, each read of ``converged``
LM_FIT, LM_TRIP, LM_WAIT = "multi_frame.fit", "multi_frame.trip", "multi_frame.wait"
# pipeline/common.py::render_frames: the call, and per chunk FK, K2, K3
RENDER, FK, LBS, RASTER = "render.frames", "render.fk", "render.lbs", "render.raster"
# solve/online.py: OnlinePump.submit (a frame) and its copies; OnlineGraph.solve
SUBMIT, COPY_IN, COPY_OUT = "online.submit", "online.copy_in", "online.copy_out"
ON_INIT, ON_TRIP, ON_WAIT = "online.init", "online.trip", "online.wait"

PROGRAM = frozenset({STAGE1, INTERP, STAGE2, LM_FIT, LM_TRIP, LM_WAIT, RENDER,
                     FK, LBS, RASTER, SUBMIT, COPY_IN, COPY_OUT, ON_INIT,
                     ON_TRIP, ON_WAIT})

# the runtime calls that put work on the device: kernels, graphs, copies,
# fills (a versioned or per-thread-stream variant of the name counts too)
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|"
                    r"cudaGraphLaunch|cudaMemcpyAsync|cudaMemsetAsync)"
                    r"(_v\d+)?(_pt(sz|ds))?$")


def find(t: tr.Trace, name: str) -> List[tr.Op]:
    """The spans called ``name``, by start."""
    return sorted((o for o in t.host if o.name == name), key=lambda o: o.start_ns)


def total_ns(spans: Sequence[tr.Op]) -> int:
    return sum(o.end_ns - o.start_ns for o in spans)


def mean_ms(spans: Sequence[tr.Op]) -> Optional[float]:
    return 1e-6 * total_ns(spans) / len(spans) if spans else None


def launches_in(t: tr.Trace, spans: Sequence[tr.Op]) -> int:
    """Runtime launch calls (``LAUNCH``) that start inside one of
    ``spans``; spans of one name do not overlap, so none is counted
    twice."""
    starts = sorted(o.start_ns for o in t.host if LAUNCH.match(o.name))
    return sum(bisect.bisect_right(starts, s.end_ns) - bisect.bisect_left(starts, s.start_ns)
               for s in spans)


def covered_ns(outer: tr.Op, inner: Sequence[tr.Op]) -> int:
    """How much of ``outer`` the disjoint spans ``inner`` cover."""
    return sum(max(0, min(o.end_ns, outer.end_ns) - max(o.start_ns, outer.start_ns))
               for o in inner)


def idle(t: tr.Trace) -> List[Tuple[int, int]]:
    """The traced window's gaps between the device's busy intervals."""
    edges = [t.start_ns] + [x for se in tr.busy(t) for x in se] + [t.end_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def _union(spans: Sequence[tr.Op]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for o in sorted(spans, key=lambda o: o.start_ns):
        if out and o.start_ns <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], o.end_ns))
        else:
            out.append((o.start_ns, o.end_ns))
    return out


def unspanned_idle_ns(t: tr.Trace) -> Optional[Tuple[int, int]]:
    """(idle ns, idle ns of the gaps whose middle lies in no span of the
    program) over the traced window; None where the trace holds no span of
    the program or no device operation."""
    mine = _union([o for o in t.host if o.name in PROGRAM])
    if not mine or not t.device:
        return None
    starts = [s for s, _ in mine]
    tot = outside = 0
    for s, e in idle(t):
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        tot += e - s
        if i < 0 or mine[i][1] < mid:
            outside += e - s
    return tot, outside
