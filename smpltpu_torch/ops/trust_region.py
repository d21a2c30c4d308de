"""K5: the online LM trip's trust-region step in one launch.

``tr_step(h, g, radius, newton_iters)`` has ``solve/lm.py::chol_tr_step``'s
contract and method: for N problems, the pinned h (N, P, P), g (N, P) and
radius (N,) -> (step (N, P), boundary (N,) bool), the More-Sorensen step
by ``newton_iters`` Cholesky-Newton trips on the secular equation. On
CPU tensors it is ``chol_tr_step`` itself, the plain version; on CUDA
tensors it launches the hand-written kernel ``csrc/tr_step.cu`` (one CTA
a problem; the note there says what bounds it) or raises.
"""

from __future__ import annotations

import torch

from smpltpu_torch import _build
from smpltpu_torch.ops import LAUNCHES

MAX_P = 96          # csrc/tr_step.cu: kMaxP


def tr_step(h, g, radius, newton_iters: int):
    """``chol_tr_step(h, g, radius, newton_iters)`` for CPU tensors; K5 for
    CUDA tensors (float32 or float64, contiguous, P <= ``MAX_P``). Counts
    its launches in ``LAUNCHES["tr_step"]``; a launch recorded into a CUDA
    graph counts there too, and whoever replays the graph moves the count
    to the replays (``solve/online.py::OnlineGraph``)."""
    dev = h.device
    if dev.type == "cpu":
        # imported here: smpltpu_torch.solve imports this module
        from smpltpu_torch.solve.lm import chol_tr_step
        return chol_tr_step(h, g, radius, newton_iters)
    if dev.type != "cuda":
        raise ValueError(f"tr_step: no kernel for device {dev}")
    n, p = g.shape[0], g.shape[-1]
    for name, a, want in (("h", h, (n, p, p)), ("g", g, (n, p)),
                          ("radius", radius, (n,))):
        if (a.dtype != h.dtype or a.device != dev or tuple(a.shape) != want
                or not a.is_contiguous()):
            raise ValueError(f"tr_step: {name} must be a contiguous {h.dtype} "
                             f"{want} on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if h.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"tr_step: no kernel for {h.dtype}")
    if not (n >= 1 and 1 <= p <= MAX_P and newton_iters >= 0):
        raise ValueError(f"tr_step: {n} problems of {p} unknowns, "
                         f"{newton_iters} Newton trips; the kernel takes "
                         f"N >= 1 and 1 <= P <= {MAX_P}")
    lib = _build.load()
    fn = (lib.smpltpu_tr_step_f32 if h.dtype == torch.float32
          else lib.smpltpu_tr_step_f64)
    step = torch.empty((n, p), dtype=h.dtype, device=dev)
    boundary = torch.empty(n, dtype=torch.bool, device=dev)
    err = fn(h.data_ptr(), g.data_ptr(), radius.data_ptr(), step.data_ptr(),
             boundary.data_ptr(), n, p, int(newton_iters),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tr_step: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["tr_step"] += 1
    return step, boundary
