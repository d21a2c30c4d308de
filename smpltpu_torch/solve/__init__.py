"""Solvers (port of ``smpltpu/solve``): the multi-frame LM and the fused
two-stage pipeline."""

from smpltpu_torch.solve.multi_frame import (  # noqa: F401
    MultiFrameConfig,
    MultiFrameResult,
    MultiFrameState,
    build_multi_fitter,
)
from smpltpu_torch.solve.two_stage import build_fused_two_stage  # noqa: F401
