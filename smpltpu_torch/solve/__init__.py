"""Solvers (port of ``smpltpu/solve``): the batched LM with its exact trust
region and the single-frame fit on it, the multi-frame LM, its exact
block-tridiagonal solves (elimination and cyclic reduction), the chunked
window fit, the fused two-stage
pipeline, the data-driven frame initialization with its multi-start
fits, and the online (streaming) fit over a CUDA graph of one LM trip."""

from smpltpu_torch.solve.init import (  # noqa: F401
    AdaptiveResult,
    aa_from_rotation,
    aa_from_rotation_batch,
    best_of_starts,
    build_px_eval,
    estimate_frame_init,
    estimate_frame_init_batch,
    estimate_root_orient,
    estimate_root_orient_batch,
    fit_adaptive,
    make_start_set,
    rest_joints_cam,
    rotation_from_aa,
    rotation_from_aa_batch,
)
from smpltpu_torch.solve.lm import LMConfig, LMResult, LMState, lm_solve  # noqa: F401
from smpltpu_torch.solve.multi_frame import (  # noqa: F401
    MultiFrameConfig,
    MultiFrameResult,
    MultiFrameState,
    build_chunked_window_fit,
    build_multi_fitter,
    fit_multi_frame,
)
from smpltpu_torch.solve.online import (  # noqa: F401
    OnlineConfig,
    OnlineFitter,
    OnlineGraph,
    OnlinePump,
    build_online_scan,
    build_online_step,
)
from smpltpu_torch.solve.single_frame import (  # noqa: F401
    SingleFrameProblem,
    build_fitter,
    fit_frames,
    make_single_frame_problem,
)
from smpltpu_torch.solve.tridiag import (  # noqa: F401
    block_tridiag_solve,
    block_tridiag_solve_cr,
)
from smpltpu_torch.solve.two_stage import build_fused_two_stage  # noqa: F401
