"""Multiple devices (port of ``smpltpu/parallel``): the frame or window
batch sharded over ranks of ``torch.distributed``, NCCL on the cards and
gloo on the CPU (``mesh.py``), and the sharded solvers (``sharded.py``)."""

from smpltpu_torch.parallel.mesh import (  # noqa: F401
    FramesMesh,
    frames_mesh,
    mesh_size,
    run_ranks,
    shard_frames,
)
from smpltpu_torch.parallel.sharded import (  # noqa: F401
    GNStepResult,
    build_sharded_gn_step,
    build_sharded_lm_fitter,
    sharded_frame_fit,
    sharded_gn_step,
    sharded_window_fit,
)
