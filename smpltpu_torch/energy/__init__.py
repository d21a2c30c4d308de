"""Costs of the fits (port of ``smpltpu/energy``)."""

from smpltpu_torch.energy.params import (  # noqa: F401
    N_FRAME_PARAMS,
    FrameParams,
    frame_param_layout,
    pack_frame_params,
    unpack_frame_params,
)
from smpltpu_torch.energy.priors import (  # noqa: F401
    GMMPrior,
    gmm_pose_prior_residual,
    l2_pose_prior_residual,
    shape_prior_residual,
)
from smpltpu_torch.energy.reproj import (  # noqa: F401
    Camera,
    SkeletonSpec,
    keypoint_residuals,
    make_skeleton_spec,
    project,
    skeleton_joints_cam,
)
from smpltpu_torch.energy.robust import huber_block_weights  # noqa: F401
from smpltpu_torch.energy.temporal import temporal_residuals  # noqa: F401
