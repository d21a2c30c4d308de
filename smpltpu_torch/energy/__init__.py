"""Costs of the multi-frame fit (port of ``smpltpu/energy``)."""

from smpltpu_torch.energy.reproj import (  # noqa: F401
    Camera,
    SkeletonSpec,
    keypoint_residuals,
    make_skeleton_spec,
    project,
    skeleton_joints_cam,
)
