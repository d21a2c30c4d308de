"""Evaluation metric: mean 2D pixel reprojection error (port of
``smpltpu/utils/metrics.py``). It projects the FULL model's posed joints
(shape applied, solver scale NOT applied, see utils/writeback.py) and
averages the pixel distance over the observed keypoints; the duplicated
pelvis slot counts twice, as in the reference."""

from __future__ import annotations

import torch

from smpltpu_torch.energy.reproj import Camera, gather_joints, project


def mean_pixel_error(joints_world: torch.Tensor, kp_dense: torch.Tensor,
                     cam: Camera) -> torch.Tensor:
    """joints_world (..., nJ, 3), kp_dense (..., K, 4). Returns (...) mean
    pixel error over valid slots, 0 where a frame has none."""
    pred = project(gather_joints(joints_world, kp_dense), cam)
    d = torch.linalg.norm(pred - kp_dense[..., 1:3], dim=-1)
    valid = kp_dense[..., 3]
    n = torch.sum(valid, dim=-1)
    return torch.where(n > 0, torch.sum(d * valid, dim=-1)
                       / torch.clamp(n, min=1.0), torch.zeros_like(n))
