"""Solver write-back: packed frame vectors -> full-model pose (port of
``smpltpu/utils/writeback.py``). The optimized root angle-axis is composed
with the fixed initial orientation, non-root joints get R(jointAA_j), the
root position becomes rootT, and (reference quirk) the Sim3 scale is
discarded: it is returned for logging only."""

from __future__ import annotations

from typing import NamedTuple

import torch

from smpltpu_torch.energy.params import unpack_frame_params
from smpltpu_torch.models.smpl import rodrigues


class Pose(NamedTuple):
    rotations: torch.Tensor  # (..., nJ, 3, 3) local rotations (row 0 = root)
    root_pos: torch.Tensor   # (..., 3)
    scale: torch.Tensor      # (...) informational; NOT applied


def params_to_pose(params_vec: torch.Tensor, r0: torch.Tensor,
                   n_joints: int, hands=None) -> Pose:
    """params (..., P), r0 (..., 3, 3) -> Pose with the same leading axes;
    ``hands``: a whole-body model's hand space (``SMPLModel.hand_pca``)."""
    fp = unpack_frame_params(params_vec, n_joints, hands)
    root_rot = rodrigues(fp.root_aa) @ r0
    rotations = torch.cat([root_rot[..., None, :, :],
                           rodrigues(fp.joint_aa)], dim=-3)
    return Pose(rotations=rotations, root_pos=fp.root_t, scale=fp.scale)
