"""Per-frame parameter vector layout (port of ``smpltpu/energy/params.py``).

One flat vector per frame:

    [ scale | rootAA(3) | rootT(3) | jointAA[1..nJ-1] (3 each) ]

P = 7 + 3*(nJ-1) = 76 for SMPL's 24 joints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smpltpu_torch.constants import SMPL_NUM_JOINTS


def frame_param_layout(n_joints: int = SMPL_NUM_JOINTS) -> dict:
    """Slice indices into the packed frame vector."""
    return {
        "scale": (0, 1),
        "root_aa": (1, 4),
        "root_t": (4, 7),
        "joint_aa": (7, 7 + 3 * (n_joints - 1)),
        "total": 7 + 3 * (n_joints - 1),
    }


N_FRAME_PARAMS = frame_param_layout()["total"]  # 76


class FrameParams(NamedTuple):
    """Unpacked view of (a batch of) frame parameters."""

    scale: torch.Tensor     # (...)
    root_aa: torch.Tensor   # (..., 3)
    root_t: torch.Tensor    # (..., 3)
    joint_aa: torch.Tensor  # (..., nJ-1, 3) for joints 1..nJ-1


def pack_frame_params(fp: FrameParams) -> torch.Tensor:
    """The flat vector of one frame's unpacked parameters (inverse of
    :func:`unpack_frame_params` for a single frame)."""
    return torch.cat([
        torch.reshape(fp.scale, (1,)),
        fp.root_aa,
        fp.root_t,
        fp.joint_aa.reshape(-1),
    ])


def unpack_frame_params(vec: torch.Tensor,
                        n_joints: int = SMPL_NUM_JOINTS) -> FrameParams:
    lay = frame_param_layout(n_joints)
    return FrameParams(
        scale=vec[..., 0],
        root_aa=vec[..., lay["root_aa"][0]:lay["root_aa"][1]],
        root_t=vec[..., lay["root_t"][0]:lay["root_t"][1]],
        joint_aa=vec[..., lay["joint_aa"][0]:lay["joint_aa"][1]].reshape(
            vec.shape[:-1] + (n_joints - 1, 3)),
    )


def init_frame_params(n_joints: int = SMPL_NUM_JOINTS, depth: float = 3.0, *,
                      device, dtype) -> torch.Tensor:
    """Reference initialization: s=1, rootAA=0, t=(0,0,depth), jointAA=0."""
    vec = torch.zeros(frame_param_layout(n_joints)["total"], dtype=dtype,
                      device=device)
    vec[0] = 1.0
    vec[6] = depth
    return vec
