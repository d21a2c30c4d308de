"""Per-frame parameter vector layout (port of ``smpltpu/energy/params.py``).

One flat vector per frame:

    [ scale | rootAA(3) | rootT(3) | jointAA[1..nJ-1] (3 each) ]

P = 7 + 3*(nJ-1) = 76 for SMPL's 24 joints.

A whole-body model with PCA hands (SMPL-X, ``models/smplx.py``) has its
own layout, chosen from the model (``n_hand_comps`` > 0):

    [ scale | rootAA(3) | rootT(3) | body jointAA[1..21] (63)
      | left hand PCA coeffs (C) | right hand PCA coeffs (C) ]

P = 7 + 63 + 2C = 94 at SMPLify-X's C = 12. The jaw and the eyes are held
at zero (no keypoint sees them); each hand's 15 joint angle-axes are
``mean + coeffs @ components`` (:func:`expand_joint_aa`). ``joint_aa``
spans everything the pose prior covers, the body's angles and the hands'
coefficients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smpltpu_torch.constants import SMPL_NUM_JOINTS
from smpltpu_torch.models.smplx import (
    SMPLX_BODY_JOINTS,
    SMPLX_HAND_JOINTS,
    HandPCA,
)


def frame_param_layout(n_joints: int = SMPL_NUM_JOINTS,
                       n_hand_comps: int = 0) -> dict:
    """Slice indices into the packed frame vector; ``n_hand_comps`` > 0
    gives the whole-body layout (also ``body_aa`` and ``hand_pca``)."""
    if n_hand_comps == 0:
        return {
            "scale": (0, 1),
            "root_aa": (1, 4),
            "root_t": (4, 7),
            "joint_aa": (7, 7 + 3 * (n_joints - 1)),
            "total": 7 + 3 * (n_joints - 1),
        }
    body = 7 + 3 * (SMPLX_BODY_JOINTS - 1)
    total = body + 2 * n_hand_comps
    return {
        "scale": (0, 1),
        "root_aa": (1, 4),
        "root_t": (4, 7),
        "joint_aa": (7, total),
        "body_aa": (7, body),
        "hand_pca": (body, total),
        "total": total,
    }


def hand_comps(hands: Optional[HandPCA]) -> int:
    """The layout's ``n_hand_comps`` for a model's hand space (None: 0)."""
    return 0 if hands is None else hands.n_comps


def expand_joint_aa(vec: torch.Tensor, n_joints: int,
                    hands: HandPCA) -> torch.Tensor:
    """Every non-root joint's angle-axis (..., nJ-1, 3) from whole-body
    frame vectors (..., P): the body's as they are, the jaw's and the eyes'
    zero, each hand's 15 from its PCA coefficients. Under a profiler the
    hands' part is the span ``energy.hand_pca``."""
    lay = frame_param_layout(n_joints, hands.n_comps)
    b0, b1 = lay["body_aa"]
    h0 = lay["hand_pca"][0]
    c = hands.n_comps
    n_face = n_joints - SMPLX_BODY_JOINTS - 2 * SMPLX_HAND_JOINTS
    from smpltpu_torch.utils.obs import span   # utils imports energy
    with span("energy.hand_pca"):
        left = hands.mean[0] + vec[..., h0:h0 + c] @ hands.components[0]
        right = hands.mean[1] + vec[..., h0 + c:h0 + 2 * c] @ hands.components[1]
    face = vec.new_zeros(vec.shape[:-1] + (3 * n_face,))
    return torch.cat([vec[..., b0:b1], face, left, right],
                     dim=-1).unflatten(-1, (n_joints - 1, 3))


def hand_pca_columns(j_aa: torch.Tensor, n_joints: int,
                     hands: HandPCA) -> torch.Tensor:
    """The columns of whole-body frame vectors' joint part from the
    columns of every non-root joint's angle-axis, j_aa (..., 3(nJ-1)): the
    body's as they are, the face's dropped, and by the chain rule each hand
    coefficient's column the components-weighted sum of its hand's 45
    joint-angle columns -> (..., P - 7). Under a profiler: the span
    ``energy.hand_pca``."""
    nb = 3 * (SMPLX_BODY_JOINTS - 1)
    nh = 3 * SMPLX_HAND_JOINTS
    lo = 3 * (n_joints - 1) - 2 * nh
    from smpltpu_torch.utils.obs import span   # utils imports energy
    with span("energy.hand_pca"):
        left = j_aa[..., lo:lo + nh] @ hands.components[0].transpose(0, 1)
        right = j_aa[..., lo + nh:] @ hands.components[1].transpose(0, 1)
    return torch.cat([j_aa[..., :nb], left, right], dim=-1)


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
                        n_joints: int = SMPL_NUM_JOINTS,
                        hands: Optional[HandPCA] = None) -> FrameParams:
    """Unpacked view; with ``hands`` (a whole-body layout) ``joint_aa`` is
    every non-root joint's angle-axis, the hands' expanded
    (:func:`expand_joint_aa`)."""
    if hands is not None:
        return FrameParams(scale=vec[..., 0], root_aa=vec[..., 1:4],
                           root_t=vec[..., 4:7],
                           joint_aa=expand_joint_aa(vec, n_joints, hands))
    lay = frame_param_layout(n_joints)
    return FrameParams(
        scale=vec[..., 0],
        root_aa=vec[..., lay["root_aa"][0]:lay["root_aa"][1]],
        root_t=vec[..., lay["root_t"][0]:lay["root_t"][1]],
        joint_aa=vec[..., lay["joint_aa"][0]:lay["joint_aa"][1]].reshape(
            vec.shape[:-1] + (n_joints - 1, 3)),
    )


def init_frame_params(n_joints: int = SMPL_NUM_JOINTS, depth: float = 3.0, *,
                      device, dtype, n_hand_comps: int = 0) -> torch.Tensor:
    """Reference initialization: s=1, rootAA=0, t=(0,0,depth), jointAA=0
    (the hands' coefficients 0: each hand at its mean pose)."""
    vec = torch.zeros(frame_param_layout(n_joints, n_hand_comps)["total"],
                      dtype=dtype, device=device)
    vec[0] = 1.0
    vec[6] = depth
    return vec
