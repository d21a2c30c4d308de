"""Keypoint reprojection residuals (port of ``smpltpu/energy/reproj.py``).

One whole-skeleton forward-kinematics pass gives every joint's
camera-space position; all keypoint residuals come out as a dense masked
(K, 2) tensor per frame. Leading batch axes (windows, frames) broadcast
through every function and take the place of ``jax.vmap``. The reference
functor's root quirks are kept: the chain excludes the root's own local
rotation, R0 is applied before the optimized root angle-axis, scale and
translation, and joint 0 reports its shape delta while its children ignore
it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from smpltpu_torch.energy.params import unpack_frame_params
from smpltpu_torch.models.smpl import SMPLModel, rodrigues


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


class SkeletonSpec(NamedTuple):
    """Static per-model data for the solver's skeleton-only FK."""

    parents: np.ndarray                        # (nJ,) static
    base_offsets: torch.Tensor                 # (nJ, 3) parent-relative
    r0: torch.Tensor                           # (3, 3) fixed root orientation
    joint_shape_reg: Optional[torch.Tensor]    # (nJ, 3, nS) or None


def make_skeleton_spec(model: SMPLModel, r0, with_shape: bool) -> SkeletonSpec:
    """Rest-pose bone offsets from the zero-shape, zero-pose model,
    root-anchored (at zero pose FK is the identity, so rest joints are
    J_regressor @ v_template)."""
    joints_rest = model.J_regressor @ model.v_template            # (nJ, 3)
    parents = model.parents
    pj = np.where(parents < 0, 0, parents)
    base_offsets = joints_rest - joints_rest[pj]
    base_offsets[0] = 0.0
    jsr = None
    if with_shape:
        jsr = model.joint_shape_reg.reshape(model.num_joints, 3,
                                            model.num_shapes)
    return SkeletonSpec(
        parents=parents,
        base_offsets=base_offsets,
        r0=torch.as_tensor(np.asarray(r0), dtype=base_offsets.dtype,
                           device=base_offsets.device),
        joint_shape_reg=jsr,
    )


_PARENT_TABLES: dict = {}


def parent_tables(parents: np.ndarray, device):
    """(parent index with the root's -1 as 0 (nJ,) int64, has-a-parent
    (nJ,) bool) on ``device``, made once per parent table and device: a
    table built from host data on every call would be a host-to-device
    copy, which waits for the device, inside every LM trip."""
    key = (np.asarray(parents).tobytes(), str(torch.device(device)))
    hit = _PARENT_TABLES.get(key)
    if hit is None:
        hit = (torch.as_tensor(np.where(parents < 0, 0, parents),
                               dtype=torch.int64, device=device),
               torch.as_tensor(parents >= 0, device=device))
        _PARENT_TABLES[key] = hit
    return hit


def _shaped_offsets(spec: SkeletonSpec, shape: torch.Tensor):
    """Bone offsets with the shape deltas folded in, and joint 0's own
    delta (the root-quirk output position). Returns (offsets (..., nJ, 3),
    delta0 (..., 3))."""
    offsets = spec.base_offsets
    if spec.joint_shape_reg is None:
        return offsets, torch.zeros_like(offsets[0])
    delta = torch.einsum("jxs,...s->...jx", spec.joint_shape_reg, shape)
    pj, has_par = parent_tables(spec.parents, delta.device)
    delta_parent = torch.where(has_par[:, None], delta[..., pj, :],
                               torch.zeros_like(delta))
    return offsets + (delta - delta_parent), delta[..., 0, :]


def skeleton_joints_cam(params_vec: torch.Tensor, shape: torch.Tensor,
                        spec: SkeletonSpec,
                        r0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera-space positions of all joints under the reference's skeleton
    model: params (..., P), shape (..., nS) broadcasting against params'
    leading axes, r0 (..., 3, 3) per-frame root orientation (default
    spec.r0). Returns (..., nJ, 3)."""
    n_j = len(spec.parents)
    fp = unpack_frame_params(params_vec, n_j)
    offsets, delta0 = _shaped_offsets(spec, shape)
    rot = rodrigues(fp.joint_aa)                              # (..., nJ-1, 3, 3)
    batch = torch.broadcast_shapes(rot.shape[:-3], offsets.shape[:-2])
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)

    # FK with the root pinned at the origin and G_root = I (the chain walk
    # excludes the root's rotation and position)
    g = [eye.expand(batch + (3, 3))]
    x = [rot.new_zeros(batch + (3,))]
    for j in range(1, n_j):
        p = int(spec.parents[j])
        g.append(g[p] @ rot[..., j - 1, :, :])
        x.append((g[p] @ offsets[..., j, :, None])[..., 0] + x[p])
    # root quirk: joint 0 reports its shape delta even though children
    # ignore it
    x[0] = delta0.expand(batch + (3,))
    joints = torch.stack(x, dim=-2)                           # (..., nJ, 3)

    r_root = rodrigues(fp.root_aa)
    r0m = spec.r0 if r0 is None else r0
    joints = joints @ r0m.transpose(-1, -2)
    joints = joints @ r_root.transpose(-1, -2)
    return fp.scale[..., None, None] * joints + fp.root_t[..., None, :]


def _guard_z(z: torch.Tensor) -> torch.Tensor:
    """z kept at least 1e-8 away from 0 (sign preserved): zero-padded
    window frames then give large but finite pixels instead of NaN, which
    would poison the masked residual rows (NaN * 0 = NaN)."""
    tiny = torch.where(z < 0, torch.full_like(z, -1e-8),
                       torch.full_like(z, 1e-8))
    return torch.where(torch.abs(z) < 1e-8, tiny, z)


def project(points: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Pinhole projection (..., 3) -> (..., 2) pixels."""
    z = _guard_z(points[..., 2])
    u = cam.fx * points[..., 0] / z + cam.cx
    v = cam.fy * points[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def gather_joints(t: torch.Tensor, kp_dense: torch.Tensor,
                  n_tail: int = 1) -> torch.Tensor:
    """Per-joint rows of t (..., nJ, *tail) picked by the keypoint joint
    ids of kp_dense (..., K, 4) -> (..., K, *tail); ``n_tail`` counts the
    trailing axes after the joint axis."""
    jids = kp_dense[..., 0].long()
    idx = jids.reshape(jids.shape + (1,) * n_tail)
    return torch.take_along_dim(t, idx, dim=-(n_tail + 1))


def keypoint_residuals(params_vec: torch.Tensor, shape: torch.Tensor,
                       kp_dense: torch.Tensor, cam: Camera, spec: SkeletonSpec,
                       r0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked reprojection residuals flattened to (..., K*2); kp_dense
    (..., K, 4) rows [jid, u, v, valid]. Invalid slots give exactly-zero
    rows."""
    joints_cam = skeleton_joints_cam(params_vec, shape, spec, r0)
    pred = project(gather_joints(joints_cam, kp_dense), cam)     # (..., K, 2)
    res = (pred - kp_dense[..., 1:3]) * kp_dense[..., 3:4]
    return res.flatten(-2)
