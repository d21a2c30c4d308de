"""Closed-form Jacobian of the keypoint reprojection residuals (port of
``smpltpu/energy/jacobian.py``, the analytic path only).

Same geometry as the reference module, batched over leading axes:

  * joint-angle columns by the rigid-subtree rule
    ``d x_k = (G_j J_r(theta_j) d) x (x_k - x_j)`` for strict descendants k;
  * shape columns by the parent-prefix recursion FK itself uses;
  * root angle-axis / scale / translation columns in closed form;
  * the pinhole chain rule with the z-guard branch derivative of
    :func:`smpltpu_torch.energy.reproj.project`.

Pinned against the JAX twin and against ``torch.func.jacfwd`` of
``keypoint_residuals`` in float64 (tests/test_torch_energy.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smpltpu_torch.energy.params import unpack_frame_params
from smpltpu_torch.energy.reproj import (
    Camera,
    SkeletonSpec,
    _guard_z,
    _shaped_offsets,
    gather_joints,
    parent_tables,
)
from smpltpu_torch.models.smpl import _skew, rodrigues


def so3_right_jacobian(aa: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of the axis-angle exponential, (..., 3) -> (..., 3, 3):
    J_r(t) = I - (1-cos p)/p^2 [t]_x + (p - sin p)/p^3 [t]_x^2, with the
    Taylor branch at p^2 < 1e-12."""
    theta2 = torch.sum(aa * aa, dim=-1)[..., None, None]
    small = theta2 < 1e-12
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(safe)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / safe)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (th - torch.sin(th)) / (safe * th))
    k = _skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(k.shape)
    return eye - a * k + b * (k @ k)


def _strict_ancestor_mask(parents: np.ndarray) -> np.ndarray:
    """(nJ, nJ-1) bool: column j-1 true for strict descendants of joint j."""
    n = len(parents)
    m = np.zeros((n, n), np.bool_)
    for k in range(n):
        p = parents[k]
        while p >= 0:
            m[k, p] = True
            p = parents[p]
    return m[:, 1:]


_ANCESTOR_MASKS: dict = {}


def _ancestor_mask(parents: np.ndarray, device, dtype) -> torch.Tensor:
    """:func:`_strict_ancestor_mask` on ``device`` in ``dtype``, made once
    (a host-to-device copy in every LM trip would wait for the device)."""
    key = (np.asarray(parents).tobytes(), str(torch.device(device)), dtype)
    if key not in _ANCESTOR_MASKS:
        _ANCESTOR_MASKS[key] = torch.as_tensor(
            _strict_ancestor_mask(parents), dtype=dtype, device=device)
    return _ANCESTOR_MASKS[key]


def keypoint_residuals_and_jacobian(
    params_vec: torch.Tensor,
    shape: torch.Tensor,
    kp_dense: torch.Tensor,
    cam: Camera,
    spec: SkeletonSpec,
    r0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked residuals and their Jacobians in one FK-sized pass.

    params (..., P), shape (..., nS) broadcasting against params' leading
    axes, kp_dense (..., K, 4), r0 (..., 3, 3) or None. Returns
    ``(res (..., K*2), J_p (..., K*2, P), J_w (..., K*2, nS))``, the
    residuals of ``keypoint_residuals`` and their derivatives wrt the
    packed frame vector and the shape vector.
    """
    n_j = len(spec.parents)
    fp = unpack_frame_params(params_vec, n_j)
    n_s = shape.shape[-1]
    offsets, delta0 = _shaped_offsets(spec, shape)
    rot = rodrigues(fp.joint_aa)                                  # (..., nJ-1,3,3)
    batch = torch.broadcast_shapes(rot.shape[:-3], offsets.shape[:-2])
    eye3 = torch.eye(3, dtype=rot.dtype, device=rot.device)

    jsr = spec.joint_shape_reg
    jsr_off = None
    if jsr is not None:
        pj, has_par = parent_tables(spec.parents, jsr.device)
        jsr_off = jsr - torch.where(has_par[:, None, None], jsr[pj],
                                    torch.zeros_like(jsr))

    # chain FK (root pinned, G_root = I), carrying d x / d w alongside
    g = [eye3.expand(batch + (3, 3))]
    x = [rot.new_zeros(batch + (3,))]
    dxdw = [rot.new_zeros(batch + (3, n_s))]
    for j in range(1, n_j):
        p = int(spec.parents[j])
        g.append(g[p] @ rot[..., j - 1, :, :])
        x.append((g[p] @ offsets[..., j, :, None])[..., 0] + x[p])
        if jsr_off is not None:
            dxdw.append(dxdw[p] + g[p] @ jsr_off[j])
    gs = torch.stack(g, dim=-3)                                   # (..., nJ,3,3)
    xc = torch.stack(x, dim=-2)                                   # (..., nJ,3)
    x_out = torch.cat([delta0.expand(batch + (3,))[..., None, :],
                       xc[..., 1:, :]], dim=-2)                   # root quirk
    if jsr_off is not None:
        dxdw[0] = jsr[0].expand(batch + (3, n_s))
        dxdw = torch.stack(dxdw, dim=-3)                          # (..., nJ,3,nS)
    else:
        dxdw = None

    # joint-angle columns: rigid subtree about each joint anchor
    jr_loc = so3_right_jacobian(fp.joint_aa)                      # (..., nJ-1,3,3)
    w_cols = torch.einsum("...jab,...jbm->...jma", gs[..., 1:, :, :], jr_loc)
    v = xc[..., :, None, :] - xc[..., None, 1:, :]                # (..., nJ,nJ-1,3)
    dxdth = torch.linalg.cross(w_cols[..., None, :, :, :],
                               v[..., :, :, None, :])             # (...,nJ,nJ-1,3m,3)
    anc = _ancestor_mask(spec.parents, rot.device, rot.dtype)
    dxdth = dxdth * anc[:, :, None, None]

    # world transform y = s R(a) R0 x + t and its param columns
    r0m = spec.r0 if r0 is None else r0
    r_root = rodrigues(fp.root_aa)                                # (..., 3, 3)
    scale = fp.scale[..., None, None]
    u = x_out @ r0m.transpose(-1, -2)                             # (..., nJ, 3)
    dyds = u @ r_root.transpose(-1, -2)
    y = scale * dyds + fp.root_t[..., None, :]
    q = r_root @ r0m
    jr_root = so3_right_jacobian(fp.root_aa)
    dyda = -scale[..., None] * torch.einsum(
        "...ab,...kbc,...cd->...kad", r_root, _skew(u), jr_root)  # (..., nJ,3,3)

    # pinhole chain rule at the keypoint rows, guard-branch-consistent with
    # reproj.project
    vis = kp_dense[..., 3]
    yk = gather_joints(y, kp_dense)                               # (..., K, 3)
    zraw = yk[..., 2]
    zg = _guard_z(zraw)
    pred = torch.stack([cam.fx * yk[..., 0] / zg + cam.cx,
                        cam.fy * yk[..., 1] / zg + cam.cy], dim=-1)
    res = (pred - kp_dense[..., 1:3]) * vis[..., None]
    zlive = (torch.abs(zraw) >= 1e-8).to(zg.dtype)                # where-branch
    zero = torch.zeros_like(zg)
    p2 = torch.stack([
        torch.stack([cam.fx / zg, zero,
                     -cam.fx * yk[..., 0] / (zg * zg) * zlive], dim=-1),
        torch.stack([zero, cam.fy / zg,
                     -cam.fy * yk[..., 1] / (zg * zg) * zlive], dim=-1),
    ], dim=-2) * vis[..., None, None]                             # (..., K,2,3)

    jds = (p2 @ gather_joints(dyds, kp_dense)[..., None])         # (..., K,2,1)
    jda = p2 @ gather_joints(dyda, kp_dense, 2)                   # (..., K,2,3)
    # chain the world rotation into the pinhole rows first: s * p2 @ q
    p2q = scale[..., None] * (p2 @ q[..., None, :, :])            # (..., K,2,3)
    jdth = torch.einsum("...kca,...kjma->...kcjm", p2q,
                        gather_joints(dxdth, kp_dense, 3))        # (...,K,2,nJ-1,3)
    j_p = torch.cat([jds, jda, p2, jdth.flatten(-2)], dim=-1)     # (..., K,2,P)
    if dxdw is not None:
        j_w = p2q @ gather_joints(dxdw, kp_dense, 2)              # (..., K,2,nS)
    else:
        j_w = p2.new_zeros(p2.shape[:-1] + (n_s,))
    return res.flatten(-2), j_p.flatten(-3, -2), j_w.flatten(-3, -2)
