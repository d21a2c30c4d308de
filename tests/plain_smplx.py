"""A plain SMPL-X: the whole-body model's forward pass and the video fit's
residuals and cost, in float64 PyTorch, from a model dict of numpy arrays
(``smpltpu_torch/models/smplx.py::make_synthetic_smplx``'s keys). It
imports torch and numpy only, nothing of the port and no JAX; the CPU
tests hold the port to it.

The forward pass follows ``smplx/lbs.py::lbs`` (Pavlakos et al. 2019,
github.com/vchoutas/smplx) with the departures the port's video path makes
(as ``multi_k1`` does for SMPL):

* no pose blend shapes (the 486 are carried by the model and applied on
  no path);
* the expression coefficients held at zero: the 20-column basis
  ``cat([betas, expression])`` is skinned with 10 zeros after the betas;
* the jaw's and the eyes' angles zero; each hand's 15 joint angles
  ``mean + coeffs @ components[:C]`` (``use_pca=True``,
  ``flat_hand_mean=False``);
* the root's rotation is ``R(root_aa) @ r0`` and joint 0 sits at
  ``root_t`` (smplx's ``transl`` moves the mesh after the pelvis's rest
  position); the frame's Sim3 scale is not applied (the port's
  write-back discards it).

The fit's residuals use the fit's skeleton model, as the port's
``energy/reproj.py`` does for SMPL: the rest bone offsets from
``J_regressor @ v_template``, the shape's joint deltas from
``J_regressor @ shapedirs[..., :10]``, the chain excluding the root's own
rotation, R0 applied before the root's angle-axis, then the scale and the
translation, joint 0 reporting its own shape delta; a pinhole with
``z`` kept 1e-8 away from 0; Huber (delta 3 px) on each keypoint's
2-vector; the pose prior on the body's angles and the hands'
coefficients; the shape prior; the temporal term on every dim but the
scale.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37,
     38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53])
N_JOINTS = 55
N_BETAS = 10
BODY_JOINTS = 22                      # 0-21; 22-24 the jaw and the eyes
LEFT, RIGHT = 25, 40                  # each hand's first joint, 15 a hand
# the keypoint slots: SMPL's 17 body slots (the pelvis twice), each hand's
# 15 finger joints
USE_SMPLX = np.concatenate([[1, 2, 4, 5, 7, 8, 10, 11, 15, 16, 17, 18, 19, 20,
                             21, 0, 0], np.arange(LEFT, LEFT + 30)])
HUBER_DELTA = 3.0
INIT_DEPTH = 3.0


class Model(NamedTuple):
    v_template: torch.Tensor      # (nV, 3)
    shapedirs: torch.Tensor       # (nV, 3, 20)
    j_reg: torch.Tensor           # (nJ, nV)
    weights: torch.Tensor         # (nV, nJ)
    faces: torch.Tensor           # (nF, 3)
    comps: torch.Tensor           # (2, C, 45)
    mean: torch.Tensor            # (2, 45)


def make(d: dict, n_comps: int = 12) -> Model:
    def t(k):
        return torch.as_tensor(np.asarray(d[k]), dtype=F64)
    return Model(t("v_template"), t("shapedirs"), t("J_regressor"), t("weights"),
                 torch.as_tensor(np.asarray(d["faces"]), dtype=torch.int64),
                 t("hand_components")[:, :n_comps], t("hand_mean"))


def p_dim(m: Model) -> int:
    return 7 + 3 * (BODY_JOINTS - 1) + 2 * m.comps.shape[1]


def init_params(m: Model, n: int) -> torch.Tensor:
    x = torch.zeros((n, p_dim(m)), dtype=F64)
    x[:, 0] = 1.0
    x[:, 6] = INIT_DEPTH
    return x


def joint_angles(m: Model, params: torch.Tensor) -> torch.Tensor:
    """(..., 54, 3): joints 1-21 from the frame vector, 22-24 zero, each
    hand's from its PCA coefficients."""
    c = m.comps.shape[1]
    b1 = 7 + 3 * (BODY_JOINTS - 1)
    lead = params.shape[:-1]
    left = m.mean[0] + torch.einsum("...c,ck->...k", params[..., b1:b1 + c], m.comps[0])
    right = m.mean[1] + torch.einsum("...c,ck->...k", params[..., b1 + c:b1 + 2 * c],
                                     m.comps[1])
    body = params[..., 7:b1]
    face = torch.zeros(lead + (9,), dtype=params.dtype)
    return torch.cat([body, face, left, right], -1).reshape(lead + (N_JOINTS - 1, 3))


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3); the Taylor branch below theta^2 = 1e-12."""
    th2 = (aa * aa).sum(-1)[..., None, None]
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    x, y, z = aa.unbind(-1)
    o = torch.zeros_like(x)
    k = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                     torch.stack([-y, x, o], -1)], -2)
    return torch.eye(3, dtype=aa.dtype) + a * k + b * (k @ k)


def forward(m: Model, params, betas, r0):
    """Posed joints (N, 55, 3) and vertices (N, nV, 3) of frames params
    (N, P) under betas (10,) or (N, 10) and r0 (3, 3) or (N, 3, 3)."""
    n = params.shape[0]
    betas = betas.expand(n, N_BETAS)
    coeffs = torch.cat([betas, torch.zeros((n, m.shapedirs.shape[-1] - N_BETAS),
                                           dtype=F64)], -1)
    v_shaped = m.v_template + torch.einsum("vxs,ns->nvx", m.shapedirs, coeffs)
    j_rest = torch.einsum("jv,nvx->njx", m.j_reg, v_shaped)
    rots = rodrigues(joint_angles(m, params))
    g = [rodrigues(params[:, 1:4]) @ r0.expand(n, 3, 3)]
    x = [torch.zeros((n, 3), dtype=F64)]
    for j in range(1, N_JOINTS):
        p = int(PARENTS[j])
        g.append(g[p] @ rots[:, j - 1])
        x.append((g[p] @ (j_rest[:, j] - j_rest[:, p])[..., None])[..., 0] + x[p])
    g = torch.stack(g, 1)
    root = params[:, None, 4:7]
    joints = torch.stack(x, 1) + root
    # the translation rides in each joint's transform, as in the port's
    # K2 operands (equal to adding it after skinning where the weights
    # sum to 1)
    t = joints - torch.einsum("njab,njb->nja", g, j_rest)
    a = torch.einsum("vj,njab->nvab", m.weights, g)
    verts = (torch.einsum("nvab,nvb->nva", a, v_shaped)
             + torch.einsum("vj,nja->nva", m.weights, t))
    return joints, verts


def skeleton_joints(m: Model, params, betas, r0):
    """The fit's camera-space joints (..., 55, 3): params (..., P), betas
    (..., 10) broadcasting, r0 (..., 3, 3)."""
    rest = m.j_reg @ m.v_template
    jsr = torch.einsum("jv,vxs->jxs", m.j_reg, m.shapedirs[..., :N_BETAS])
    pj = np.where(PARENTS < 0, 0, PARENTS)
    delta = torch.einsum("jxs,...s->...jx", jsr, betas)
    dpar = torch.cat([torch.zeros_like(delta[..., :1, :]), delta[..., pj[1:], :]], -2)
    base = torch.cat([torch.zeros_like(rest[:1]), rest[1:] - rest[pj[1:]]])
    offsets = base + (delta - dpar)
    rots = rodrigues(joint_angles(m, params))
    batch = torch.broadcast_shapes(rots.shape[:-3], offsets.shape[:-2])
    g = [torch.eye(3, dtype=F64).expand(batch + (3, 3))]
    x = [torch.zeros(batch + (3,), dtype=F64)]
    for j in range(1, N_JOINTS):
        p = int(PARENTS[j])
        g.append(g[p] @ rots[..., j - 1, :, :])
        x.append((g[p] @ offsets[..., j, :, None])[..., 0] + x[p])
    x[0] = delta[..., 0, :].expand(batch + (3,))
    joints = torch.stack(x, -2) @ r0.transpose(-1, -2)
    joints = joints @ rodrigues(params[..., 1:4]).transpose(-1, -2)
    return params[..., 0, None, None] * joints + params[..., None, 4:7]


def project(pts, cam):
    """cam (fx, fy, cx, cy); z kept 1e-8 away from 0, its sign kept."""
    z = pts[..., 2]
    tiny = torch.where(z < 0, torch.full_like(z, -1e-8), torch.full_like(z, 1e-8))
    z = torch.where(torch.abs(z) < 1e-8, tiny, z)
    fx, fy, cx, cy = cam
    return torch.stack([fx * pts[..., 0] / z + cx, fy * pts[..., 1] / z + cy], -1)


def kp_residuals(m: Model, cam, params, betas, kp, r0):
    """Masked residuals (..., K, 2); kp (..., K, 4) rows [joint, u, v, valid]."""
    joints = skeleton_joints(m, params, betas, r0)
    idx = kp[..., 0].long()[..., None].expand(kp.shape[:-1] + (3,))
    pred = project(torch.gather(joints, -2, idx), cam)
    return (pred - kp[..., 1:3]) * kp[..., 3:4]


def huber_rho(s):
    root = torch.sqrt(torch.clamp(s, min=1e-24))
    return torch.where(s <= HUBER_DELTA ** 2, s, 2.0 * HUBER_DELTA * root - HUBER_DELTA ** 2)


def multi_cost(m: Model, cam, beta_pose, beta_shape, lambda_t, params, betas,
               kp, r0, valid):
    """Each window's cost: params (W, F, P), betas (W, 10), kp (W, F, K, 4),
    r0 (W, F, 3, 3), valid (W, F) -> (W,)."""
    res = kp_residuals(m, cam, params, betas[:, None, :], kp, r0)
    c_kp = huber_rho((res * res).sum(-1)).sum((-2, -1))
    c_pose = beta_pose ** 2 * (params[..., 7:] ** 2).sum((-2, -1))
    c_shape = beta_shape ** 2 * (betas * betas).sum(-1)
    pair = (lambda_t * valid[:, :-1] * valid[:, 1:]) ** 2
    diff = params[:, :-1, 1:] - params[:, 1:, 1:]
    c_t = (pair[..., None] * diff * diff).sum((-2, -1))
    return 0.5 * (c_kp + c_pose + c_shape + c_t)
