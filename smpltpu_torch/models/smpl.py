"""SMPL forward pass in PyTorch: shape blendshapes -> joint regression ->
forward kinematics -> linear blend skinning.

Port of ``smpltpu/models/smpl.py`` (same conventions: ``rotations`` are
per-joint LOCAL rotation matrices with row 0 the global root orientation;
``root_pos`` is the world position of joint 0). Every function broadcasts
over leading batch axes, which take the place of ``jax.vmap``. The
skinning hot path used by the pipeline is the CUDA kernel in
:mod:`smpltpu_torch.ops.lbs`; ``smpl_forward`` keeps the einsum form as the
reference formulation.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_FIELDS = ("v_template", "shapedirs", "J_regressor", "weights",
           "joint_shape_reg", "posedirs")


class SMPLModel(nn.Module):
    """Model container (the reference's ark::AvatarModel) with the arrays
    as buffers, so ``.to(device)`` moves them together.

    v_template (nV, 3), shapedirs (nV, 3, nS), J_regressor (nJ, nV),
    weights (nV, nJ), joint_shape_reg (3*nJ, nS), posedirs (nV, 3, nP) or
    None. ``faces`` (nF, 3) and ``parents`` (nJ,) stay numpy int32: the
    topology is static host data.
    """

    def __init__(self, v_template, shapedirs, J_regressor, weights,
                 joint_shape_reg, posedirs, faces, parents):
        super().__init__()
        self.register_buffer("v_template", v_template)
        self.register_buffer("shapedirs", shapedirs)
        self.register_buffer("J_regressor", J_regressor)
        self.register_buffer("weights", weights)
        self.register_buffer("joint_shape_reg", joint_shape_reg)
        self.register_buffer("posedirs", posedirs)
        self.faces = np.asarray(faces, dtype=np.int32)
        self.parents = np.asarray(parents, dtype=np.int32)

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_shapes(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @classmethod
    def from_dict(cls, d: dict, *, device, dtype) -> "SMPLModel":
        """Build from an io/synthetic model dict (numpy arrays)."""
        def as_t(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)
        return cls(
            **{k: (None if d.get(k) is None else as_t(d[k])) for k in _FIELDS},
            faces=d["faces"], parents=d["parents"])

    @classmethod
    def from_jax(cls, model, *, device, dtype) -> "SMPLModel":
        """Carry a reference ``smpltpu.models.SMPLModel`` over, field by
        field through ``np.asarray`` (no JAX import here: the caller owns
        the JAX object)."""
        d = {k: (None if getattr(model, k) is None
                 else np.asarray(getattr(model, k))) for k in _FIELDS}
        d["faces"] = np.asarray(model.faces)
        d["parents"] = np.asarray(model.parents)
        return cls.from_dict(d, device=device, dtype=dtype)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], dim=-1),
        torch.stack([z, o, -x], dim=-1),
        torch.stack([-y, x, o], dim=-1),
    ], dim=-2)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), with the
    reference's Taylor branch for theta^2 < 1e-12 (double-where: the
    non-taken branch sees a sanitized argument, so derivatives stay finite
    through theta -> 0)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]  # (...,1,1)
    small = theta2 < 1e-12
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    sin_over = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    one_minus_cos_over = torch.where(small, 0.5 - theta2 / 24.0,
                                     (1.0 - torch.cos(theta)) / safe_theta2)
    k = _skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(k.shape)
    return eye + sin_over * k + one_minus_cos_over * (k @ k)


def tree_levels(parents: np.ndarray):
    """Group non-root joints by tree depth (host-side, static topology)."""
    n_j = len(parents)
    depth = np.zeros(n_j, dtype=np.int64)
    for j in range(1, n_j):
        depth[j] = depth[parents[j]] + 1
    return [np.where(depth == d)[0] for d in range(1, int(depth.max()) + 1)]


def _fk_global(parents: np.ndarray, rotations: torch.Tensor,
               joints_rest: torch.Tensor):
    """Forward kinematics over the joint tree. Returns (G (..., nJ, 3, 3),
    joint_world (..., nJ, 3)) with the root pinned at the origin; G[j] is
    the product of local rotations down the chain, the root's included."""
    n_j = len(parents)
    batch = torch.broadcast_shapes(rotations.shape[:-3], joints_rest.shape[:-2])
    g = [rotations[..., 0, :, :].expand(batch + (3, 3))]
    x = [joints_rest.new_zeros(batch + (3,))]
    for j in range(1, n_j):
        p = int(parents[j])
        off = joints_rest[..., j, :] - joints_rest[..., p, :]
        g.append(g[p] @ rotations[..., j, :, :])
        x.append((g[p] @ off[..., None])[..., 0] + x[p])
    return torch.stack(g, dim=-3), torch.stack(x, dim=-2)


def smpl_forward(model: SMPLModel, shape: torch.Tensor,
                 rotations: torch.Tensor, root_pos: torch.Tensor,
                 use_posedirs: bool = False, want_verts: bool = True) -> dict:
    """Full SMPL forward: shape (..., nS), rotations (..., nJ, 3, 3),
    root_pos (..., 3). Returns {"joints": (..., nJ, 3), "verts":
    (..., nV, 3) if want_verts}."""
    v_shaped = model.v_template + torch.einsum(
        "vxs,...s->...vx", model.shapedirs, shape)
    joints_rest = torch.einsum("jv,...vx->...jx", model.J_regressor, v_shaped)

    if use_posedirs and model.posedirs is not None:
        eye = torch.eye(3, dtype=rotations.dtype, device=rotations.device)
        pose_feat = (rotations[..., 1:, :, :] - eye).flatten(-3)
        v_shaped = v_shaped + torch.einsum(
            "vxp,...p->...vx", model.posedirs, pose_feat)

    g, joints_local = _fk_global(model.parents, rotations, joints_rest)
    joints_world = joints_local + root_pos[..., None, :]
    out = {"joints": joints_world}
    if want_verts:
        t_j = joints_local - torch.einsum("...jab,...jb->...ja", g, joints_rest)
        rot_blend = torch.einsum("vj,...jab->...vab", model.weights, g)
        off_blend = torch.einsum("vj,...ja->...va", model.weights, t_j)
        out["verts"] = (torch.einsum("...vab,...vb->...va", rot_blend, v_shaped)
                        + off_blend + root_pos[..., None, :])
    return out
