"""K2: fused shape blendshapes + linear blend skinning.

For each frame b and vertex v, ``out[b, :, v] = A_bv [v_sh; 1]`` with
``v_sh = v_template[v] + shapedirs[v] . beta_b`` and
``A_bv = sum_j W[v, j] G_bj`` (3 x 4). ``lbs`` runs it as the CUDA kernel
``csrc/lbs.cu`` for a CUDA tensor, which replaces the TPU kernel
``smpltpu/ops/lbs.py::lbs_pallas`` (the note in the ``.cu`` file says what
bounds it on the card), and as the plain einsum version ``lbs_torch`` for
a CPU tensor. The output is coordinate-major (B, 3, nV) with no lane padding.

``joint_affines`` is the FK stage that feeds it: O(nJ) work, with the rest
joints from the reduced regressor ``joint_shape_reg``.
"""

from __future__ import annotations

import torch

from smpltpu_torch import _build
from smpltpu_torch.ops import LAUNCHES
from smpltpu_torch.models.smpl import SMPLModel, _fk_global


def prepare_lbs_operands(model: SMPLModel) -> dict:
    """The model arrays in the kernel's coordinate-major layout, in the
    model's dtype and device (once per model): v_template_t (3, nV),
    shapedirs_t (nS, 3, nV), weights_t (nJ, nV)."""
    return {
        "v_template_t": model.v_template.T.contiguous(),
        "shapedirs_t": model.shapedirs.permute(2, 1, 0).contiguous(),
        "weights_t": model.weights.T.contiguous(),
        "n_verts": model.num_verts,
        "n_joints": model.num_joints,
    }


def lbs_torch(shapes: torch.Tensor, g_affine: torch.Tensor,
              operands: dict) -> torch.Tensor:
    """Plain einsum version: shapes (B, nS), g_affine (B, nJ, 3, 4) ->
    skinned vertices (B, 3, nV), in the dtype of the inputs."""
    vt, sd, wt = (operands[k] for k in ("v_template_t", "shapedirs_t",
                                         "weights_t"))
    vsh = vt + torch.einsum("bs,scv->bcv", shapes, sd)           # (B, 3, nV)
    a = torch.einsum("jv,bjck->bckv", wt, g_affine)              # (B, 3, 4, nV)
    return (a[:, :, 0] * vsh[:, 0:1] + a[:, :, 1] * vsh[:, 1:2]
            + a[:, :, 2] * vsh[:, 2:3] + a[:, :, 3])


def lbs(shapes: torch.Tensor, g_affine: torch.Tensor,
        operands: dict) -> torch.Tensor:
    """K2 on a CUDA tensor (float32), the plain version on a CPU tensor.
    Counts its kernel launches in ``LAUNCHES["lbs"]``."""
    dev = shapes.device
    if dev.type == "cpu":
        return lbs_torch(shapes, g_affine, operands)
    if dev.type != "cuda":
        raise ValueError(f"lbs: no kernel for device {dev}")
    b, n_s = shapes.shape
    n_v, n_j = operands["n_verts"], operands["n_joints"]
    for name, t, shape in (("shapes", shapes, (b, n_s)),
                           ("g_affine", g_affine, (b, n_j, 3, 4)),
                           ("v_template_t", operands["v_template_t"], (3, n_v)),
                           ("shapedirs_t", operands["shapedirs_t"], (n_s, 3, n_v)),
                           ("weights_t", operands["weights_t"], (n_j, n_v))):
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"lbs: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"lbs: {name} must be contiguous")
    lib = _build.load()
    out = torch.empty((b, 3, n_v), dtype=torch.float32, device=dev)
    err = lib.smpltpu_lbs_f32(
        shapes.data_ptr(), g_affine.data_ptr(),
        operands["v_template_t"].data_ptr(), operands["shapedirs_t"].data_ptr(),
        operands["weights_t"].data_ptr(), out.data_ptr(), b, n_v, n_j, n_s,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbs: kernel launch failed with CUDA error {err}")
    LAUNCHES["lbs"] += 1
    return out



def joint_affines(model: SMPLModel, shape: torch.Tensor,
                  rotations: torch.Tensor, root_pos: torch.Tensor):
    """Per-joint world affine transforms feeding the skinning kernel:
    shape (..., nS), rotations (..., nJ, 3, 3), root_pos (..., 3) ->
    (G (..., nJ, 3, 4), joints (..., nJ, 3)). Rest joints come from
    ``joint_shape_reg = J_reg @ shapedirs`` (identical to regressing the
    shaped cloud, by linearity), so no O(nV) work happens here."""
    n_j = model.num_joints
    jrt = model.J_regressor @ model.v_template                   # (nJ, 3)
    jsr = model.joint_shape_reg.reshape(n_j, 3, -1)
    joints_rest = jrt + torch.einsum("jxs,...s->...jx", jsr, shape)
    g, joints_local = _fk_global(model.parents, rotations, joints_rest)
    t = (joints_local - torch.einsum("...jab,...jb->...ja", g, joints_rest)
         + root_pos[..., None, :])
    return (torch.cat([g, t[..., None]], dim=-1),
            joints_local + root_pos[..., None, :])
