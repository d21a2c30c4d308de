"""Pipeline plumbing of the fit's output stage (port of the evaluation and
overlay parts of ``smpltpu/pipeline/common.py``): per-frame evaluation
error and skinned vertices for every frame, and the host overlay render.

Image files are not read or written here: the reference's image I/O lives
in ``smpltpu.utils.image``, whose package imports JAX. Callers pass and
get numpy images.
"""

from __future__ import annotations

import numpy as np
import torch

from smpltpu.render.raster import render_mesh_overlay
from smpltpu_torch.energy.reproj import Camera
from smpltpu_torch.models.smpl import SMPLModel
from smpltpu_torch.ops.lbs import joint_affines, lbs, prepare_lbs_operands
from smpltpu_torch.utils.metrics import mean_pixel_error
from smpltpu_torch.utils.writeback import params_to_pose

SKIN_BATCH = 100   # frames per skinning launch (the reference bench's chunk)


def batched_frame_eval(model: SMPLModel, params, shapes, r0, kp, cam: Camera,
                       want_verts: bool = True):
    """Every frame's evaluation error and (optionally) skinned vertices.

    params (F, P), shapes (F, nS), r0 (F, 3, 3), kp (F, K, 4), as tensors
    or numpy arrays; they are moved to the model's device and dtype. The FK
    stage (``joint_affines``) runs for all frames at once; the skinning
    runs through K2 (``ops/lbs.py::lbs``) in batches of SKIN_BATCH frames.
    Returns (errors (F,) numpy, verts (F, nV, 3) numpy or None)."""
    dev, dt = model.v_template.device, model.v_template.dtype

    def to(a):
        return torch.as_tensor(a).to(device=dev, dtype=dt)
    params, shapes, r0, kp = to(params), to(shapes), to(r0), to(kp)
    pose = params_to_pose(params, r0, model.num_joints)
    g_aff, joints = joint_affines(model, shapes, pose.rotations, pose.root_pos)
    err = mean_pixel_error(joints, kp, cam).cpu().numpy()
    if not want_verts:
        return err, None
    ops = prepare_lbs_operands(model)
    verts = torch.cat([
        lbs(shapes[s:s + SKIN_BATCH].contiguous(),
            g_aff[s:s + SKIN_BATCH].contiguous(), ops).transpose(1, 2)
        for s in range(0, params.shape[0], SKIN_BATCH)])
    return err, verts.cpu().numpy()


def render_overlay_image(model: SMPLModel, verts_cam: np.ndarray,
                         img: np.ndarray, cam: Camera,
                         use_jax: bool = False) -> np.ndarray:
    """Overlay render of camera-space vertices over ``img`` (H, W, 3)
    uint8, in place, with the host painter ``smpltpu.render.raster``.
    ``use_jax`` names the on-device tile-binned rasterizer of the
    reference, which is not ported yet."""
    if use_jax:
        raise NotImplementedError(
            "the on-device rasterizer (K3, smpltpu/render/pallas_raster.py::"
            "rasterize_tiled) is not ported yet (ROADMAP.md)")
    return render_mesh_overlay(
        verts_cam, model.faces, img,
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        fill=True, backface_cull=True, wireframe=False)
