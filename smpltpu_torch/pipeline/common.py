"""Pipeline plumbing of the fit's output stage (port of the evaluation and
overlay parts of ``smpltpu/pipeline/common.py`` and of the render pass of
``bench.py``): per-frame evaluation error and skinned vertices for every
frame, the overlay render of one frame, and the render of every frame on
the device (skinning through K2, face setup and rasterizing through K3).

Image files are not read or written here (the reference's image I/O is
not ported yet): callers pass and get numpy images.
"""

from __future__ import annotations

import numpy as np
import torch

from smpltpu_torch.energy.reproj import Camera
from smpltpu_torch.models.smpl import SMPLModel
from smpltpu_torch.ops.lbs import joint_affines, lbs, prepare_lbs_operands
from smpltpu_torch.render.raster import render_mesh_overlay
from smpltpu_torch.render.zbuffer import rasterize_verts
from smpltpu_torch.utils.metrics import mean_pixel_error
from smpltpu_torch.utils.writeback import params_to_pose

SKIN_BATCH = 100   # frames per skinning and raster launch (the reference bench's chunk)


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


def _intrinsics(cam: Camera):
    return float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)


def render_overlay_image(model: SMPLModel, verts_cam: np.ndarray,
                         img: np.ndarray, cam: Camera,
                         use_jax: bool = False) -> np.ndarray:
    """Overlay render of camera-space vertices (nV, 3) over ``img``
    (H, W, 3) uint8, in place; returns ``img``. ``use_jax`` (the
    reference's name for the on-device render) rasterizes through the
    z-buffer K3 (``render/zbuffer.py::rasterize_verts``) on the model's device
    and writes the gray of every covered pixel; otherwise the host painter
    (``render/raster.py``) fills the faces far to near."""
    if not use_jax:
        return render_mesh_overlay(verts_cam, model.faces, img,
                                   *_intrinsics(cam), fill=True,
                                   backface_cull=True, wireframe=False)
    verts = torch.as_tensor(np.asarray(verts_cam),
                            device=model.v_template.device)[None]
    faces = torch.as_tensor(model.faces, device=verts.device)
    gray, covered = rasterize_verts(verts, faces, *_intrinsics(cam),
                                    img.shape[0], img.shape[1])
    gray, covered = gray[0].cpu().numpy(), covered[0].cpu().numpy()
    img[covered] = gray[covered][:, None]
    return img


def render_frames(model: SMPLModel, params, shape, r0, cam: Camera,
                  height: int, width: int):
    """Render every frame on the model's device: the port of the render
    pass of ``bench.py`` (:384-453). params (F, P) per-frame parameters,
    shape (nS,) shared or (F, nS), r0 (3, 3) shared or (F, 3, 3), as
    tensors or numpy arrays. In chunks of SKIN_BATCH frames: FK, skinning
    through K2 (``ops/lbs.py::lbs``), then face setup and z-buffer in K3
    (``render/zbuffer.py::rasterize_verts``), which writes each chunk
    straight into its frames of the result; the vertices never leave the
    device. -> (gray (F, H, W) uint8, covered (F, H, W) bool), device
    tensors."""
    dev, dt = model.v_template.device, model.v_template.dtype

    def to(a):
        return torch.as_tensor(a).to(device=dev, dtype=dt)
    params, shape, r0 = to(params), to(shape), to(r0)
    n = params.shape[0]
    shape = shape.expand(n, shape.shape[-1])
    r0 = r0.expand(n, 3, 3)
    ops = prepare_lbs_operands(model)
    faces = torch.as_tensor(model.faces, device=dev)
    intr = _intrinsics(cam)
    gray = torch.empty((n, height, width), dtype=torch.uint8, device=dev)
    covered = torch.empty((n, height, width), dtype=torch.bool, device=dev)
    for s in range(0, n, SKIN_BATCH):
        e = min(s + SKIN_BATCH, n)
        pose = params_to_pose(params[s:e], r0[s:e], model.num_joints)
        shp = shape[s:e].contiguous()
        g_aff, _ = joint_affines(model, shp, pose.rotations, pose.root_pos)
        verts = lbs(shp, g_aff.contiguous(), ops).transpose(1, 2)
        rasterize_verts(verts, faces, *intr, height, width,
                        out=(gray[s:e], covered[s:e]))
    return gray, covered
