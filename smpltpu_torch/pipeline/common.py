"""Shared pipeline plumbing (port of ``smpltpu/pipeline/common.py`` and of
the render pass of ``bench.py``): dataset loading, the log.csv sink,
per-frame evaluation error and skinned vertices for every frame, the
overlay render of one frame (into an image in memory, or from an image
file to an image file), the render of every frame on the device (skinning
through K2, face setup and rasterizing through K3), and fitted-parameter
persistence.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from smpltpu_torch.energy.reproj import Camera
from smpltpu_torch.io import load_keypoint_dir, load_pose_prior_txt, load_smpl_npz
from smpltpu_torch.io.keypoints import list_sorted
from smpltpu_torch.models.registry import (
    _is_lfs_stub,
    find_model_file,
    resolve_model,
)
from smpltpu_torch.models.smpl import SMPLModel
from smpltpu_torch.ops.lbs import joint_affines, lbs, prepare_lbs_operands
from smpltpu_torch.render.raster import render_mesh_overlay
from smpltpu_torch.render.zbuffer import rasterize_verts
from smpltpu_torch.utils.camera import default_intrinsics
from smpltpu_torch.utils.image import imread, imwrite
from smpltpu_torch.utils.metrics import mean_pixel_error
from smpltpu_torch.utils.obs import span
from smpltpu_torch.utils.writeback import params_to_pose

SKIN_BATCH = 100   # frames per skinning and raster launch (the reference bench's chunk)
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def is_number(s: str) -> bool:
    """Token classifier for the reference-style hand-rolled parsers
    (numerics consumed positionally, interleaved with flags)."""
    try:
        float(s)
        return True
    except ValueError:
        return False


def append_log(out_dir: str, rows: List[Tuple[int, float, float]]) -> str:
    """Append rows to out_dir/log.csv with a header-once guard.

    Schema parity: 'frame,mean_pixel_error_px,time_ms'
    (src/main_single_frame.cpp:260-269, src/main_multi_frame.cpp:39-42).
    """
    path = os.path.join(out_dir, "log.csv")
    exists = os.path.isfile(path)
    with open(path, "a") as f:
        if not exists:
            f.write("frame,mean_pixel_error_px,time_ms\n")
        for frame, err, ms in rows:
            f.write(f"{frame},{err},{ms}\n")
    return path


def load_dataset(smpl_path: str, kps_folder: str, img_folder: str,
                 midpoint_default_vis: float, *, device, dtype,
                 pose_prior_path: Optional[str] = None):
    """Load the model (onto ``device`` in ``dtype``), the image list with
    the intrinsics from the first image, and the dense keypoint batch.
    Returns a dict, or raises ValueError with the reference's early-exit
    messages.

    ``smpl_path``: a model npz, the avatar-model directory (model.npz and
    pose_prior.txt inside), a registry name (female/male/neutral) or
    synthetic[:n] (``models/registry.py``)."""
    images = list_sorted(img_folder, IMAGE_EXTS)
    if not images:
        raise ValueError(f"No images in {img_folder}")
    img0 = imread(images[0])
    if img0 is None:
        raise ValueError(f"Failed to read {images[0]}")
    height, width = img0.shape[:2]
    cam = default_intrinsics(width, height, device=device, dtype=dtype)

    if os.path.isfile(smpl_path):
        if _is_lfs_stub(smpl_path):
            raise ValueError(
                f"{smpl_path} is a git-LFS pointer stub, not a real model "
                "npz — fetch the real SMPL asset (see "
                "smpltpu_torch.models.registry)")
        model_dict = load_smpl_npz(smpl_path)
        model_dir = os.path.dirname(os.path.abspath(smpl_path))
    else:
        # resolve_model's priority: synthetic (exact) > registry name >
        # model directory; model_dir (for pose_prior.txt discovery) must
        # mirror whichever source actually won
        model_dict = resolve_model(smpl_path)
        found = find_model_file(smpl_path)
        if found is not None:
            model_dir = os.path.dirname(found)
        elif os.path.isdir(smpl_path):
            model_dir = os.path.abspath(smpl_path)
        else:
            model_dir = None
    model = SMPLModel.from_dict(model_dict, device=device, dtype=dtype)

    kp_batch, json_paths = load_keypoint_dir(
        kps_folder, width, height, midpoint_default_vis)
    if len(json_paths) == 0:
        raise ValueError(f"No JSON files in {kps_folder}")

    # pose prior: explicit path, else the avatar-model convention of a
    # pose_prior.txt next to the npz
    prior = None
    candidate = pose_prior_path or (
        os.path.join(model_dir, "pose_prior.txt") if model_dir else "")
    if os.path.isfile(candidate):
        prior = load_pose_prior_txt(candidate)

    return {
        "model": model,
        "model_dict": model_dict,
        "cam": cam,
        "images": images,
        "json_paths": json_paths,
        "kp_batch": kp_batch.astype(np.float64),
        "width": width,
        "height": height,
        "gmm": prior,
    }


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


def overlay_image(model: SMPLModel, verts_cam: np.ndarray, img: np.ndarray,
                  cam: Camera, use_jax: bool = False) -> np.ndarray:
    """Overlay render of camera-space vertices (nV, 3) over ``img``
    (H, W, 3) uint8, in place; returns ``img``. ``use_jax`` (the
    reference's name for the on-device render) rasterizes through the
    z-buffer K3 (``render/zbuffer.py::rasterize_verts``) on the model's
    device and writes the gray of every covered pixel; otherwise the host
    painter (``render/raster.py``) fills the faces far to near. There is no
    fallback from one to the other."""
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


def render_overlay_image(model: SMPLModel, verts_cam: np.ndarray,
                         image_path: str, out_path: str, cam: Camera,
                         use_jax: bool = False,
                         img: Optional[np.ndarray] = None) -> bool:
    """Overlay render from precomputed camera-space vertices (reference:
    renderSMPLMesh + imwrite, src/main_single_frame.cpp:273-277): read
    ``image_path`` (or take the preloaded ``img``), draw through
    :func:`overlay_image`, write ``out_path``. False if the image cannot
    be read. Unlike the reference, ``use_jax`` has no fallback: a K3
    failure raises."""
    if img is None:
        img = imread(image_path)
    if img is None:
        return False
    return imwrite(out_path, overlay_image(model, verts_cam, img, cam,
                                           use_jax=use_jax))


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
    tensors. Under a profiler the call is the span ``render.frames``, and
    each chunk's three parts ``render.fk``, ``render.lbs`` and
    ``render.raster``."""
    with span("render.frames"):
        return _render_frames(model, params, shape, r0, cam, height, width)


def _render_frames(model, params, shape, r0, cam, height, width):
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
        with span("render.fk"):
            pose = params_to_pose(params[s:e], r0[s:e], model.num_joints)
            shp = shape[s:e].contiguous()
            g_aff, _ = joint_affines(model, shp, pose.rotations, pose.root_pos)
        with span("render.lbs"):
            verts = lbs(shp, g_aff.contiguous(), ops).transpose(1, 2)
        with span("render.raster"):
            rasterize_verts(verts, faces, *intr, height, width,
                            out=(gray[s:e], covered[s:e]))
    return gray, covered


def np_rodrigues(aa: np.ndarray) -> np.ndarray:
    """Host-side angle-axis -> rotation matrix (write-back bookkeeping;
    avoids a device round-trip per frame)."""
    theta = float(np.linalg.norm(aa))
    if theta < 1e-14:
        return np.eye(3)
    k = aa / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def save_params(out_dir: str, name: str, params: np.ndarray,
                shape: np.ndarray, extra: Optional[dict] = None) -> str:
    """Persist fitted parameters (params, shape and any ``extra`` arrays)
    as out_dir/name, an npz archive."""
    path = os.path.join(out_dir, name)
    payload = {"params": np.asarray(params), "shape": np.asarray(shape)}
    if extra:
        payload.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez(path, **payload)
    return path


class StageTimer:
    """Wall milliseconds since construction. The caller synchronizes the
    device before reading it."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3
