"""K3: the on-device z-buffer mesh rasterizer, batched over frames.

Twins in the reference: ``smpltpu/render/pallas_raster.py``
(``rasterize_tiled``, the TPU kernel that K3 replaces) and
``smpltpu/render/jax_raster.py`` (``rasterize_zbuffer``, the scatter-min
version). All three compute, for each pixel of each frame, the minimum
packed key ``depth_q << 8 | gray`` over the kept faces (in front of the
camera, facing it) whose edge functions at the pixel center are all
> -1e-12; the output is ``(gray uint8 (B, H, W), covered bool (B, H, W))``
with gray 0 where nothing covers the pixel.

- ``face_setup``: per-face projection, culling, shading, packed key and
  edge coefficients, plain PyTorch (plain JAX outside the kernel in the
  reference too).
- ``rasterize_torch``: the plain version, a scatter-min of every kept
  face's fragments over its whole clipped bounding box. The tests and the
  card check use it.
- ``rasterize``: the CUDA kernel ``csrc/raster.cu`` for a CUDA tensor, the
  plain version for a CPU tensor. Counts its launches in
  ``LAUNCHES["raster"]``.

The reference's sort-binning, compacted worklist, static caps and host
sizing helpers (``pick_spans``, ``pick_cap``, ``pick_active``,
``pick_entries``) exist for the TPU's scatter cost and static shapes and
have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smpltpu_torch import _build
from smpltpu_torch.ops import LAUNCHES

SENTINEL = 0x7FFFFFFF        # key of a culled face and of an empty pixel
DEPTH_LEVELS = 2 ** 22 - 2   # depth_q range: 22 bits above the 8 gray bits
EDGE_SLACK = -1e-12          # inside test: min(e0, e1, e2) > EDGE_SLACK (f32)
PIECE = 1024                 # bounding-box pixels per work item of the kernel


class FaceSetup(NamedTuple):
    """Per-face screen data of B frames, float32 and int32 on one device."""
    u: torch.Tensor      # (B, F, 3) pixel x of the corners
    v: torch.Tensor      # (B, F, 3) pixel y of the corners
    key: torch.Tensor    # (B, F) int32 depth_q << 8 | gray, SENTINEL if culled
    keep: torch.Tensor   # (B, F) bool: in front of the camera and facing it
    coef: torch.Tensor   # (B, F, 9) A_k, B_k, C_k of the 3 edges, canonical winding


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def face_setup(verts: torch.Tensor, faces, fx, fy, cx, cy) -> FaceSetup:
    """verts (B, nV, 3) camera-space vertices in any float type (cast to
    float32, as ``rasterize_tiled`` casts), faces (F, 3) int -> FaceSetup.

    Port of ``pallas_raster._face_setup`` (projection, the z > 1e-6 test,
    backface cull n_z < 0, gray = round(220 clip(n_hat . view, 0, 1)),
    depth quantized against each frame's own far kept face) and of the
    edge coefficients of ``rasterize_tiled`` (e = A x + B y + C per edge,
    signs flipped where the screen area is negative), in the same order of
    float32 operations."""
    verts = verts.to(torch.float32)
    faces = torch.as_tensor(faces, device=verts.device).long()
    tri = verts[:, faces]                                  # (B, F, 3, 3)
    z = tri[..., 2]
    valid = torch.all(z > 1e-6, dim=-1)
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    u = fx * tri[..., 0] / zs + cx
    v = fy * tri[..., 1] / zs + cy

    n = _cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    keep = valid & (n[..., 2] < 0.0)
    # the mean of the corners as XLA lowers the reference's: times f32(1/3)
    center = (tri[..., 0, :] + tri[..., 1, :] + tri[..., 2, :]) * (1.0 / 3.0)
    n_hat = n / torch.clamp(torch.sqrt(_sum3(n * n)), min=1e-30)[..., None]
    view = -center / torch.clamp(torch.sqrt(_sum3(center * center)),
                                 min=1e-30)[..., None]
    shade = torch.clamp(_sum3(n_hat * view), 0.0, 1.0)
    gray = torch.round(220.0 * shade).to(torch.int32)
    depth = center[..., 2]
    zmax = torch.where(keep, depth, 0.0).amax(dim=-1, keepdim=True) + 1e-6
    depth_q = torch.clamp(depth / zmax * DEPTH_LEVELS, 0,
                          DEPTH_LEVELS).to(torch.int32)
    key = torch.where(keep, (depth_q << 8) | gray, SENTINEL).to(torch.int32)

    coefs = []
    for k in range(3):
        j = (k + 1) % 3
        ax, ay, bx, by = u[..., k], v[..., k], u[..., j], v[..., j]
        coefs += [-(by - ay), bx - ax, (by - ay) * ax - (bx - ax) * ay]
    coef = torch.stack(coefs, -1)                          # (B, F, 9)
    area = ((u[..., 1] - u[..., 0]) * (v[..., 2] - v[..., 0])
            - (v[..., 1] - v[..., 0]) * (u[..., 2] - u[..., 0]))
    coef = coef * torch.where(area < 0.0, -1.0, 1.0)[..., None]
    return FaceSetup(u, v, key, keep, coef.contiguous())


def face_bbox(setup: FaceSetup, height: int, width: int) -> torch.Tensor:
    """(B, F, 4) int32 [x0, y0, w, h]: the pixels the face's bounding box
    touches, clipped to the frame; w = h = 0 for a culled or off-screen
    face. Kernel and plain version walk exactly these pixels. The corners
    are clamped to [-1, size] before the conversion to int, so huge or
    infinite projections stay defined; a NaN corner drops the face."""
    def span(c, size):
        lo, hi = c.amin(dim=-1), c.amax(dim=-1)
        ok = lo <= hi                                      # False on NaN
        a = torch.floor(torch.clamp(torch.where(ok, lo, 0.0), -1.0, float(size)))
        b = torch.floor(torch.clamp(torch.where(ok, hi, -1.0), -1.0, float(size)))
        a = torch.clamp(a.to(torch.int32), min=0)
        b = torch.clamp(b.to(torch.int32), max=size - 1)
        return a, torch.clamp(b - a + 1, min=0)
    x0, bw = span(setup.u, width)
    y0, bh = span(setup.v, height)
    on = setup.keep & (bw > 0) & (bh > 0)
    zero = torch.zeros_like(x0)
    return torch.stack([torch.where(on, x0, zero), torch.where(on, y0, zero),
                        torch.where(on, bw, zero), torch.where(on, bh, zero)],
                       -1).contiguous()


def _resolve(zbuf: torch.Tensor):
    covered = zbuf != SENTINEL
    gray = torch.where(covered, zbuf & 0xFF, 0).to(torch.uint8)
    return gray, covered


def rasterize_torch(setup: FaceSetup, height: int, width: int):
    """Plain version: per frame, every pixel of every kept face's clipped
    bounding box is tested with e_k = (px * A_k) + ((py * B_k) + C_k) at
    the pixel center, and the inside fragments' keys are folded into the
    z-buffer by one int32 scatter-min. -> (gray (B, H, W) uint8, covered
    (B, H, W) bool). Nothing is truncated, however large the face."""
    b_n, _ = setup.key.shape
    dev = setup.key.device
    bbox = face_bbox(setup, height, width).long()
    slack = torch.tensor(EDGE_SLACK, dtype=torch.float32, device=dev)
    zbuf = torch.full((b_n, height * width), SENTINEL, dtype=torch.int32,
                      device=dev)
    for b in range(b_n):
        x0, y0, bw, bh = bbox[b].unbind(-1)
        n = bw * bh
        idx = torch.nonzero(n > 0).squeeze(1)
        cnt = n[idx]
        face = torch.repeat_interleave(idx, cnt)
        start = torch.cumsum(cnt, 0) - cnt
        off = (torch.arange(face.numel(), device=dev)
               - torch.repeat_interleave(start, cnt))
        w_f = bw[face]
        x = x0[face] + off % w_f
        y = y0[face] + torch.div(off, w_f, rounding_mode="floor")
        px = x.to(torch.float32) + 0.5
        py = y.to(torch.float32) + 0.5
        c = setup.coef[b, face]                            # (T, 9)
        e = [px * c[:, 3 * k] + (py * c[:, 3 * k + 1] + c[:, 3 * k + 2])
             for k in range(3)]
        inside = torch.minimum(torch.minimum(e[0], e[1]), e[2]) > slack
        zbuf[b].scatter_reduce_(0, (y * width + x)[inside],
                                setup.key[b, face][inside], "amin")
    return _resolve(zbuf.view(b_n, height, width))


def rasterize(setup: FaceSetup, height: int, width: int):
    """K3 on CUDA tensors (``csrc/raster.cu``), the plain version on CPU
    tensors; raises on any other device and on inputs the kernel does not
    take. -> (gray (B, H, W) uint8, covered (B, H, W) bool)."""
    dev = setup.key.device
    if dev.type == "cpu":
        return rasterize_torch(setup, height, width)
    if dev.type != "cuda":
        raise ValueError(f"rasterize: no kernel for device {dev}")
    b_n, f_n = setup.key.shape
    for name, t, shape, dtype in (
            ("u", setup.u, (b_n, f_n, 3), torch.float32),
            ("v", setup.v, (b_n, f_n, 3), torch.float32),
            ("key", setup.key, (b_n, f_n), torch.int32),
            ("keep", setup.keep, (b_n, f_n), torch.bool),
            ("coef", setup.coef, (b_n, f_n, 9), torch.float32)):
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"rasterize: {name} must be {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (setup.key.is_contiguous() and setup.coef.is_contiguous()):
        raise ValueError("rasterize: key and coef must be contiguous")
    if not (0 < height < 2 ** 22 and 0 < width < 2 ** 22
            and height * width <= 2 ** 30):
        raise ValueError(f"rasterize: frame size {height} x {width} out of range")
    bbox = face_bbox(setup, height, width)
    pieces = (bbox[..., 2].long() * bbox[..., 3] + PIECE - 1) // PIECE
    item_end = torch.cumsum(pieces.view(-1), 0)
    zbuf = torch.full((b_n, height, width), SENTINEL, dtype=torch.int32,
                      device=dev)
    gray = torch.empty((b_n, height, width), dtype=torch.uint8, device=dev)
    covered = torch.empty((b_n, height, width), dtype=torch.bool, device=dev)
    lib = _build.load()
    err = lib.smpltpu_raster_i32(
        bbox.data_ptr(), setup.coef.data_ptr(), setup.key.data_ptr(),
        item_end.data_ptr(), b_n, f_n, height, width, PIECE, zbuf.data_ptr(),
        gray.data_ptr(), covered.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rasterize: kernel launch failed with CUDA error {err}")
    LAUNCHES["raster"] += 1
    return gray, covered
