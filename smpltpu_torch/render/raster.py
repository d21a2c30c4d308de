"""Host painter: the software mesh-overlay rasterizer, copied from
``smpltpu/render/raster.py`` so that the port imports nothing of the JAX
package.

Project camera-space vertices with the pinhole model, backface-cull
(n.z >= 0 skipped), flat-shade gray 220 * clamp(n_hat . view, 0, 1),
painter's sort far-to-near by mean triangle depth, fill. The geometry stage
is vectorized numpy; the fill is the original's order: cv2 when it is
installed, else the host runtime's C++ fill (``smpltpu_torch.native``);
where neither is there the overlay raises, naming both. The numpy
half-plane fill, ``_fill_triangles_numpy``, is the plain version the C++
fill is held to, pixel for pixel; it is vectorized over faces here, where
the original loops over them one at a time. The on-device z-buffer is
``render/zbuffer.py``.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2  # type: ignore
    _HAS_CV2 = True
except ImportError:  # pragma: no cover - environment dependent
    cv2 = None
    _HAS_CV2 = False


def build_drawlist(verts_cam: np.ndarray, faces: np.ndarray,
                   fx: float, fy: float, cx: float, cy: float,
                   backface_cull: bool = True):
    """Vectorized geometry stage. Returns (tri_px (M,3,2) float, shade (M,))
    already painter-sorted far-to-near.

      * verts with z <= 1e-6 are invalid; faces touching one are skipped
      * normal n = (v1-v0) x (v2-v0); cull when n.z >= 0
      * shade = clamp(n_hat . normalize(-centroid), 0, 1)
      * depth = mean z, sorted descending
    """
    verts_cam = np.asarray(verts_cam, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    z = verts_cam[:, 2]
    valid = z > 1e-6
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * verts_cam[:, 0] / z + cx
        v = fy * verts_cam[:, 1] / z + cy
    proj = np.stack([u, v], axis=-1)

    tri = verts_cam[faces]                    # (F, 3, 3)
    tri_valid = valid[faces].all(axis=1)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    keep = tri_valid
    if backface_cull:
        keep = keep & (n[:, 2] < 0.0)

    center = tri.mean(axis=1)
    n_norm = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    view = -center / np.maximum(np.linalg.norm(center, axis=-1, keepdims=True), 1e-30)
    shade = np.clip(np.sum(n_norm * view, axis=-1), 0.0, 1.0)
    depth = tri[:, :, 2].mean(axis=1)

    idx = np.where(keep)[0]
    order = idx[np.argsort(-depth[idx], kind="stable")]
    return proj[faces[order]], shade[order]


FILL_CHUNK_PX = 1 << 20   # candidate pixels tested at once by the numpy fill


def _fill_triangles_numpy(img: np.ndarray, tris: np.ndarray,
                          colors: np.ndarray) -> None:
    """Pure-numpy half-plane fill (no anti-aliasing), in draw order: a
    pixel takes the colour of the last triangle that covers it. The
    pixels of the triangles' clipped boxes are tested in chunks of about
    FILL_CHUNK_PX with the original's per-triangle arithmetic (pixel
    centres, float64 edge functions, the 1e-12 edge tolerance)."""
    h, w = img.shape[:2]
    x0 = np.maximum(np.floor(tris[:, :, 0].min(1)).astype(np.int64), 0)
    x1 = np.minimum(np.ceil(tris[:, :, 0].max(1)).astype(np.int64) + 1, w)
    y0 = np.maximum(np.floor(tris[:, :, 1].min(1)).astype(np.int64), 0)
    y1 = np.minimum(np.ceil(tris[:, :, 1].max(1)).astype(np.int64) + 1, h)
    bw = np.maximum(x1 - x0, 0)
    n_px = bw * np.maximum(y1 - y0, 0)
    flat = img.reshape(h * w, -1)
    ends = np.cumsum(n_px)
    lo = 0
    while lo < len(tris):
        # the triangles whose boxes fit the chunk (at least one)
        hi = max(int(np.searchsorted(ends, (ends[lo] - n_px[lo])
                                     + FILL_CHUNK_PX, side="right")), lo + 1)
        f = np.repeat(np.arange(lo, hi), n_px[lo:hi])
        off = np.arange(len(f)) - np.repeat(ends[lo:hi] - n_px[lo:hi]
                                            - (ends[lo] - n_px[lo]),
                                            n_px[lo:hi])
        px = x0[f] + off % bw[f]
        py = y0[f] + off // bw[f]
        xx, yy = px + 0.5, py + 0.5
        inside = np.ones(len(f), dtype=bool)
        sign = None
        for i in range(3):
            ax, ay = tris[f, i, 0], tris[f, i, 1]
            bx, by = tris[f, (i + 1) % 3, 0], tris[f, (i + 1) % 3, 1]
            e = (bx - ax) * (yy - ay) - (by - ay) * (xx - ax)
            s = e >= 0
            if sign is None:
                sign = s
            inside &= (s == sign) | (np.abs(e) < 1e-12)
        pix, f = (py * w + px)[inside], f[inside]
        # the last triangle at each pixel: the first in reversed order
        last = len(pix) - 1 - np.unique(pix[::-1], return_index=True)[1]
        flat[pix[last]] = colors[f[last]]
        lo = hi


def render_mesh_overlay(
    verts_cam: np.ndarray,   # (nV, 3) camera-space vertices
    faces: np.ndarray,       # (nF, 3) int
    img: np.ndarray,         # (H, W, 3) uint8, modified in place
    fx: float, fy: float, cx: float, cy: float,
    fill: bool = True,
    backface_cull: bool = True,
    wireframe: bool = False,
) -> np.ndarray:
    """Render the mesh over `img` in place and return it."""
    tris, shade = build_drawlist(verts_cam, faces, fx, fy, cx, cy,
                                 backface_cull)
    gray = np.round(220.0 * shade).astype(np.int32)
    if fill:
        if _HAS_CV2:
            # LINE_AA antialiasing matches the reference byte-for-byte
            pts = np.round(tris).astype(np.int32)
            for p, c in zip(pts, gray):
                cv2.fillConvexPoly(img, p, (int(c), int(c), int(c)),
                                   cv2.LINE_AA)
        else:
            from smpltpu_torch import native
            try:
                native.fill_triangles(img, tris, gray)
            except native.NativeBuildError as e:
                raise RuntimeError(
                    "render_mesh_overlay needs cv2 or the host runtime's "
                    f"fill, and has neither: {e}") from e
    if wireframe:
        pts = np.round(tris).astype(np.int32)
        if _HAS_CV2:
            for p in pts:
                cv2.polylines(img, [np.vstack([p, p[:1]])], False,
                              (40, 40, 40), 1, cv2.LINE_AA)
        else:  # cheap fallback: mark vertices
            h, w = img.shape[:2]
            for p in pts.reshape(-1, 2):
                if 0 <= p[1] < h and 0 <= p[0] < w:
                    img[p[1], p[0]] = (40, 40, 40)
    return img
