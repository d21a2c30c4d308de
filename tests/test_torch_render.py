"""The port's render stage against the JAX package on the CPU: the per-face
setup of ``render/zbuffer.py`` against ``pallas_raster._face_setup`` and
the edge coefficients of ``rasterize_tiled``, the plain z-buffer
``rasterize_torch`` and the entry point ``rasterize_verts`` pixel for pixel
against ``jax_raster.rasterize_zbuffer`` and
``pallas_raster.rasterize_tiled`` (interpret mode), the wrappers' device
and ``out=`` rules, the kernels' tiling plan, and the host painter copy
against the original.

Tolerances: none. The setup runs the reference's float32 operations in
the reference's order, so u, v, the edge coefficients, keys and the cull
agree bit for bit, and the images must agree in every pixel.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smpltpu.native
import smpltpu.render.raster as j_painter
from smpltpu.models import SMPLModel as JModel
from smpltpu.models import smpl_forward as j_forward
from smpltpu.models.synthetic import make_synthetic_model
from smpltpu.render.jax_raster import pick_patch, rasterize_zbuffer
from smpltpu.render.pallas_raster import _face_setup, pick_cap, rasterize_tiled
from smpltpu_torch.ops import LAUNCHES
from smpltpu_torch.render import raster as painter
from smpltpu_torch.render import zbuffer
from smpltpu_torch.render.zbuffer import (
    SENTINEL,
    FaceSetup,
    face_bbox,
    face_setup,
    raster_plan,
    rasterize,
    rasterize_torch,
    rasterize_verts,
)

FX = FY = 200.0
CX, CY = 64.0, 48.0
H, W = 96, 128


def _mesh(model_dict, root):
    jm = JModel.from_dict(model_dict, dtype=jnp.float32)
    out = j_forward(jm, jnp.zeros(10), jnp.broadcast_to(jnp.eye(3), (24, 3, 3)),
                    jnp.asarray(root, jnp.float32))
    return np.asarray(out["verts"], np.float32), np.asarray(jm.faces, np.int32)


def _scene(name, model_dict):
    """(verts (nV, 3) float32, faces (F, 3) int32) of one named test scene."""
    if name == "triangle":
        return (np.array([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.3, 2.0]],
                         np.float32), np.array([[0, 2, 1]], np.int32))
    if name == "occlusion":     # the near (z = 1.5) face hides part of the far
        # (corners off the pixel grid: on a center that lies exactly on an
        # edge, the two references' edge formulas round to either side)
        return (np.array([[-0.31, -0.29, 2.0], [0.33, -0.27, 2.05],
                          [0.02, 0.41, 1.95], [-0.21, -0.19, 1.5],
                          [0.23, -0.22, 1.52], [-0.01, 0.26, 1.49]],
                         np.float32), np.array([[0, 2, 1], [3, 5, 4]], np.int32))
    if name == "culled":        # back-facing, and behind the camera
        return (np.array([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.3, 2.0],
                          [-0.2, -0.2, -1.0], [0.2, -0.2, -1.0], [0.0, 0.3, -1.0]],
                         np.float32), np.array([[0, 1, 2], [3, 5, 4]], np.int32))
    if name == "big_face":      # a near face past every edge of the frame
        return (np.array([[-1.0, -0.8, 0.5], [1.0, -0.8, 0.5], [0.0, 1.2, 0.5]],
                         np.float32), np.array([[0, 2, 1]], np.int32))
    roots = {"mesh": [0.0, 0.0, 2.5], "close_up": [0.0, 0.0, 1.2],
             "off_screen": [0.4, -0.2, 1.6]}
    return _mesh(model_dict, roots[name])


def _setup(verts, faces):
    return face_setup(torch.as_tensor(verts)[None], torch.as_tensor(faces),
                      FX, FY, CX, CY)


SCENES = ["triangle", "occlusion", "culled", "big_face", "mesh", "close_up",
          "off_screen"]


@pytest.mark.parametrize("name", ["occlusion", "mesh", "close_up", "off_screen"])
def test_face_setup_matches_pallas_setup(small_model_dict, name):
    """u, v, keys and the cull bit for bit against ``_face_setup``, and the
    edge coefficients against the expression of ``rasterize_tiled``
    (pallas_raster.py:494-519) on the reference's own u, v."""
    verts, faces = _scene(name, small_model_dict)
    ju, jv, jkey, jkeep = map(np.asarray, _face_setup(
        jnp.asarray(verts), jnp.asarray(faces), FX, FY, CX, CY))
    coefs = []
    for k in range(3):
        ax, ay = ju[:, k], jv[:, k]
        bx, by = ju[:, (k + 1) % 3], jv[:, (k + 1) % 3]
        coefs += [-(by - ay), bx - ax, (by - ay) * ax - (bx - ax) * ay]
    area = ((ju[:, 1] - ju[:, 0]) * (jv[:, 2] - jv[:, 0])
            - (jv[:, 1] - jv[:, 0]) * (ju[:, 2] - ju[:, 0]))
    jcoef = np.stack(coefs, -1) * np.where(area < 0, -1.0, 1.0).astype(
        np.float32)[:, None]

    st = _setup(verts, faces)
    for got, want in ((st.u, ju), (st.v, jv), (st.coef, jcoef)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(st.key[0].numpy(), jkey)
    np.testing.assert_array_equal(st.keep[0].numpy(), jkeep)
    assert st.key.dtype == torch.int32
    assert (st.key[~st.keep] == SENTINEL).all()


def _tiled(verts, faces):
    mc, bc = pick_cap(verts, faces, FX, FY, CX, CY, H, W)
    g, c = rasterize_tiled(jnp.asarray(verts), jnp.asarray(faces), FX, FY,
                           CX, CY, H, W, max_chunks=mc, big_cap=bc,
                           interpret=True)
    return np.asarray(g), np.asarray(c)


def _zbuffer(verts, faces):
    patch = pick_patch(verts, faces, FX, FY, CX, CY)
    g, c = rasterize_zbuffer(jnp.asarray(verts), jnp.asarray(faces), FX, FY,
                             CX, CY, H, W, patch=patch)
    return np.asarray(g), np.asarray(c)


def _check_scene(name, verts, covered):
    n = int(covered.sum())
    if name == "culled":
        assert n == 0
    elif name == "big_face":
        assert n == H * W
    else:
        assert n > 100, n


@pytest.mark.parametrize("reference", ["zbuffer", "tiled"])
@pytest.mark.parametrize("name", SCENES)
def test_rasterize_torch_pixel_exact(small_model_dict, name, reference):
    verts, faces = _scene(name, small_model_dict)
    gray, covered = rasterize_torch(_setup(verts, faces), H, W)
    assert gray.shape == (1, H, W) and gray.dtype == torch.uint8
    assert covered.dtype == torch.bool
    ref = {"zbuffer": _zbuffer, "tiled": _tiled}[reference]
    g_ref, c_ref = ref(verts, faces)
    np.testing.assert_array_equal(covered[0].numpy(), c_ref)
    np.testing.assert_array_equal(gray[0].numpy(), g_ref)
    _check_scene(name, verts, c_ref)
    if name == "off_screen":     # the scene does cross the frame's edge
        st = _setup(verts, faces)
        u = st.u[0][st.keep[0]]
        assert float(u.max()) > W and float(u.min()) < W


def test_full_width_frame_matches_zbuffer():
    """One frame of the full-width synthetic model (6890 vertices, 13 776
    faces) at 270 x 480 with the bench camera scaled by 0.375."""
    s = 0.375
    fx, cx, cy = 1152.0 * s, 360.0 * s, 640.0 * s
    h, w = int(1280 * s), int(720 * s)
    verts, faces = _mesh(make_synthetic_model(), [0.1, -0.1, 3.2])
    st = face_setup(torch.as_tensor(verts)[None], torch.as_tensor(faces),
                    fx, fx, cx, cy)
    gray, covered = rasterize_torch(st, h, w)
    g_ref, c_ref = rasterize_zbuffer(
        jnp.asarray(verts), jnp.asarray(faces), fx, fx, cx, cy, h, w,
        patch=pick_patch(verts, faces, fx, fx, cx, cy))
    np.testing.assert_array_equal(covered[0].numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(gray[0].numpy(), np.asarray(g_ref))
    assert int(covered.sum()) > 5000


def test_batch_equals_single_frames(small_model_dict):
    """Three frames in one call, each depth-quantized against its own far
    face, equal three single-frame calls."""
    frames = [_scene(n, small_model_dict)[0]
              for n in ("mesh", "close_up", "off_screen")]
    faces = torch.as_tensor(_scene("mesh", small_model_dict)[1])
    batch = face_setup(torch.as_tensor(np.stack(frames)), faces, FX, FY, CX, CY)
    gray, covered = rasterize_torch(batch, H, W)
    for b, verts in enumerate(frames):
        single = face_setup(torch.as_tensor(verts)[None], faces, FX, FY, CX, CY)
        np.testing.assert_array_equal(batch.key[b].numpy(), single.key[0].numpy())
        g1, c1 = rasterize_torch(single, H, W)
        torch.testing.assert_close(gray[b], g1[0], rtol=0, atol=0)
        torch.testing.assert_close(covered[b], c1[0], rtol=0, atol=0)


def test_face_bbox_clips_to_the_frame(small_model_dict):
    """Culled faces get an empty box; the boxes stay inside the frame,
    also for a face whose corners project far outside it."""
    for name in ("culled", "big_face", "off_screen"):
        verts, faces = _scene(name, small_model_dict)
        st = _setup(verts, faces)
        x0, y0, bw, bh = face_bbox(st, H, W)[0].unbind(-1)
        assert (bw[~st.keep[0]] == 0).all() and (bh[~st.keep[0]] == 0).all()
        assert (x0 >= 0).all() and (y0 >= 0).all()
        assert (x0 + bw <= W).all() and (y0 + bh <= H).all()
    assert x0.dtype == torch.int32


def test_rasterize_cpu_takes_plain_version(small_model_dict):
    """On a CPU tensor the wrapper is the plain version and counts no
    kernel launch."""
    st = _setup(*_scene("mesh", small_model_dict))
    LAUNCHES.clear()
    gray, covered = rasterize(st, H, W)
    g1, c1 = rasterize_torch(st, H, W)
    assert LAUNCHES["raster"] == 0
    torch.testing.assert_close(gray, g1, rtol=0, atol=0)
    torch.testing.assert_close(covered, c1, rtol=0, atol=0)


def test_rasterize_raises_on_meta_tensor():
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    st = FaceSetup(t((1, 2, 3), torch.float32), t((1, 2, 3), torch.float32),
                   t((1, 2), torch.int32), t((1, 2), torch.bool),
                   t((1, 2, 9), torch.float32))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rasterize(st, H, W)


def _verts_call(verts, faces, **kw):
    return rasterize_verts(torch.as_tensor(verts)[None], torch.as_tensor(faces),
                           FX, FY, CX, CY, H, W, **kw)


@pytest.mark.parametrize("name", SCENES)
def test_rasterize_verts_cpu_equals_plain(small_model_dict, name):
    """On CPU tensors ``rasterize_verts`` is ``rasterize_torch(face_setup(
    ...))`` and counts no kernel launch."""
    verts, faces = _scene(name, small_model_dict)
    LAUNCHES.clear()
    gray, covered = _verts_call(verts, faces)
    g1, c1 = rasterize_torch(_setup(verts, faces), H, W)
    assert LAUNCHES["raster"] == 0 and LAUNCHES["raster_setup"] == 0
    torch.testing.assert_close(gray, g1, rtol=0, atol=0)
    torch.testing.assert_close(covered, c1, rtol=0, atol=0)


@pytest.mark.parametrize("reference", ["zbuffer", "tiled"])
@pytest.mark.parametrize("name", SCENES)
def test_rasterize_verts_pixel_exact(small_model_dict, name, reference):
    """The entry point from the vertices against both references of the
    JAX package, every pixel."""
    verts, faces = _scene(name, small_model_dict)
    gray, covered = _verts_call(verts, faces)
    assert gray.shape == (1, H, W) and gray.dtype == torch.uint8
    assert covered.dtype == torch.bool
    g_ref, c_ref = {"zbuffer": _zbuffer, "tiled": _tiled}[reference](verts, faces)
    np.testing.assert_array_equal(covered[0].numpy(), c_ref)
    np.testing.assert_array_equal(gray[0].numpy(), g_ref)
    _check_scene(name, verts, c_ref)


def test_rasterize_verts_takes_strided_and_float64_vertices(small_model_dict):
    """Vertices in the skinning kernel's coordinate-major layout (a
    transposed view) and in float64 (cast to float32, as the reference
    casts) give the same image."""
    verts, faces = _scene("close_up", small_model_dict)
    want = _verts_call(verts, faces)
    major = torch.as_tensor(verts).T.contiguous().T      # (nV, 3), strides (1, nV)
    assert not major.is_contiguous()
    for v in (major, torch.as_tensor(verts, dtype=torch.float64)):
        got = rasterize_verts(v[None], torch.as_tensor(faces), FX, FY, CX, CY,
                              H, W)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _three_frames(small_model_dict):
    frames = np.stack([_scene(n, small_model_dict)[0]
                       for n in ("mesh", "close_up", "off_screen")])
    return torch.as_tensor(frames), torch.as_tensor(
        _scene("mesh", small_model_dict)[1])


@pytest.mark.parametrize("entry", ["rasterize", "rasterize_verts"])
@pytest.mark.parametrize("view", ["chunk", "every_other"])
def test_out_writes_into_batch_views(small_model_dict, entry, view):
    """``out=(gray, covered)`` writes a batch into views of larger results
    (a chunk of consecutive frames, as ``render_frames`` passes, and a
    strided one) and returns those views; the other frames stay as they
    were."""
    verts, faces = _three_frames(small_model_dict)
    gray = torch.full((6, H, W), 7, dtype=torch.uint8)
    covered = torch.ones((6, H, W), dtype=torch.bool)
    idx = slice(1, 4) if view == "chunk" else slice(0, 6, 2)
    out = (gray[idx], covered[idx])
    if entry == "rasterize":
        got = rasterize(face_setup(verts, faces, FX, FY, CX, CY), H, W, out=out)
    else:
        got = rasterize_verts(verts, faces, FX, FY, CX, CY, H, W, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    want = rasterize_torch(face_setup(verts, faces, FX, FY, CX, CY), H, W)
    torch.testing.assert_close(gray[idx], want[0], rtol=0, atol=0)
    torch.testing.assert_close(covered[idx], want[1], rtol=0, atol=0)
    rest = torch.ones(6, dtype=torch.bool)
    rest[idx] = False
    assert (gray[rest] == 7).all() and covered[rest].all()
    assert int(want[1].sum()) > 300


@pytest.mark.parametrize("bad,match", [
    ("dtype", "gray must be torch.uint8"),
    ("shape", "covered must be torch.bool"),
    ("frames", "gray must be torch.uint8"),
])
def test_out_is_checked(small_model_dict, bad, match):
    verts, faces = _three_frames(small_model_dict)
    gray = torch.zeros((3, H, W), dtype=torch.uint8)
    covered = torch.zeros((3, H, W), dtype=torch.bool)
    out = {"dtype": (gray.to(torch.int32), covered),
           "shape": (gray, covered[:, :-1]),
           "frames": (gray[:2], covered[:2])}[bad]
    with pytest.raises(ValueError, match=match):
        rasterize_verts(verts, faces, FX, FY, CX, CY, H, W, out=out)


def test_rasterize_verts_raises_on_meta_tensor():
    verts = torch.empty((1, 4, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rasterize_verts(verts, torch.zeros((2, 3), dtype=torch.int32), FX, FY,
                        CX, CY, H, W)


@pytest.mark.parametrize("n_frames,n_faces", [(1, 1), (3, 596), (100, 13776)])
@pytest.mark.parametrize("height,width", [
    (1280, 720), (250, 130), (H, W), (32, 80), (33, 81), (1, 1), (31, 79)])
def test_raster_plan(n_frames, n_faces, height, width):
    """The kernels' tiling: the tiles cover the frame, only the last
    column and row ragged, and the scratch holds what the lists can reach
    at most (every face in SMALL_TILES lists, or once in the big list)."""
    plan = raster_plan(n_frames, n_faces, height, width)
    tw, th = zbuffer.TILE_W, zbuffer.TILE_H
    assert (plan.tiles_x - 1) * tw < width <= plan.tiles_x * tw
    assert (plan.tiles_y - 1) * th < height <= plan.tiles_y * th
    tiles = plan.tiles_x * plan.tiles_y
    assert plan.meta_ints == n_frames * (3 + 3 * tiles)
    assert plan.list_ints == n_frames * zbuffer.SMALL_TILES * n_faces
    assert plan.big_ints == n_frames * n_faces
    assert tw % 16 == 0        # whole 16-byte stores when W is a multiple of 16


@pytest.mark.parametrize("kw,match", [
    ({"height": 0}, "frame size 0 x 720"),
    ({"width": 2 ** 22 + 1}, "frame size"),
    ({"height": 2 ** 16, "width": 2 ** 16}, "frame size"),
    ({"n_frames": 0}, "0 frames"),
    ({"n_frames": 65536}, "65536 frames"),
    ({"n_faces": 0}, "of 0 faces"),
    ({"n_frames": 60000, "n_faces": 13776}, "out of range"),
])
def test_raster_plan_refuses(kw, match):
    args = {"n_frames": 100, "n_faces": 13776, "height": 1280, "width": 720,
            **kw}
    with pytest.raises(ValueError, match=match):
        raster_plan(**args)


def test_raster_constants_match_the_kernel_source():
    """The plan mirrors the kernels' tiling and record size: the constants
    of render/zbuffer.py against those of csrc/raster.cu."""
    src = (Path(zbuffer.__file__).resolve().parents[1] / "csrc"
           / "raster.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)[;,]", src).group(1))
    assert const("kTileW") == zbuffer.TILE_W
    assert const("kTileH") == zbuffer.TILE_H
    assert const("kSmallTiles") == zbuffer.SMALL_TILES
    assert const("kRec") == zbuffer.REC_INTS
    assert "0x7FFFFFFF" in src and SENTINEL == 0x7FFFFFFF


def test_painter_copy_matches_numpy_fill(small_model_dict, monkeypatch):
    """The port's host painter equals ``smpltpu.render.raster`` on the numpy
    fill path (cv2 and the native library switched off on the reference
    side)."""
    monkeypatch.setattr(j_painter, "_HAS_CV2", False)
    monkeypatch.setattr(painter, "_HAS_CV2", False)
    monkeypatch.setattr(smpltpu.native, "available", lambda: False)
    verts, faces = _scene("mesh", small_model_dict)
    verts = verts.astype(np.float64)
    got = painter.render_mesh_overlay(verts, faces, np.zeros((H, W, 3), np.uint8),
                                      FX, FY, CX, CY, wireframe=True)
    want = j_painter.render_mesh_overlay(verts, faces,
                                         np.zeros((H, W, 3), np.uint8),
                                         FX, FY, CX, CY, wireframe=True)
    np.testing.assert_array_equal(got, want)
    assert int((got > 0).any(axis=-1).sum()) > 100


def test_painter_copy_matches_cv2_fill(small_model_dict):
    """The same on the cv2 fill path, where cv2 is installed."""
    pytest.importorskip("cv2")
    assert painter._HAS_CV2 and j_painter._HAS_CV2
    verts, faces = _scene("close_up", small_model_dict)
    got = painter.render_mesh_overlay(verts, faces, np.zeros((H, W, 3), np.uint8),
                                      FX, FY, CX, CY)
    want = j_painter.render_mesh_overlay(verts, faces,
                                         np.zeros((H, W, 3), np.uint8),
                                         FX, FY, CX, CY)
    np.testing.assert_array_equal(got, want)
