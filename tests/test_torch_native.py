"""The port's host runtime (``smpltpu_torch/native``, its own copy of the C++
source under ``smpltpu_torch/csrc/host``) on the CPU: the parser bit for
bit against the port's Python parser and the JAX package's native parser
(the reference's fixtures and edge cases, tests/test_native.py:24-61), the
fill pixel for pixel against the numpy fill, the keypoint loader's
backends, a failed build, and two processes building at once."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import smpltpu_torch.native as native
from smpltpu_torch.io import load_keypoint_dir
from smpltpu_torch.io.keypoints import keypoints_to_dense, load_mp_json
from smpltpu_torch.render import raster as painter
from tests.conftest import fixture_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO1 = fixture_path("data/keypoints/video1")
EDGE_CASES = [
    "[]", "{}", "{not json", "[{\"x\": \"oops\"}]",
    json.dumps([{"x": 0.5, "y": 0.5, "visibility": True}] * 33),
    json.dumps([{"x": 0.5, "y": 0.5}] * 12),          # short list
    json.dumps([{"x": 0.5, "y": 0.5}] * 33),          # missing visibility
    json.dumps([{"x": 0.5, "y": 0.5, "visibility": 0.4}] * 33),  # low vis
    json.dumps([{"x": 0.5, "y": 0.5, "extra": {"a": [1, "s", None]}}] * 33),
]


def _py_dense(path, w, h, mdv=1.0):
    return keypoints_to_dense(load_mp_json(path, w, h, mdv))


def _jax_native():
    from smpltpu import native as j_native
    if not j_native.available():
        pytest.skip("the JAX package's native library does not build here")
    return j_native


def test_parser_matches_python_and_jax_native_full(tmp_path):
    rng = np.random.default_rng(0)
    lms = [{"x": float(rng.random()), "y": float(rng.random()),
            "z": 0.0, "visibility": float(rng.random())} for _ in range(33)]
    path = str(tmp_path / "f.json")
    with open(path, "w") as f:
        json.dump(lms, f)
    data = open(path, "rb").read()
    got = native.parse_mp_json_bytes(data, 640, 480)
    np.testing.assert_array_equal(got, _py_dense(path, 640, 480))
    np.testing.assert_array_equal(
        got, _jax_native().parse_mp_json_bytes(data, 640, 480))


@pytest.mark.parametrize("content", EDGE_CASES)
def test_parser_matches_python_and_jax_native_edge_cases(tmp_path, content):
    path = str(tmp_path / "e.json")
    with open(path, "w") as f:
        f.write(content)
    data = open(path, "rb").read()
    for mdv in (1.0, 0.0):
        got = native.parse_mp_json_bytes(data, 100, 100, mdv)
        np.testing.assert_array_equal(got, _py_dense(path, 100, 100, mdv),
                                      err_msg=f"content={content!r} mdv={mdv}")
        np.testing.assert_array_equal(
            got, _jax_native().parse_mp_json_bytes(data, 100, 100, mdv))


def test_batch_loader_backends_match_on_fixture():
    """video1 through every backend of the port's loader and through the
    JAX package's native and Python loaders: one batch, bit for bit."""
    from smpltpu.io import load_keypoint_dir as j_load

    batches = {b: load_keypoint_dir(VIDEO1, 720, 1280, backend=b)
               for b in ("python", "native", "auto")}
    want, paths = batches["python"]
    assert len(paths) == 38
    for b, (got, got_paths) in batches.items():
        assert got_paths == paths
        np.testing.assert_array_equal(got, want, err_msg=b)
    for b in ("native", "python"):
        np.testing.assert_array_equal(
            j_load(VIDEO1, 720, 1280, backend=b)[0], want, err_msg=b)
    with pytest.raises(ValueError, match="backend"):
        load_keypoint_dir(VIDEO1, 720, 1280, backend="rust")


def test_batch_loader_many_files_and_empty_dir(tmp_path):
    """200 files (the thread pool's work queue), one unreadable as JSON,
    and an empty directory."""
    rng = np.random.default_rng(1)
    for i in range(200):
        lms = [{"x": float(rng.random()), "y": float(rng.random()),
                "visibility": float(rng.random())} for _ in range(33)]
        (tmp_path / f"f_{i:04d}.json").write_text(
            "{broken" if i == 17 else json.dumps(lms))
    got, paths = load_keypoint_dir(str(tmp_path), 640, 480, backend="native")
    want, _ = load_keypoint_dir(str(tmp_path), 640, 480, backend="python")
    assert got.shape == (200, 17, 4)
    np.testing.assert_array_equal(got, want)
    empty = tmp_path / "empty"
    empty.mkdir()
    got, paths = load_keypoint_dir(str(empty), 640, 480, backend="native")
    assert got.shape == (0, 17, 4) and paths == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_triangles_matches_numpy(seed):
    """Random triangles, partly off screen, degenerate, overlapping in draw
    order: the C++ fill sets the numpy fill's pixels."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(20, 160, 2))
    n = int(rng.integers(1, 200))
    tris = (rng.uniform(-20, max(h, w) + 20, size=(n, 1, 2))
            + rng.normal(size=(n, 3, 2)) * rng.choice([1.0, 8.0, 60.0],
                                                      size=(n, 1, 1)))
    tris[0] = [[10.5, 10.5], [10.5, 10.5], [10.5, 10.5]]
    gray = rng.integers(0, 256, size=n).astype(np.int32)
    got = np.zeros((h, w, 3), np.uint8)
    want = got.copy()
    native.fill_triangles(got, tris, gray)
    painter._fill_triangles_numpy(
        want, tris, np.stack([gray] * 3, axis=-1).astype(np.uint8))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()
    with pytest.raises(ValueError, match="uint8"):
        native.fill_triangles(got.astype(np.float32), tris, gray)
    with pytest.raises(ValueError, match="gray levels"):
        native.fill_triangles(got, tris, gray[:-1])


def test_overlay_without_cv2_fills_natively(small_model_dict, monkeypatch):
    """A full mesh's drawlist: with cv2 switched off the overlay goes
    through the C++ fill, pixel for pixel the numpy fill's frame."""
    import torch

    from smpltpu_torch.models import SMPLModel, rodrigues, smpl_forward

    f64 = torch.float64
    model = SMPLModel.from_dict(small_model_dict, device="cpu", dtype=f64)
    rng = np.random.default_rng(3)
    rot = rodrigues(torch.as_tensor(0.2 * rng.normal(size=(24, 3))))
    verts = smpl_forward(model, torch.zeros(10, dtype=f64), rot,
                         torch.tensor([0.0, 0.0, 3.0], dtype=f64))["verts"].numpy()
    faces = np.asarray(model.faces)
    args = (240.0, 240.0, 90.0, 120.0)
    monkeypatch.setattr(painter, "_HAS_CV2", False)
    calls = []
    real = native.fill_triangles
    monkeypatch.setattr(native, "fill_triangles",
                        lambda *a: calls.append(1) or real(*a))
    got = painter.render_mesh_overlay(verts, faces,
                                      np.zeros((240, 180, 3), np.uint8), *args)
    tris, shade = painter.build_drawlist(verts, faces, *args)
    gray = np.round(220.0 * shade).astype(np.int32)
    want = np.zeros((240, 180, 3), np.uint8)
    painter._fill_triangles_numpy(
        want, tris, np.stack([gray] * 3, axis=-1).astype(np.uint8))
    assert calls == [1]
    np.testing.assert_array_equal(got, want)
    assert int(got.any(axis=-1).sum()) > 500


def _broken(monkeypatch, tmp_path, compiler):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "CXX", compiler)


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_failed_build_raises(monkeypatch, tmp_path, compiler):
    """A compiler that is missing or fails: ``backend="native"`` and
    ``"auto"`` raise with the compiler's story and name the Python
    parser; ``available()`` says False; ``"python"`` still parses; the
    overlay without cv2 raises rather than filling some other way."""
    _broken(monkeypatch, tmp_path, compiler)
    for backend in ("native", "auto"):
        with pytest.raises(native.NativeBuildError, match="backend='python'"):
            load_keypoint_dir(VIDEO1, 720, 1280, backend=backend)
    assert not native.available()
    assert load_keypoint_dir(VIDEO1, 720, 1280, backend="python")[0].shape \
        == (38, 17, 4)
    monkeypatch.setattr(painter, "_HAS_CV2", False)
    with pytest.raises(RuntimeError, match="cv2"):
        painter.render_mesh_overlay(np.array([[0.0, 0, 1], [0, 1, 1], [1, 0, 1]]),
                                    np.array([[0, 1, 2]]),
                                    np.zeros((8, 8, 3), np.uint8),
                                    4.0, 4.0, 4.0, 4.0)
    assert not list((tmp_path / "host").glob("*.tmp"))


def test_two_processes_build_at_once(tmp_path):
    """Two interpreters build the library into one empty directory at the
    same moment: both load a whole library and parse, and no temporary
    file is left."""
    code = ("import sys; from pathlib import Path\n"
            "import smpltpu_torch.native as n\n"
            "n.BUILD_DIR = Path(sys.argv[1])\n"
            "b = n.parse_mp_json_bytes(b'[]', 10, 10)\n"
            "print(n.build_info['built'], b.shape)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip().endswith("(17, 4)")
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))
    assert native.library_path().name == next(tmp_path.glob("*.so")).name
