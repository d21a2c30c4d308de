"""The port's library entry point (``smpltpu_torch.pipeline.api.fit_video``)
against the JAX package's, and the one-command video driver
(``smpltpu_torch.pipeline.video``), on the CPU.

``fit_video`` runs in float64 on the nine-frame video of
``tests/test_api.py``. The multi and stream modes freeze the scale and
solve with the exact tridiagonal step, so they follow the reference to the
tolerances of ``tests/test_torch_tridiag.py`` (1e-9 in cost, 1e-8 in the
parameters). The single mode leaves the scale free: its optima agree up to
the gauge (s, t) -> (a s, a t) (``tests/test_torch_single.py``) and to the
stopping rule's ftol, so its final costs are held to 5e-5 relative
(measured 1.7e-5 on two of the nine frames, which stop at 40 trips along
that direction) and the gauge-free parameters to 2e-3. Its errors are
not compared: the evaluation poses the frame at scale 1 (the reference's
quirk), so they move along the gauge (13 % here). The JAX results are read
from ``tests/data/api_jax_ref.npz``, which ``python -m tests.test_torch_api
--record`` writes by running the JAX ``fit_video`` on the same inputs (its
XLA compilation takes half a minute on the CPU). The video driver is held
to a direct call of the port's CLI.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smpltpu.models.synthetic import make_synthetic_model
from smpltpu.pipeline.api import fit_video as j_fit_video
from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu_torch.energy import make_skeleton_spec, project, skeleton_joints_cam
from smpltpu_torch.models import SMPLModel
from smpltpu_torch.pipeline import single as t_single
from smpltpu_torch.pipeline import stream as t_stream
from smpltpu_torch.pipeline import video as t_video
from smpltpu_torch.pipeline.api import fit_video
from smpltpu_torch.utils import default_intrinsics
from tests.test_torch_cli import _log
from tests.test_torch_single import _gauge_free
from tests.test_torch_stream_cli import H as DS_H
from tests.test_torch_stream_cli import W as DS_W
from tests.test_torch_stream_cli import make_dataset

F64 = torch.float64
W, H = 720, 1280
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "api_jax_ref.npz")
FIELDS = ("params", "shape", "errors_px", "verts", "converged",
          "cost_history")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def api_video(small_model_dict):
    return _api_video(small_model_dict)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


def _api_video(small_model_dict):
    """tests/test_api.py::api_video: nine frames of smooth motion (the
    poses of tests/test_multi_frame.py::_smooth_gt_video, rng 9),
    projected exactly."""
    model = SMPLModel.from_dict(small_model_dict, device="cpu", dtype=F64)
    cam = default_intrinsics(W, H, device="cpu", dtype=F64)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    rng = np.random.default_rng(9)
    f = 9
    base_aa = rng.normal(size=(23, 3)) * 0.15
    drift = rng.normal(size=(23, 3)) * 0.02
    gt = np.zeros((f, 76))
    gt[:, 0] = 1.0
    for i in range(f):
        gt[i, 1:4] = np.array([0.05, 0.02, 0.0]) * i * 0.1
        gt[i, 4:7] = [0.1 + 0.01 * i, -0.1, 3.2]
        gt[i, 7:] = (base_aa + i * drift).reshape(-1)
    uv = project(skeleton_joints_cam(torch.as_tensor(gt),
                                     torch.zeros(10, dtype=F64), spec),
                 cam).numpy()
    kp = np.zeros((f, N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL]
    kp[:, :, 3] = 1.0
    return kp


MODES = {
    "single": dict(beta_pose=1.0, beta_shape=0.0, max_iters=40),
    "multi": dict(beta_pose=1.0, max_iters=60, anchor_skip=3, window=4,
                  overlap=1, s2_iters=20, want_verts=True),
    "stream": dict(beta_pose=1.0, lambda_temporal=1.0, max_iters=40,
                   calib=3, want_verts=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fit_video_matches_reference(small_model_dict, api_video, golden,
                                     mode):
    """Each mode against the JAX fit_video's (recorded)."""
    kw = MODES[mode]
    want = {f: golden[f"{mode}_{f}"] for f in FIELDS
            if f"{mode}_{f}" in golden}
    got = fit_video(small_model_dict, api_video, W, H, mode=mode,
                    device="cpu", dtype=F64, **kw)
    assert got.params.shape == (9, 76) and got.errors_px.shape == (9,)
    np.testing.assert_array_equal(got.converged, want["converged"])
    assert got.cost_history.shape == want["cost_history"].shape
    assert got.shape.shape == want["shape"].shape
    if mode == "single":
        np.testing.assert_allclose(got.cost_history[:, -1],
                                   want["cost_history"][:, -1], rtol=5e-5)
        np.testing.assert_allclose(_gauge_free(got.params),
                                   _gauge_free(want["params"]), atol=2e-3)
        assert got.verts is None and "verts" not in want
        return
    np.testing.assert_allclose(got.cost_history, want["cost_history"],
                               rtol=1e-9)
    for f in ("params", "shape", "errors_px", "verts"):
        np.testing.assert_allclose(getattr(got, f), want[f], rtol=0,
                                   atol=1e-8)
    assert np.mean(got.errors_px) < 25.0
    if mode == "stream":
        assert got.converged[:3].all() and np.all(got.params[:, 0] > 0)


def test_fit_video_bad_mode(small_model_dict, api_video):
    with pytest.raises(ValueError, match="unknown mode"):
        fit_video(small_model_dict, api_video, W, H, mode="banana",
                  device="cpu")


@pytest.fixture(scope="module")
def json_folder(tmp_path_factory):
    """A keypoint-JSON folder (the small dataset, frame 2 empty) and no
    images: the driver synthesizes blank frames."""
    tmp = tmp_path_factory.mktemp("video")
    model, kps, _ = make_dataset(str(tmp), np.random.default_rng(4),
                                 empty_frames=(2,))
    return model, kps


@pytest.mark.parametrize("mode", ["stream", "single"])
def test_video_driver_matches_the_cli(json_folder, tmp_path, capsys, mode):
    """The driver on a keypoint-JSON folder with --no-video: blank frames
    of --size, the forwarded numerics and flags, a warning for each option
    the mode ignores; its fit/log.csv equals a direct call of the CLI."""
    model, kps = json_folder
    out = str(tmp_path / "drv")
    common = ["--size", f"{DS_W}x{DS_H}", "--no-video", "--iters", "10",
              "--beta-pose", "1.0", "--mesh", "1"]
    if mode == "stream":
        argv = common + ["--mode", "stream", "--lambda-t", "1.0",
                         "--calib", "2", "--s2-iters", "5",
                         "--beta-shape", "3", "--fused-stages"]
        direct = ["10", "1.0", "1.0", "--render", "--calib", "2"]
        cli = t_stream
        warned = ["--s2-iters does not apply to --mode stream",
                  "--beta-shape does not apply", "--mesh does not apply",
                  "--fused-stages does not apply"]
    else:
        argv = common + ["--mode", "single", "--lambda-t", "2.0",
                         "--calib", "2", "--fused-stages", "--freeze-scale"]
        direct = ["10", "1.0", "--freeze-scale", "--mesh", "1"]
        cli = t_single
        warned = ["--lambda-t applies to --mode multi only",
                  "--calib applies to --mode stream only",
                  "--fused-stages applies to --mode multi only"]
    assert t_video.main([model, kps, out] + argv, device="cpu") == 0
    said = capsys.readouterr()
    assert f"synthesizing blank {DS_W}x{DS_H} frames" in said.out
    for w in warned:
        assert w in said.err, (w, said.err)
    frames = os.path.join(out, "_frames")
    assert len(os.listdir(frames)) == len(os.listdir(kps))
    ref = str(tmp_path / "direct")
    assert cli.main([model, kps, frames, ref] + direct, device="cpu") == 0
    (vf, ve), (rf, re) = _log(os.path.join(out, "fit")), _log(ref)
    np.testing.assert_array_equal(vf, rf)
    np.testing.assert_array_equal(ve, re)
    assert 2 not in vf and len(vf) == 6


def test_video_driver_inputs_and_usage(json_folder, tmp_path, capsys):
    """Usage; a missing input; an image folder and a video file, whose
    MediaPipe extraction reports what it needs and exits 1 where mediapipe
    is absent (the card's machine has neither cv2 nor mediapipe)."""
    model, _ = json_folder
    assert t_video.main(["a", "b"], device="cpu") == 0
    assert capsys.readouterr().out == t_video.USAGE
    assert t_video.USAGE.startswith(
        "    python -m smpltpu_torch.pipeline.video <SMPL.npz>")
    assert t_video.main([model, str(tmp_path / "nope"), str(tmp_path / "o")],
                        device="cpu") == 1
    assert "input not found" in capsys.readouterr().err
    try:
        import mediapipe  # noqa: F401
        pytest.skip("mediapipe is installed: extraction would run")
    except ImportError:
        pass
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    (imgs / "a.png").write_bytes(b"")
    assert t_video.main([model, str(imgs), str(tmp_path / "o1")],
                        device="cpu") == 1
    assert "[ERROR] extraction failed" in capsys.readouterr().err
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"")
    assert t_video.main([model, str(clip), str(tmp_path / "o2")],
                        device="cpu") == 1
    assert "[ERROR] extraction failed" in capsys.readouterr().err


def record(path=GOLDEN):
    """Run the JAX fit_video in each mode on this file's inputs and write
    ``path``."""
    md = make_synthetic_model(n_verts=300, n_shapes=10, seed=0)
    kp = _api_video(md)
    out = {}
    for mode, kw in MODES.items():
        res = j_fit_video(md, kp, W, H, mode=mode, dtype=jnp.float64, **kw)
        out.update({f"{mode}_{f}": np.asarray(getattr(res, f))
                    for f in FIELDS if getattr(res, f) is not None})
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_api --record: rewrite the recorded JAX
    # results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_api --record")
    record()
