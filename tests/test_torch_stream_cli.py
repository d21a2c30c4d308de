"""The port's stream CLI (``smpltpu_torch.pipeline.stream``) against the JAX
CLI, and the single CLI's ``--adaptive-propagate``, on the CPU.

Both stream CLIs run in float32 on a dataset built as
``tests/test_pipeline.py::_make_dataset`` builds it (seven frames, frame 2
empty; projected here through the port, so no JAX op runs to make it), a
calibration buffer of two frames, the scale frozen as the stream's
default, the argv of ``tests/test_online.py::test_stream_cli``. The port's
three stream paths run the same functions on the CPU (the trip graph's
loop is ``lm_solve``'s), so their params are bitwise equal. They are held
to the JAX CLI's default path (its ``--scan`` and ``--pump`` are pinned to
it by tests/test_online.py): log.csv rows to 1e-3 px, params to 1e-2
(float32 rounding along the LM trips of the weakly observed joints;
measured 3.5e-3 in the params, 4e-5 px in the rows).

The JAX CLIs' results are read from ``tests/data/stream_cli_jax_ref.npz``,
which ``python -m tests.test_torch_stream_cli --record`` writes by running
them on the same files: their XLA compilation takes half a minute on the
CPU, which the suite's time limit has no room for.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from smpltpu.pipeline import single as j_single
from smpltpu.pipeline import stream as j_stream
from smpltpu_torch.constants import MP_MAP, init_root_rotation
from smpltpu_torch.energy import make_skeleton_spec, project, skeleton_joints_cam
from smpltpu_torch.io import save_pose_prior_txt, save_smpl_npz
from smpltpu_torch.models import SMPLModel
from smpltpu_torch.models.synthetic import make_synthetic_gmm, make_synthetic_model
from smpltpu_torch.pipeline import single as t_single
from smpltpu_torch.pipeline import stream as t_stream
from smpltpu_torch.utils import default_intrinsics
from smpltpu_torch.utils.image import imwrite
from tests.test_torch_cli import _log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "stream_cli_jax_ref.npz")
ARGV = ["12", "1.0", "1.0", "--calib", "2"]
ADAPTIVE_ARGV = ["30", "--adaptive-start", "--adaptive-thresh", "0.05",
                 "--adaptive-propagate", "--freeze-scale", "--mesh", "1"]
LOG_ATOL_PX, PARAMS_ATOL = 1e-3, 1e-2
W, H, N_FRAMES = 128, 160, 7        # tests/test_pipeline.py


def make_dataset(root, rng, empty_frames=(2,), with_prior=False):
    """tests/test_pipeline.py::_make_dataset with the port's projection:
    the 200-vertex model, MediaPipe-style JSONs of projected joints, gray
    PNGs. -> (model path, keypoint dir, image dir)."""
    model_dict = make_synthetic_model(n_verts=200, seed=0)
    model_path = os.path.join(root, "model.npz")
    save_smpl_npz(model_path, model_dict)
    if with_prior:
        gmm = make_synthetic_gmm(seed=0)
        save_pose_prior_txt(os.path.join(root, "pose_prior.txt"),
                            gmm["weights"], gmm["means"], gmm["covs"])
    f64 = torch.float64
    model = SMPLModel.from_dict(model_dict, device="cpu", dtype=f64)
    cam = default_intrinsics(W, H, device="cpu", dtype=f64)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=False)
    kp_dir, img_dir = os.path.join(root, "kps"), os.path.join(root, "imgs")
    os.makedirs(kp_dir)
    os.makedirs(img_dir)
    base_aa = rng.normal(size=(23, 3)) * 0.1
    for f in range(N_FRAMES):
        imwrite(os.path.join(img_dir, f"frame_{f:04d}.png"),
                np.full((H, W, 3), 30, np.uint8))
        path = os.path.join(kp_dir, f"frame_{f:04d}.json")
        if f in empty_frames:
            with open(path, "w") as fh:
                fh.write("[]")
            continue
        vec = np.concatenate([[1.0], rng.normal(size=3) * 0.05,
                              [0.0, 0.0, 3.2], (base_aa + 0.01 * f).ravel()])
        uv = project(skeleton_joints_cam(torch.as_tensor(vec),
                                         torch.zeros(10, dtype=f64), spec),
                     cam).numpy()
        lms = [{"x": 0.0, "y": 0.0, "z": 0.0, "visibility": 0.0}
               for _ in range(33)]
        for sid in range(24):
            mp = int(MP_MAP[sid])
            if mp >= 0:
                lms[mp] = {"x": float(uv[sid, 0]) / W,
                           "y": float(uv[sid, 1]) / H, "z": 0.0,
                           "visibility": 0.95}
        for mp_id, jid in ((23, 1), (24, 2)):
            lms[mp_id] = {"x": float(uv[jid, 0]) / W,
                          "y": float(uv[jid, 1]) / H, "z": 0.0,
                          "visibility": 0.95}
        with open(path, "w") as fh:
            json.dump(lms, fh)
    return model_path, kp_dir, img_dir


def _dataset(root):
    return make_dataset(root, np.random.default_rng(5), empty_frames=(2,),
                        with_prior=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _dataset(str(tmp_path_factory.mktemp("stream_cli")))


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


@pytest.fixture(scope="module")
def port_runs(dataset, tmp_path_factory):
    """The port's CLI on each stream path: {path: out_dir}."""
    root = tmp_path_factory.mktemp("stream_port")
    outs = {}
    for name, extra in (("step", []), ("scan", ["--scan"]),
                        ("pump", ["--pump"])):
        outs[name] = str(root / name)
        assert t_stream.main(list(dataset) + [outs[name]] + ARGV + extra,
                             device="cpu") == 0
    return outs


@pytest.mark.parametrize("path", ["step", "scan", "pump"])
def test_stream_cli_matches_reference(port_runs, golden, path):
    t_out = port_runs[path]
    tf, te = _log(t_out)
    np.testing.assert_array_equal(tf, golden["stream_frames"])
    assert 2 not in tf and len(tf) == 6
    np.testing.assert_allclose(te, golden["stream_errs"], rtol=0,
                               atol=LOG_ATOL_PX)
    pt = np.load(os.path.join(t_out, "params_stream.npz"))
    assert sorted(pt.files) == ["calib_frames", "emitted", "params", "shape"]
    for k in ("emitted", "calib_frames"):
        np.testing.assert_array_equal(pt[k], golden[f"stream_{k}"])
    for k in ("params", "shape"):
        np.testing.assert_allclose(pt[k], golden[f"stream_{k}"], rtol=0,
                                   atol=PARAMS_ATOL)
    # the held frame keeps the previous pose, bit for bit
    np.testing.assert_array_equal(pt["params"][2], pt["params"][1])
    # the three paths of the port: the same solves
    ps = np.load(os.path.join(port_runs["step"], "params_stream.npz"))
    np.testing.assert_array_equal(pt["params"], ps["params"])
    np.testing.assert_array_equal(te, _log(port_runs["step"])[1])


def test_stream_cli_render_and_warnings(dataset, tmp_path, capsys):
    """--render writes a png per emitted frame with an image (host
    painter), --warm-timing runs the scan twice with the same result,
    --use-gmm without a prior falls back with a warning, and the latency
    line is printed."""
    model, kps, imgs = dataset
    out = str(tmp_path / "r")
    assert t_stream.main([model, kps, imgs, out] + ARGV + [
        "--render", "--scan", "--warm-timing", "--bogus"], device="cpu") == 0
    said = capsys.readouterr()
    assert "[WARN] Unknown arg ignored: --bogus" in said.err
    assert "Frame 2 has no valid keypoints; skipping." in said.err
    assert "latency mean" in said.out and "warm solve" in said.out
    pngs = sorted(n for n in os.listdir(out) if n.endswith("_stream.png"))
    assert pngs == [f"frame_{i}_stream.png" for i in (0, 1, 3, 4, 5, 6)]
    bare = tmp_path / "bare"
    bare.mkdir()
    os.symlink(model, bare / "model.npz")
    assert t_stream.main([str(bare / "model.npz"), kps, imgs,
                          str(tmp_path / "g")] + ARGV + ["--use-gmm"],
                         device="cpu") == 0
    assert "falling back to L2 pose prior" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    [],
    ["30", "--calib", "5", "2.5", "--free-scale", "0.5", "--render"],
    ["--jax-render", "--use-gmm", "--pose-prior", "p.txt", "--scan",
     "--pump", "--warm-timing", "--calib", "-3", "7", "8", "9", "10",
     "--bogus", "--calib"],
])
def test_parse_args_and_usage_match_reference(argv, capsys):
    full = ["m.npz", "kps", "imgs", "out"] + argv
    assert t_stream.parse_args(full) == j_stream.parse_args(full)
    assert t_stream.parse_args(full[:3]) is None
    assert t_stream.main(["a"], device="cpu") == 0
    assert capsys.readouterr().out == t_stream.USAGE == j_stream.USAGE.replace(
        "smpltpu.pipeline.stream", "smpltpu_torch.pipeline.stream")


def test_stream_cli_needs_the_card_by_default(dataset, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert t_stream.main(list(dataset) + [str(tmp_path / "o")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = subprocess.run(
        [sys.executable, "-m", "smpltpu_torch.pipeline.stream"]
        + list(dataset) + [str(tmp_path / "o2")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 1 and "no CUDA device" in run.stderr
    assert not os.path.exists(tmp_path / "o2")


def test_single_cli_adaptive_propagate_matches_reference(dataset, golden,
                                                        tmp_path):
    """The single CLI's --adaptive-start --adaptive-propagate, gauge-fixed,
    against the JAX CLI (``--mesh 1``, recorded), at a threshold low enough
    that phase P runs on this data."""
    out = str(tmp_path / "torch")
    assert t_single.main(list(dataset) + [out] + ADAPTIVE_ARGV,
                         device="cpu") == 0
    tf, te = _log(out)
    np.testing.assert_array_equal(tf, golden["adaptive_frames"])
    np.testing.assert_allclose(te, golden["adaptive_errs"], rtol=0,
                               atol=LOG_ATOL_PX)
    pt = np.load(os.path.join(out, "params_single.npz"))
    np.testing.assert_allclose(pt["params"], golden["adaptive_params"],
                               rtol=0, atol=PARAMS_ATOL)
    np.testing.assert_array_equal(pt["converged"], golden["adaptive_converged"])


def record(path=GOLDEN):
    """Run the JAX stream CLI (default path) and the JAX single CLI
    (``ADAPTIVE_ARGV``) on this file's dataset and write ``path``."""
    with tempfile.TemporaryDirectory() as root:
        ds = _dataset(root)
        out = {}
        for tag, main, argv, npz in (
                ("stream", j_stream.main, ARGV, "params_stream.npz"),
                ("adaptive", j_single.main, ADAPTIVE_ARGV,
                 "params_single.npz")):
            run = os.path.join(root, tag)
            assert main(list(ds) + [run] + argv) == 0
            out[f"{tag}_frames"], out[f"{tag}_errs"] = _log(run)
            with np.load(os.path.join(run, npz)) as p:
                out.update({f"{tag}_{k}": p[k] for k in p.files})
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_stream_cli --record: rewrite the recorded
    # JAX CLI results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_stream_cli --record")
    record()
