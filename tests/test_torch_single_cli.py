"""The port's single CLI (``smpltpu_torch.pipeline.single``) against the JAX
CLI, and the multi CLI's ``--linear pcg_block``, on the CPU.

Both CLIs run in float32, the JAX one with ``--mesh 1`` (its one-device
path; this suite has eight virtual JAX devices), on the small dataset of
``tests/test_pipeline.py``, here with its output-tail quirks in it: frame
2 has no keypoints, frame 4's image cannot be read and the last frame has
no image (the loop stops there). The single CLI's default fits have a free
scale, so the two packages' optima agree up to the gauge (s, t) -> (a s,
a t) of ``tests/test_torch_lm.py``; its log.csv evaluates the pose at
scale 1 (the reference's quirk), so the rows carry that gauge: measured,
costs within 3e-6 relative and rows within 4.4 % (0.10 px, the
multi-start path's frame 0; 0.2-0.6 % on the others). The costs are held
to 2e-5 relative, the rows to 10 %, the parameters with t divided by s to
0.05; the gauge-fixed ``--freeze-scale`` run's rows to 1e-3 px (measured
6e-5).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from smpltpu.pipeline import multi as j_multi
from smpltpu.pipeline import single as j_single
from smpltpu_torch.parallel import run_ranks
from smpltpu_torch.pipeline import multi as t_multi
from smpltpu_torch.pipeline import single as t_single
from tests.test_pipeline import N_FRAMES, _make_dataset
from tests.test_torch_cli import NUMERIC, _log
from tests.test_torch_single import _gauge_free

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = ["30"]
LOG_RTOL, COST_RTOL, PARAMS_ATOL, FROZEN_LOG_ATOL_PX = 0.1, 2e-5, 0.05, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The small dataset with a GMM prior beside the model, an unreadable
    image (frame 4) and no image for the last frame."""
    tmp = tmp_path_factory.mktemp("single_cli")
    model, kps, imgs = _make_dataset(tmp, np.random.default_rng(5),
                                     empty_frames=(2,), with_prior=True)
    with open(os.path.join(imgs, "frame_0004.png"), "wb") as f:
        f.write(b"not a png")
    os.remove(os.path.join(imgs, f"frame_{N_FRAMES - 1:04d}.png"))
    return model, kps, imgs


def _run_both(dataset, tmp_path, extra, jax_main=j_single.main,
              torch_main=t_single.main):
    outs = {}
    for tag, main in (("jax", jax_main),
                      ("torch", lambda a: torch_main(a, device="cpu"))):
        outs[tag] = str(tmp_path / tag)
        assert main(list(dataset) + [outs[tag]] + extra + ["--mesh", "1"]) == 0
    return outs["jax"], outs["torch"]


@pytest.mark.parametrize("extra", [
    [],
    ["--opt-shape", "5", "10"],
    ["--use-gmm", "5"],
    ["--multi-start"],
    ["--adaptive-start", "--adaptive-thresh", "0.5"],
    ["--freeze-scale"],
], ids=["plain", "opt_shape", "gmm", "multi_start", "adaptive", "frozen"])
def test_single_cli_matches_reference(dataset, tmp_path, capsys, extra):
    j_out, t_out = _run_both(dataset, tmp_path, ITERS + extra)
    err = capsys.readouterr().err
    (jf, je), (tf, te) = _log(j_out), _log(t_out)
    # frame 2: no keypoints; 4: unreadable image; 6: no image, the end
    np.testing.assert_array_equal(tf, [0, 1, 3, 5])
    np.testing.assert_array_equal(tf, jf)
    for said in ("Frame 2 has no valid keypoints", "Failed to read",
                 f"No image for frame {N_FRAMES - 1}"):
        assert err.count(said) == 2, said
    if "--freeze-scale" in extra:
        np.testing.assert_allclose(te, je, rtol=0, atol=FROZEN_LOG_ATOL_PX)
    else:
        np.testing.assert_allclose(te, je, rtol=LOG_RTOL)
    assert sorted(os.listdir(t_out)) == sorted(os.listdir(j_out))
    pj = np.load(os.path.join(j_out, "params_single.npz"))
    pt = np.load(os.path.join(t_out, "params_single.npz"))
    assert sorted(pt.files) == sorted(pj.files)
    for k in pj.files:
        assert pt[k].shape == pj[k].shape and pt[k].dtype == pj[k].dtype, k
    np.testing.assert_allclose(pt["cost"], pj["cost"], rtol=COST_RTOL)
    np.testing.assert_array_equal(pt["converged"], pj["converged"])
    np.testing.assert_allclose(_gauge_free(pt["params"]),
                               _gauge_free(pj["params"]), atol=PARAMS_ATOL)
    np.testing.assert_allclose(pt["shape"], pj["shape"], atol=PARAMS_ATOL)
    lj = open(os.path.join(j_out, "loss_curve.txt")).read().splitlines()
    lt = open(os.path.join(t_out, "loss_curve.txt")).read().splitlines()
    assert lt[0] == "iteration,loss" and len(lt) == len(lj) == 31
    curves = [[float(r.split(",")[1]) for r in rows[1:]] for rows in (lt, lj)]
    if {"--multi-start", "--adaptive-start"} & set(extra):
        # starts that reach one optimum tie in cost to ~1e-7 and rounding
        # picks either; their early histories differ, their ends do not
        curves = [c[-1:] for c in curves]
    np.testing.assert_allclose(*curves, rtol=1e-3)


@pytest.mark.parametrize("argv", [
    [],
    ["7", "--opt-shape", "3.5", "--use-gmm", "2", "9", "--pose-prior", "p.txt",
     "--jax-render", "--multi-start", "--adaptive-start", "--adaptive-thresh",
     "4.5", "--adaptive-propagate", "--profile", "--metrics-jsonl", "m.jsonl",
     "--no-orient-init", "--freeze-scale", "--mesh", "3", "--frame-chunk",
     "16.0", "--bogus"],
    ["--mesh", "-2", "--frame-chunk", "-1", "0", "--mesh"],
])
def test_parse_args_matches_reference(argv, capsys):
    full = ["m.npz", "kps", "imgs", "out"] + argv
    assert t_single.parse_args(full) == j_single.parse_args(full)
    assert t_single.parse_args(full[:3]) is None


@pytest.mark.parametrize("flags,ranks", [
    (["--mesh", "2"], 2),
    (["--adaptive-start", "--adaptive-propagate", "--mesh", "8"], 8),
])
def test_single_cli_refuses_flags_not_ported(dataset, tmp_path, capsys, flags,
                                             ranks):
    """The single CLI refuses nothing: --mesh N (M14, ported), with the
    adaptive path's --adaptive-propagate too, runs N ranks (here as
    threads; tests/test_torch_mesh_cli.py holds them to the JAX CLI),
    every frame's row written once, by rank 0."""
    out = str(tmp_path / "o")
    assert run_ranks(ranks, lambda mesh: t_single.main(
        list(dataset) + [out] + ITERS + flags, device="cpu",
        mesh=mesh)) == [0] * ranks
    assert f"devices visible: 1  mesh size: {ranks}" in capsys.readouterr().out
    np.testing.assert_array_equal(_log(out)[0], [0, 1, 3, 5])


def test_single_cli_warnings_usage_and_metrics(dataset, tmp_path, capsys):
    """--mesh 0 runs one rank on the CPU; --use-gmm without a prior falls
    back to L2 with a warning, and at beta_pose >= GMM_BETA_WARN warns of
    the objective; --metrics-jsonl and --profile write their files; too
    few arguments print the usage."""
    model, kps, imgs = dataset
    out = str(tmp_path / "a")
    assert t_single.main([model, kps, imgs, out, "2", "--use-gmm",
                          "--metrics-jsonl", out + ".jsonl", "--profile"],
                         device="cpu") == 0
    said = capsys.readouterr()
    assert "devices visible: 1  mesh size: 1\n" in said.out
    assert "Pose prior components: 8  (GMM ON)" in said.out
    assert f"beta_pose=20 >= {t_single.GMM_BETA_WARN:g}" in said.err
    assert open(out + ".jsonl").read().count('"single_solve"') == 1
    assert os.listdir(os.path.join(out, "profile")) == ["trace_0.json"]
    bare = tmp_path / "bare"
    shutil.copytree(os.path.dirname(model), bare,
                    ignore=shutil.ignore_patterns("pose_prior.txt"))
    assert t_single.main([str(bare / "model.npz"), kps, imgs,
                          str(tmp_path / "b"), "2", "--use-gmm"],
                         device="cpu") == 0
    assert "falling back to L2 pose prior" in capsys.readouterr().err
    assert t_single.main(["a", "b"], device="cpu") == 0
    assert capsys.readouterr().out == t_single.USAGE


def test_single_cli_needs_the_card_by_default(dataset, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert t_single.main(list(dataset) + [str(tmp_path / "o")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = subprocess.run(
        [sys.executable, "-m", "smpltpu_torch.pipeline.single"]
        + list(dataset) + [str(tmp_path / "o2")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 1 and "no CUDA device" in run.stderr
    assert not os.path.exists(tmp_path / "o2")


def test_multi_cli_pcg_block_matches_reference(tmp_path):
    """The multi CLI's --linear pcg_block (batched windows) against the JAX
    CLI's, at the tolerances of tests/test_torch_cli.py (measured: 3.5e-4
    px per row, 1.4e-6 in shape)."""
    ds = _make_dataset(tmp_path, np.random.default_rng(3), empty_frames=())
    j_out, t_out = _run_both(ds, tmp_path, NUMERIC + [
        "--linear", "pcg_block", "--batched-windows"],
        jax_main=j_multi.main, torch_main=t_multi.main)
    (jf, je), (tf, te) = _log(j_out), _log(t_out)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-2)
    pj = np.load(os.path.join(j_out, "params_multi.npz"))
    pt = np.load(os.path.join(t_out, "params_multi.npz"))
    np.testing.assert_allclose(pt["shape"], pj["shape"], atol=5e-2)
