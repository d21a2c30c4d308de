"""Both CLIs' ``--mesh 2`` on the CPU against the JAX CLIs with the same
argv (two of the JAX package's eight virtual devices).

The multi CLI takes the sharded route: stage 1 is the frame-sharded LM on
the anchors (padded to a multiple of 2), stage 2 window data parallelism
(batched windows, padded with an all-invalid window) or rank 0's
sequential windows; the single CLI shards its frame batch, the adaptive
path every call. The port's ranks run as two threads over gloo here
(``run_ranks``), and once through the CLIs' own launcher, a process a
rank, which must give the same files.

The dataset is ``tests/test_torch_stream_cli.py``'s (seven frames of the
200-vertex model, frame 2 empty). The JAX CLIs' log.csv rows and params
are read from ``tests/data/mesh_cli_jax_ref.npz``, which ``python -m
tests.test_torch_mesh_cli --record`` writes. Tolerances are those of the
one-device CLI tests: the multi CLI's rows 1e-2 px and shape 5e-2
(``tests/test_torch_cli.py``), the gauge-fixed single CLI's rows 1e-3 px
(``tests/test_torch_single_cli.py``), the free-scale single CLI's rows 10
% (the gauge, ROADMAP Queue 3) and its costs 2e-5.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from smpltpu_torch.parallel import run_ranks
from smpltpu_torch.pipeline import multi as t_multi
from smpltpu_torch.pipeline import single as t_single
from tests.test_torch_cli import _log
from tests.test_torch_stream_cli import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "mesh_cli_jax_ref.npz")
MULTI_NUMERIC = ["10", "30", "3", "4", "1", "2.0", "25.0", "1.0",
                 "--s2-iters", "20", "--mesh", "2"]
RUNS = {
    "multi_batched": ("multi", MULTI_NUMERIC + ["--batched-windows"]),
    "multi_sequential": ("multi", MULTI_NUMERIC),
    "multi_chunked_pcg": ("multi", MULTI_NUMERIC + [
        "--batched-windows", "--window-chunk", "1", "--linear", "pcg"]),
    "single": ("single", ["30", "--mesh", "2"]),
    "single_adaptive": ("single", ["30", "--adaptive-start",
                                   "--adaptive-thresh", "0.05",
                                   "--adaptive-propagate", "--freeze-scale",
                                   "--mesh", "2"]),
}
MULTI_LOG_ATOL_PX, MULTI_SHAPE_ATOL = 1e-2, 5e-2
FROZEN_LOG_ATOL_PX, SINGLE_LOG_RTOL, SINGLE_COST_RTOL = 1e-3, 0.1, 2e-5
NPZ = {"multi": "params_multi.npz", "single": "params_single.npz"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(root):
    return make_dataset(root, np.random.default_rng(5), empty_frames=(2,),
                        with_prior=True)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _dataset(str(tmp_path_factory.mktemp("mesh_cli")))


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


def _main(cli):
    return {"multi": t_multi, "single": t_single}[cli].main


def run_threads(cli, argv):
    """The CLI's two ranks as threads: each rank's exit code."""
    return run_ranks(2, lambda mesh: _main(cli)(argv, device="cpu",
                                                mesh=mesh))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_mesh_cli_matches_reference(dataset, golden, tmp_path, capsys, name):
    cli, argv = RUNS[name]
    out = str(tmp_path / name)
    assert run_threads(cli, list(dataset) + [out] + argv) == [0, 0]
    said = capsys.readouterr()
    assert "devices visible: 1  mesh size: 2" in said.out
    frames, errs = _log(out)
    np.testing.assert_array_equal(frames, golden[f"{name}_frames"])
    with np.load(os.path.join(out, NPZ[cli])) as p:
        got = dict(p)
    if cli == "multi":
        assert ("sharded stage-1 uses the distributed PCG" in said.err) == (
            "--linear" not in argv)
        np.testing.assert_allclose(errs, golden[f"{name}_errs"], rtol=0,
                                   atol=MULTI_LOG_ATOL_PX)
        np.testing.assert_allclose(got["shape"], golden[f"{name}_shape"],
                                   atol=MULTI_SHAPE_ATOL)
        assert os.path.isfile(os.path.join(out, "loss_curve.txt"))
    elif "--freeze-scale" in argv:
        np.testing.assert_allclose(errs, golden[f"{name}_errs"], rtol=0,
                                   atol=FROZEN_LOG_ATOL_PX)
    else:
        np.testing.assert_allclose(errs, golden[f"{name}_errs"],
                                   rtol=SINGLE_LOG_RTOL)
        np.testing.assert_allclose(got["cost"], golden[f"{name}_cost"],
                                   rtol=SINGLE_COST_RTOL)
    assert not [f for f in os.listdir(out) if f.startswith(".mesh")]


def test_mesh_cli_process_launcher(dataset, tmp_path):
    """``main`` with ``--mesh 2`` on the CPU starts a process a rank
    (``parallel/launch.py``): the same files as the two threads."""
    cli, argv = RUNS["single"]
    outs = {k: str(tmp_path / k) for k in ("threads", "processes")}
    assert run_threads(cli, list(dataset) + [outs["threads"]] + argv) == [0, 0]
    assert t_single.main(list(dataset) + [outs["processes"]] + argv,
                         device="cpu") == 0
    assert sorted(os.listdir(outs["processes"])) == sorted(
        os.listdir(outs["threads"]))
    (ft, et), (fp, ep) = _log(outs["threads"]), _log(outs["processes"])
    np.testing.assert_array_equal(fp, ft)
    np.testing.assert_array_equal(ep, et)      # time_ms may differ
    curves = [open(os.path.join(o, "loss_curve.txt")).read()
              for o in outs.values()]
    assert curves[0] == curves[1]
    with np.load(os.path.join(outs["threads"], "params_single.npz")) as a, \
            np.load(os.path.join(outs["processes"], "params_single.npz")) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def record(path=GOLDEN):
    """Run the JAX CLIs with ``RUNS``' argvs on this file's dataset and
    write ``path``."""
    from smpltpu.pipeline import multi as j_multi
    from smpltpu.pipeline import single as j_single

    out = {}
    with tempfile.TemporaryDirectory() as root:
        ds = _dataset(root)
        for name, (cli, argv) in RUNS.items():
            run = os.path.join(root, name)
            main = j_multi.main if cli == "multi" else j_single.main
            assert main(list(ds) + [run] + argv) == 0
            out[f"{name}_frames"], out[f"{name}_errs"] = _log(run)
            with np.load(os.path.join(run, NPZ[cli])) as p:
                out.update({f"{name}_{k}": p[k] for k in p.files})
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_mesh_cli --record: rewrite the recorded JAX
    # CLI results (under the test session's JAX settings: x64, CPU, eight
    # virtual devices)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_mesh_cli --record")
    record()
