"""The port's entry twin (``smpltpu_torch/graft_entry.py``) and roofline
(``smpltpu_torch/utils/roofline.py``) against the JAX package's
``__graft_entry__.py`` and ``smpltpu/utils/roofline.py``, on the CPU.

``entry(device="cpu")`` runs the production window solve (K1's plain
version here) and skins the first fitted frame of each window (K2's).
Its example inputs equal the JAX entry's, and its outputs are held to
the JAX entry's, both read from ``tests/data/graft_entry_jax_ref.npz``
(``python -m tests.test_torch_graft_entry --record`` writes it). Both
solve in float32 with 16 truncated CG steps a trip on the entry's
unfittable keypoints, where summation order moves accept/reject decisions
(ROADMAP Queue 3). Measured with one torch thread, windows 2 and 3 follow
the JAX trajectory (cost 7.0e-6 and 3.4e-7 apart relatively, params
6.5e-4 and 2.9e-3), windows 0 and 1 drift (cost 8.5e-4 and 2.2e-2,
params 0.046 and 0.77): each window is held to about three times its own
reading (``ENTRY_LIMITS``). The same function on fittable keypoints
(projected from a known pose plus 1 px noise, ``fittable_kp``; recorded
beside the entry's outputs) follows the JAX trajectory in every window:
cost within 4.0e-5 relatively, params 6.0e-5, vertices 1.7e-6, held to
about three times that (``FIT_*``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import smpltpu.utils.roofline as j_roofline
import smpltpu_torch.utils.roofline as roofline
from smpltpu_torch import graft_entry
from smpltpu_torch.constants import init_root_rotation
from smpltpu_torch.models import SMPLModel, make_synthetic_model, smpl_forward
from smpltpu_torch.utils.writeback import params_to_pose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "graft_entry_jax_ref.npz")
# per window: (cost rtol, params atol), from the readings above
ENTRY_LIMITS = ((3e-3, 0.15), (7e-2, 2.5), (2e-5, 2e-3), (1e-6, 1e-2))
# the fittable case, every window: measured 4.0e-5, 6.0e-5 and 1.7e-6 at most
FIT_COST_RTOL, FIT_PARAMS_ATOL, FIT_VERTS_ATOL = 1.5e-4, 2e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def entry_run():
    fn, args = graft_entry.entry(device="cpu")
    return [a.numpy() for a in args], [o.numpy() for o in fn(*args)]


@pytest.fixture(scope="module")
def entry_out(entry_run):
    return entry_run[1]


def test_entry_matches_reference(entry_run):
    args, (params, cost, shape, verts) = entry_run
    assert params.shape == (4, 6, 76) and cost.shape == (4,)
    assert shape.shape == (4, 10) and verts.shape == (4, 1024, 3)
    assert all(np.isfinite(o).all() for o in (params, cost, shape, verts))
    with np.load(GOLDEN) as g:
        for i, a in enumerate(args):
            np.testing.assert_array_equal(a, g[f"arg{i}"])
        for i, (cost_rtol, params_atol) in enumerate(ENTRY_LIMITS):
            np.testing.assert_allclose(cost[i], g["cost"][i], rtol=cost_rtol)
            np.testing.assert_allclose(params[i], g["params"][i], rtol=0,
                                       atol=params_atol)
        assert float(np.abs(params - g["arg0"]).max()) > 0.1   # it fits


def fittable_kp(params0):
    """Keypoints the entry's model can explain: each frame's joints at a
    pose 0.1 rad (per joint axis) from the start, projected through the
    entry's camera, plus 1 px of noise; from seed 1. (4, 6, K, 4) float32."""
    from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL
    from smpltpu_torch.energy import make_skeleton_spec, project, skeleton_joints_cam
    from smpltpu_torch.utils import default_intrinsics

    p0 = np.asarray(params0, np.float32)
    n_win, wsize, p_dim = p0.shape
    rng = np.random.default_rng(1)
    gt = p0.reshape(-1, p_dim).copy()
    gt[:, 7:] += 0.1 * rng.normal(size=(len(gt), p_dim - 7))
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=1024),
                                device="cpu", dtype=torch.float32)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    cam = default_intrinsics(480, 270, device="cpu", dtype=torch.float32)
    uv = project(skeleton_joints_cam(torch.as_tensor(gt),
                                     torch.zeros(len(gt), model.num_shapes),
                                     spec), cam).numpy()
    kp = np.zeros((len(gt), N_KP_SLOTS, 4), np.float32)
    kp[..., 0] = USE_SMPL
    kp[..., 1:3] = uv[:, USE_SMPL] + rng.normal(size=(len(gt), N_KP_SLOTS, 2))
    kp[..., 3] = 1.0
    return kp.reshape(n_win, wsize, N_KP_SLOTS, 4)


def test_entry_on_fittable_keypoints_matches_reference():
    """The entry's function on keypoints a pose explains, against the JAX
    entry's function on the same keypoints: every window follows the
    JAX trajectory."""
    fn, args = graft_entry.entry(device="cpu")
    with np.load(GOLDEN) as g:
        kp = g["fit_kp"]
        params, cost, _, verts = (o.numpy() for o in fn(
            args[0], args[1], torch.as_tensor(kp), *args[3:]))
        np.testing.assert_allclose(cost, g["fit_cost"], rtol=FIT_COST_RTOL)
        np.testing.assert_allclose(params, g["fit_params"], rtol=0,
                                   atol=FIT_PARAMS_ATOL)
        np.testing.assert_allclose(verts, g["fit_verts"], rtol=0,
                                   atol=FIT_VERTS_ATOL)
        assert float(np.abs(params - g["arg0"]).max()) > 0.05   # it fits


def test_entry_verts_use_the_production_pose_decode(entry_out):
    """The skinned vertices are the production decode of the first fitted
    frame (root = R(aa) @ R0) through K2's plain version, equal to the
    einsum ``smpl_forward``; the fitted root axis-angle matters."""
    params, _, shape, verts = entry_out
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=1024),
                                device="cpu", dtype=torch.float32)
    r0 = torch.as_tensor(np.asarray(init_root_rotation(), np.float32))

    def reskin(p, w):
        pose = params_to_pose(torch.as_tensor(p), r0, model.num_joints)
        return smpl_forward(model, torch.as_tensor(w), pose.rotations,
                            pose.root_pos)["verts"].numpy()
    ref = np.stack([reskin(params[i, 0], shape[i]) for i in range(4)])
    np.testing.assert_allclose(verts, ref, rtol=1e-5, atol=1e-5)
    no_root = params[0, 0].copy()
    no_root[1:4] = 0.0
    assert not np.allclose(reskin(no_root, shape[0]), ref[0], atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(n, capsys):
    out = graft_entry.dryrun_multichip(n)
    assert f"dryrun_multichip OK: {n} ranks on cpu" in capsys.readouterr().out
    assert all(np.isfinite(out[k]) for k in ("lm_cost", "cg_residual",
                                             "window_dp_cost",
                                             "frame_dp_cost"))
    if n > 1:
        assert out["collectives"]["send"] > 0
        assert out["collectives"]["all_reduce"] > 0


STAGES = [
    ("stage_solver", ("s2", 67, 20, 76, 10, 34, 60, 40)),
    ("stage_solver", ("s1", 1, 100, 76, 10, 34, 150.0, 40, "pcg_kernel")),
    ("stage_solver", ("s1t", 1, 100, 76, 10, 34, 150, 40, "tridiag")),
    ("stage_single_frame", ("sf", 128, 76, 34, 38.0)),
    ("stage_single_frame", ("sfc", 128, 86, 34, 20, "chol")),
    ("stage_single_frame", ("sfd", 7, 76, 34, 3, "dogleg")),
    ("stage_lbs", ("lbs", 100, 6890)),
    ("stage_lbs", ("lbs7", 37, 300, 24, 7)),
    ("stage_raster", ("r", 100, 13776, 360, 8, 128, 1024)),
    ("stage_raster", ("r2", 1, 13776, 360, 8, 64, 1024, 3, 40)),
]


@pytest.mark.parametrize("name,args", STAGES)
def test_roofline_counts_match_reference(name, args):
    """The same operations, bytes and sequential steps as the reference's
    formulas on the same shapes: the work does not depend on the chip."""
    got, want = getattr(roofline, name)(*args), getattr(j_roofline, name)(*args)
    assert tuple(got) == tuple(want)


def test_roofline_peaks_and_report():
    """The H100's peaks (the only difference from the reference), read by
    chip_smoke.py's bound; the report's verdicts."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert (roofline.PEAK_F32_FLOPS, roofline.PEAK_HBM_BPS) == (67e12, 3.35e12)
    assert chip_smoke.bound(3.35e12, 0.0) == (1000.0, "bytes")
    assert chip_smoke.bound(0.0, 67e12) == (1000.0, "operations")
    stage = roofline.StageCount("x", 67e12, 3.35e11, 10)
    assert roofline.report(stage, 1.0).endswith("-> FP32 compute")
    assert "100.00% FP32" in roofline.report(stage, 1.0)
    assert roofline.report(stage, 1.0, dispatches=10 ** 6).endswith(
        "host-dispatch latency")
    assert roofline.report(roofline.StageCount("y", 1e9, 3e12, 1), 1.0
                           ).endswith("HBM bandwidth")


def record(path=GOLDEN):
    """The JAX entry's outputs (``__graft_entry__.entry``)."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, args = g.entry()
    out = dict(zip(("params", "cost", "shape", "verts"), fn(*args)))
    out.update({f"arg{i}": a for i, a in enumerate(args)})
    kp = fittable_kp(args[0])
    fit = fn(args[0], args[1], kp, *args[3:])
    out.update(fit_kp=kp, **dict(zip(("fit_params", "fit_cost", "fit_shape",
                                      "fit_verts"), fit)))
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    # python -m tests.test_torch_graft_entry --record
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_graft_entry --record")
    record()
