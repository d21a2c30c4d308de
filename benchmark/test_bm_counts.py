"""The yardstick's frozen copies against the program's originals: the
roofline counts of ``smpltpu_torch/utils/roofline.py`` at two shapes each,
the peaks, and the seeded generators' structure."""

import pytest
import torch

from benchmark import counts, gen
from benchmark import reference as ref

roofline = pytest.importorskip("smpltpu_torch.utils.roofline")


@pytest.mark.parametrize("args", [(1, 100, 76, 10, 34, 150, 40, "pcg_kernel"),
                                  (667, 20, 76, 10, 34, 60, 64, "pcg_kernel"),
                                  (1, 1000, 76, 10, 34, 150.0, 64, "tridiag")])
def test_solver_counts(args):
    got = counts.stage_solver(*args)
    want = roofline.stage_solver("s", *args)
    assert got.flops == want.flops and got.bytes == want.hbm_bytes


@pytest.mark.parametrize("args", [(1, 76, 103, 10.5, "chol"), (128, 76, 34, 100, "eigh")])
def test_single_frame_counts(args):
    got = counts.stage_single_frame(*args)
    want = roofline.stage_single_frame("s", *args)
    assert got.flops == want.flops and got.bytes == want.hbm_bytes


@pytest.mark.parametrize("args", [(100, 6890), (37, 6890, 24, 10)])
def test_lbs_counts(args):
    got = counts.stage_lbs(*args)
    want = roofline.stage_lbs("s", *args)
    assert got.flops == want.flops and got.bytes == want.hbm_bytes


def test_peaks():
    assert counts.PEAK_F32_FLOPS == roofline.PEAK_F32_FLOPS
    assert counts.PEAK_HBM_BPS == roofline.PEAK_HBM_BPS
    w = counts.Work(67e9, 1.0)
    assert counts.bound_s(w) == pytest.approx(1e-3)


def test_k1_bound_at_the_stage_shapes():
    """PERF.md's K1 bounds: 0.94 us at 1 x 100 and 12.6 us at
    67 x 20 (40 steps), 15.0 us at 1 x 1000 and 200.7 us at 667 x 20 (64)."""
    for shape, us in (((1, 100, 76, 10, 40), 0.94), ((67, 20, 76, 10, 40), 12.6),
                      ((1, 1000, 76, 10, 64), 15.0), ((667, 20, 76, 10, 64), 200.7)):
        assert counts.bound_s(counts.k1_launch(*shape)) * 1e6 == pytest.approx(us, rel=0.01)


def test_generated_model_structure():
    m = gen.make_model("cpu", 12345, n_verts=500, n_faces=996)
    assert m["v_template"].shape == (500, 3) and m["faces"].shape == (996, 3)
    assert m["shapedirs"].shape == (500, 3, 10) and m["posedirs"].shape == (500, 3, 207)
    joints = torch.tensor(gen.JOINTS_REST)
    assert torch.allclose(m["J_regressor"] @ m["v_template"], joints, atol=1e-5)
    assert torch.allclose(m["weights"].sum(1), torch.ones(500))
    assert int(m["faces"].min()) >= 0 and int(m["faces"].max()) < 500
    again = gen.make_model("cpu", 12345, n_verts=500, n_faces=996)
    assert all(torch.equal(m[k], again[k]) for k in m)


def test_motion_is_bench_py_s():
    gt = gen.motion("cpu", 7, 2500)
    ph = torch.arange(2500.0)
    ph = 1000.0 - torch.abs(torch.remainder(ph, 2000.0) - 1000.0)
    assert torch.allclose(gt[:, 1], 2e-3 * ph) and torch.allclose(gt[:, 6], torch.full((2500,), 3.2))
    assert torch.equal(gt[1500], gt[500])
    kp = gen.keypoints(gen.make_model("cpu", 1, n_verts=300, n_faces=596),
                       ref.camera(720, 1280), gt[:5], 9)
    assert kp.shape == (5, 17, 4) and torch.all(kp[..., 3] == 1)
