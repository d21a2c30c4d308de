"""Configuration ``multi_smplx`` and its cell ``video10k_smplx``: the
reference copy against ``tests/plain_smplx.py``, the new per-layer
readers on hand-built traces, and the cell at a tiny size on the CPU,
sound and with a fault planted (half the windows left out)."""

import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from benchmark import faults, gen, gen_smplx, run, spec
from benchmark import reference as ref
from benchmark import reference_smplx as refx
from benchmark import trace as tr

pytest.importorskip("smpltpu_torch")

SEED = 2 ** 31 + 777
CELL = "video10k_smplx"


def _plain():
    path = os.path.join(spec.ROOT, "tests", "plain_smplx.py")
    s = importlib.util.spec_from_file_location("plain_smplx", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def tiny_cell(s1_iters: int = 8, s2_iters: int = 6):
    """The cell at 400 vertices, 60-frame videos, a 72 x 128 camera."""
    c = spec.cell(spec.load_bench(), CELL)
    cfg = copy.deepcopy(c.config)
    cfg["model_sizes"] = dict(cfg["model_sizes"], n_verts=400, n_faces=796)
    cfg["camera"] = {"width": 72, "height": 128}
    cfg["render"] = {"width": 72, "height": 128}
    cfg["fit"]["stage1"]["max_iters"] = s1_iters
    cfg["fit"]["stage2"]["max_iters"] = s2_iters
    return c._replace(config=cfg, traffic=dict(c.traffic, frames=60, videos=4))


@pytest.fixture(scope="module")
def model():
    return gen_smplx.make_model(torch.device("cpu"), 11, n_verts=400, n_faces=796)


def test_reference_copy_matches_the_plain_smplx(model):
    """Residuals, cost and vertices of the frozen copy, in float64, equal
    the plain SMPL-X's on the same arrays."""
    plain = _plain()
    d = {k: v.double().numpy() for k, v in model.items() if k not in ("faces", "parents")}
    d.update(faces=model["faces"].numpy(), parents=model["parents"].numpy())
    pm = plain.make(d)
    body = refx.make_body(model, ref.F64)
    g = torch.Generator().manual_seed(3)
    x = refx.init_params(6, "cpu", torch.float64)
    x[:, 1:4] = 0.2 * torch.randn((6, 3), generator=g, dtype=torch.float64)
    x[:, 7:] = 0.3 * torch.randn((6, 87), generator=g, dtype=torch.float64)
    betas = 0.3 * torch.randn((1, 10), generator=g, dtype=torch.float64)
    r0 = torch.as_tensor(ref.R0).expand(1, 6, 3, 3)
    cam = ref.camera(72, 128)
    kp = torch.zeros((1, 6, 47, 4), dtype=torch.float64)
    kp[..., 0] = torch.as_tensor(refx.USE_SMPLX, dtype=torch.float64)
    kp[..., 1:3] = 60.0 + 20.0 * torch.randn((1, 6, 47, 2), generator=g, dtype=torch.float64)
    kp[..., 3] = 1.0
    valid = torch.ones((1, 6), dtype=torch.float64)
    np.testing.assert_allclose(
        refx.kp_residuals(body, cam, x[None], betas[:, None], kp, r0),
        plain.kp_residuals(pm, tuple(cam), x[None], betas[:, None], kp, r0),
        rtol=1e-12, atol=1e-10)
    cfg = ref.MultiCfg(5.0, 25.0, 3.0)
    np.testing.assert_allclose(
        refx.multi_cost(body, cam, cfg, x[None], betas, kp, r0, valid),
        plain.multi_cost(pm, tuple(cam), 5.0, 25.0, 3.0, x[None], betas, kp, r0, valid),
        rtol=1e-12)
    np.testing.assert_allclose(
        refx.smplx_vertices(body, x, betas[0], r0[0, 0]),
        plain.forward(pm, x, betas[0], r0[0, 0])[1], rtol=0, atol=1e-12)


def test_hand_motion_keypoints_are_seeded_and_bounded(model):
    tr_ = dict(spec.cell(spec.load_bench(), CELL).traffic, frames=300)
    a = gen_smplx.motion(torch.device("cpu"), gen.sub_seed(10000, 3), 300, tr_["hands"])
    b = gen_smplx.motion(torch.device("cpu"), gen.sub_seed(10000, 3), 300, tr_["hands"])
    assert torch.equal(a, b) and a.shape == (300, 94)
    assert float(a[:, 70:].abs().max()) <= 1.5
    assert torch.equal(a[:, :70], gen.motion(torch.device("cpu"), gen.sub_seed(10000, 3),
                                             300)[:, :70])
    kp = gen_smplx.video_keypoints(model, ref.camera(720, 1280), tr_, SEED, 0,
                                   torch.device("cpu"))
    assert kp.shape == (300, 47, 4) and bool(torch.all(kp[..., 3] == 1.0))


def _op(name, s, e):
    return tr.Op(name, s, e)


def test_hand_pca_reader_counts_spans_inside_trips():
    reader = spec.reader("lm.hand_pca_ms.smplx")
    t = tr.Trace(device=[], host=[
        _op("multi_frame.trip", 0, 10_000_000), _op("energy.hand_pca", 1_000_000, 2_000_000),
        _op("energy.hand_pca", 5_000_000, 5_500_000),
        _op("multi_frame.trip", 20_000_000, 30_000_000),
        _op("energy.hand_pca", 21_000_000, 22_000_000),
        _op("energy.hand_pca", 40_000_000, 49_000_000)],          # outside any trip
        start_ns=0, end_ns=50_000_000)
    assert reader.read({"trace": t}) == pytest.approx(1.25)
    no_span = t._replace(host=[o for o in t.host if o.name != "energy.hand_pca"])
    assert reader.read({"trace": no_span}) is None
    assert reader.read({}) is None


def test_roofline_readers_on_a_hand_built_trace():
    cfg = spec.cell(spec.load_bench(), CELL).config
    v = {"frames": 10000, "trips1": 150, "trips2": 60, "windows": 667}
    dev = [_op("void (anonymous namespace)::arrow_pcg_kernel<0, 0, true>(...)", 0,
               2_000_000_000),
           _op("void (anonymous namespace)::lbs_kernel<55, 20, 1>(...)", 3_000_000_000,
               3_100_000_000)]
    t = tr.Trace(device=dev, host=[], start_ns=0, end_ns=4_000_000_000)
    ctx = {"trace": t, "traced_video": v, "cfg": cfg, "model_sizes": cfg["model_sizes"]}
    k1 = spec.reader("k1_roofline.smplx").read(ctx)
    k2 = spec.reader("k2_roofline.smplx").read(ctx)
    assert 0.0 < k1 < 100.0 and 0.0 < k2 < 100.0
    assert spec.reader("k1_roofline.smplx").read({"cfg": cfg}) is None
    assert spec.reader("mfu.smplx").read({"videos": [v]}) is None


def test_tiny_cell_runs_and_is_correct():
    line = run.execute(tiny_cell(), SEED, 0.05, True, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    m = line["metrics"]
    for name in ("mfu.smplx", "lm.hand_pca_ms.smplx", "stage1_ms.video", "lm.trips.video",
                 "render_ms.video", "stage2_ms.video"):
        assert name in m, name
    assert 0.0 < m["mfu.smplx"]["value"] < 100.0
    assert set(line["checks"]) == {"cost_gap", "start_share", "newton_gap", "render_px"}


def test_tiny_cell_with_half_the_windows_left_out(monkeypatch):
    faults.plant("half", monkeypatch.setattr)
    line = run.execute(tiny_cell(), SEED, 0.05, False, "cpu")
    assert not line["correct"]
    assert line["checks"]["newton_gap"]["value"] > line["checks"]["newton_gap"]["limit"]
