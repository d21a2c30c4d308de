"""bench.py's twin (``python -m smpltpu_torch.bench``) against bench.py and
the JAX package on the CPU: its workload, its two stages and the fused fit
in float64, its sampled residual, its render write-back, its handling of
bench.py's environment, and one whole default run.

The reference side is bench.py's own recipe, run with the JAX functions
that bench.py calls, at BENCH_FRAMES=60 (6 anchors, 4 windows, the
full-width synthetic model): the keypoints as bench.py makes them (float32,
its seeds), then the stage configs of bench.py in float64 at a cut depth
(40 + 20 LM trips, bench.py: 150 + 60) on those keypoints, stage 1 by
``build_multi_fitter``, bench.py's host interpolation, stage 2 under
``jax.vmap``, and ``build_fused_two_stage``. XLA takes tens of seconds to
compile them, so they are read from ``tests/data/bench_jax_ref.npz``,
which ``python -m tests.test_torch_bench --record`` writes.

Tolerances: the keypoints to two float32 ulps at the frame's 1280 px,
2.4e-4 px (the same seeds, float32 forward kinematics in another order;
measured: 1.2e-4 px at most); the exact
solves (tridiag, cr) to 1e-9 in cost and 1e-8 in params, counts exact
(tests/test_torch_tridiag.py); the PCG at BENCH_CG_ITERS=20 to 2e-5 and
5e-4, counts exact (tests/test_torch_fit.py); bench.py's sampled residual
to 1e-6 px on the same params; the write-back bit for bit.

bench.py's default CG of 40 steps reproduces no trajectory on this
workload, not even the reference's own: stage 1 run unbatched and under
``jax.vmap`` parts by 3.2e-5 in cost after one LM trip and by up to
2.6e-2 after seven (``pcg40_stage1_vmap_spread`` in the npz), while at 20
steps the two stay within 4.0e-7 over all 40 trips
(``pcg_stage1_vmap_spread``), inside the PCG tolerance. So the PCG path
is held step by step at 20 steps, and bench.py's default by its result,
the sampled residual, within the smoke's 0.1 px for two implementations
of this CG (``PLAIN_GAP_MAX_PX``).

The BENCH_SINGLE=1 _GMM=1 run (the GMM quality gate) and the stream modes
are held piece by piece to bench.py's recipe in the JAX package, recorded
in the same npz at BENCH_SINGLE_FRAMES=6 and BENCH_STREAM_FRAMES=4: the
gate's keypoints (float32, bench.py's seeds) within KP_ATOL_PX; in
float64, the prior-seeded start set, the GMM and the no-GMM fits from
those starts and bench.py's residual of each frame's lowest-cost start;
the online step driven frame by frame as bench.py drives it. The twin's
residual and best-start pick on the reference's fits equal bench.py's to
1e-6 px; the twin's own fits are held at the single-frame solver's
free-scale tolerances (tests/test_torch_single.py: cost 2e-6 relative, t / s
2e-3) and its three stream routes at the online step's frozen-scale ones
(tests/test_torch_online.py: 1e-9).

The same file holds ``chip_smoke.py``'s copies of the recipe to what they
built before they became calls of the twin: the ``smoke_*`` arrays of the
npz, recorded once from the smoke's own functions at 60 frames and the
300-vertex model (``record`` carries them over).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import smpltpu_torch.bench as bench
from smpltpu_torch.pipeline.multi import interpolate_from_anchors
from smpltpu_torch.solve import MultiFrameResult, best_of_starts
from tests import test_torch_fit, test_torch_tridiag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "bench_jax_ref.npz")
F64 = torch.float64
N_FRAMES = 60
S1_ITERS, S2_ITERS = 40, 20          # bench.py: 150, 60
# (linear solver, CG steps) of the stage parity cases; bench.py's default
# is ("pcg", 40), held by its residual (see the module docstring)
CASES = (("pcg", 20), ("tridiag", 40), ("cr", 40))
PLAIN_GAP_MAX_PX = 0.1   # two implementations of the 40-step CG (chip_smoke.py)
KP_ATOL_PX = 2 * float(np.spacing(np.float32(1280.0)))   # 2.4e-4
SAMPLED_ATOL_PX = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _result(golden, prefix):
    return MultiFrameResult(*(golden[f"{prefix}_{f}"] for f in
                              MultiFrameResult._fields))


def _assert_pcg(got, want):
    """tests/test_torch_fit.py's PCG tolerances: counts exact, cost 2e-5,
    params and shape 5e-4."""
    for field in ("iters_run", "converged", "n_accepted"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(want.cost),
                               rtol=test_torch_fit.COST_RTOL, atol=0)
    for field in ("params", "shape"):
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=test_torch_fit.PARAM_ATOL)


@pytest.fixture(scope="module")
def w64(golden):
    """The twin's workload in float64 on the reference's keypoints."""
    return bench.workload("cpu", N_FRAMES, dtype=F64, kp=golden["kp"])


def test_workload_keypoints_match_bench(golden):
    """bench.py's synthetic video through the twin (float32, as bench.py
    runs it): the keypoints within two float32 ulps of the 1280 px frame
    of bench.py's (the forward kinematics round in another order; measured
    1.2e-4 px at most), the slots and confidences equal, and the anchors
    and windows as bench.py builds them."""
    w = bench.workload("cpu", N_FRAMES)
    want = golden["kp"]
    np.testing.assert_allclose(w["kp"], want, rtol=0, atol=KP_ATOL_PX)
    np.testing.assert_array_equal(w["kp"][..., [0, 3]],
                                  golden["kp"][..., [0, 3]])
    np.testing.assert_array_equal(w["anchor_idx"], golden["anchor_idx"])
    np.testing.assert_array_equal(w["starts"], golden["starts"])


def anchor_poses(anchor_params, anchor_idx, n_frames):
    """The twin's stage-2 warm starts: bench.py's host interpolation by the
    multi CLI's ``interpolate_from_anchors``, as ``bench.run`` calls it."""
    poses = np.zeros((n_frames, anchor_params.shape[1]), anchor_params.dtype)
    interpolate_from_anchors(poses, anchor_idx, anchor_params)
    return poses


def _stages(w, linear, cg_iters):
    """Stage 1, bench.py's host interpolation and stage 2 (one batch)
    through the twin's functions, float64."""
    cfg1, cfg2 = bench.stage_configs(linear, cg_iters, s1_iters=S1_ITERS,
                                     s2_iters=S2_ITERS)
    fit1, args1 = bench.build_stage1(w, cfg1, dtype=F64)
    st1 = fit1(*args1)
    poses = anchor_poses(st1.params.numpy(), w["anchor_idx"], N_FRAMES)
    args2 = bench.stage2_inputs(w, poses, st1.shape, dtype=F64)
    return st1, bench.build_stage2(w, cfg2, dtype=F64)(*args2)


@pytest.mark.parametrize("linear,cg_iters", CASES)
def test_stages_match_reference(golden, w64, linear, cg_iters):
    """The twin's two stages against bench.py's recipe in the JAX package,
    float64: the exact solves at bench.py's settings, the PCG at
    BENCH_CG_ITERS=20."""
    st1, st2 = _stages(w64, linear, cg_iters)
    _check(linear, st1, _result(golden, f"{linear}_stage1"))
    _check(linear, st2, _result(golden, f"{linear}_stage2"))


def test_reference_pcg_spread():
    """Why the default is held by its residual: the reference's own stage 1,
    unbatched against under jax.vmap (recorded), stays within the PCG cost
    tolerance over its 40 trips at 20 CG steps, and leaves it by two
    orders at bench.py's 40."""
    golden = np.load(GOLDEN)
    assert golden["pcg_stage1_vmap_spread"].max() < test_torch_fit.COST_RTOL
    assert (golden["pcg40_stage1_vmap_spread"].max()
            > 100 * test_torch_fit.COST_RTOL)


def test_default_pcg_residual_matches_reference(golden, w64):
    """bench.py's default, 40 PCG steps, where neither the reference nor
    the port reproduces a trajectory (module docstring): the fit's
    sampled residual within PLAIN_GAP_MAX_PX of the reference's, the
    smoke's bound for two implementations of this CG."""
    _, st2 = _stages(w64, "pcg", 40)
    px = bench.sampled_residual(w64, st2.params, st2.shape)
    assert abs(px - float(golden["sampled_px"])) <= PLAIN_GAP_MAX_PX, (
        px, float(golden["sampled_px"]))


def _check(linear, got, want):
    if linear == "pcg":
        _assert_pcg(got, want)
    else:
        test_torch_tridiag._assert_match(got, want)


def test_fused_matches_reference(golden, w64):
    """The fused two-stage fit on the twin's workload arguments (the seven
    tensors bench.py hands ``build_fused_two_stage``) against the JAX
    package's, PCG at BENCH_CG_ITERS=20, float64."""
    from smpltpu_torch.solve import build_fused_two_stage
    cfg1, cfg2 = bench.stage_configs("pcg", 20, s1_iters=S1_ITERS,
                                     s2_iters=S2_ITERS)
    run = build_fused_two_stage(w64["spec"], w64["cam"], cfg1, cfg2, 10,
                                w64["anchor_idx"], w64["starts"], bench.WSIZE,
                                N_FRAMES, device="cpu", dtype=F64)
    f1, f2 = run(*w64["args"])
    _assert_pcg(f1, _result(golden, "fused_stage1"))
    _assert_pcg(f2, _result(golden, "fused_stage2"))


def test_sampled_residual_matches_bench(golden, w64):
    """bench.py's residual estimator (every n_win // 8-th window, every 5th
    frame, each window under its own shape) on the reference's stage-2
    params equals bench.py's to 1e-6 px; the full-batch residual over all
    frames of the same fit sits near it."""
    params = torch.as_tensor(golden["pcg40_stage2_params"])
    shape = torch.as_tensor(golden["pcg40_stage2_shape"])
    px = bench.sampled_residual(w64, params, shape)
    assert abs(px - float(golden["sampled_px"])) <= SAMPLED_ATOL_PX
    fp, shp = bench.write_back(w64, MultiFrameResult(params, shape,
                                                     *([None] * 7)))
    full = bench.full_batch_residual(w64, fp, shp)
    assert abs(full - px) < 0.2, (full, px)


def test_write_back_matches_bench(golden, w64):
    """The render's per-frame params (bench.py:366-372: the first `stride`
    frames of each window, the whole tail of the last) bit for bit, in
    float32 as bench.py keeps them."""
    params = torch.as_tensor(golden["pcg40_stage2_params"].astype(np.float32))
    fp, shp = bench.write_back(w64, MultiFrameResult(
        params, params[:, 0, :10], *([None] * 7)))
    np.testing.assert_array_equal(fp.numpy(), golden["frame_params"])
    np.testing.assert_array_equal(shp.numpy(), params[0, 0, :10].numpy())


def test_host_interpolation_is_bench_loop(golden):
    """The twin's host interpolation, the multi CLI's
    ``interpolate_from_anchors`` on zeroed poses, equals bench.py's loop,
    as recorded on the reference's stage-1 anchors, bit for bit."""
    ap = golden["pcg40_stage1_params"]
    np.testing.assert_array_equal(
        anchor_poses(ap, golden["anchor_idx"], N_FRAMES),
        golden["pcg40_poses"])


def _bench_names():
    """Every BENCH_* variable bench.py reads, with its default."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    return dict(re.findall(r'environ\.get\("(BENCH_\w+)",\s*"([^"]*)"\)',
                           src))


def _other(value):
    """A value of a BENCH_* variable other than ``value``."""
    named = {"0": "1", "1": "0", "": "eigh", "pcg": "cr"}
    if value in named:
        return named[value]
    return str(int(value) + 1) if value.isdigit() else str(float(value) + 0.5)


def test_every_bench_variable_is_handled():
    """Every BENCH_* variable of bench.py is named in the twin's docstring
    and is ported (read_env takes bench.py's default as its own and reads
    another value), inert or refused."""
    names = _bench_names()
    assert len(names) >= 30
    doc = " ".join(bench.__doc__.split())
    for name, default in names.items():
        short = name[len("BENCH_SINGLE"):] if name.startswith(
            "BENCH_SINGLE_") else name
        assert name in doc or short in doc, name
        if name in bench.INERT:
            assert bench.read_env({name: _other(default)}) == bench.BenchEnv()
        elif name in bench.REFUSED:
            assert bench.REFUSED[name] == default, name
        else:
            assert bench.read_env({name: default}) == bench.BenchEnv(), name
            assert bench.read_env({name: _other(default)}) != \
                bench.BenchEnv(), name


@pytest.mark.parametrize("name,value", [("BENCH_RASTER_ENTRY_CAP", "-1"),
                                        ("BENCH_RASTER_EDGES", "mxu"),
                                        ("BENCH_RENDER_AUDIT_CAP", "1")])
def test_refused_variable_raises(monkeypatch, capsys, name, value):
    """A TPU rasterizer knob away from its default stops the run before
    any work: read_env raises, main exits 1 with the reason and prints no
    result line. At its default it is accepted."""
    with pytest.raises(ValueError, match=name):
        bench.read_env({name: value})
    assert bench.read_env({name: bench.REFUSED[name]}) == bench.BenchEnv()
    monkeypatch.setenv(name, value)
    assert bench.main([], device="cpu") == 1
    cap = capsys.readouterr()
    assert cap.out == "" and name in cap.err


@pytest.mark.parametrize("name", ["BENCH_CG_UNROLL", "BENCH_COMPILE_CACHE"])
def test_inert_variable_changes_nothing(name):
    """The XLA knobs are accepted and change neither the parsed
    environment nor the stage configs."""
    env = bench.read_env({name: "4", "BENCH_LINEAR": "pcg_kernel"})
    assert env == bench.read_env({"BENCH_LINEAR": "pcg_kernel"})
    assert bench.stage_configs(env.linear) == bench.stage_configs("pcg_kernel")


def test_read_env_defaults_and_parsing():
    """No variable set: bench.py's defaults; flags on only at "1"."""
    assert bench.read_env({}) == bench.BenchEnv()
    env = bench.read_env({"BENCH_FRAMES": "200", "BENCH_FUSED": "0",
                          "BENCH_RENDER": "yes", "BENCH_SINGLE_GMM": "stress",
                          "BENCH_SINGLE_ORIENT": "0", "BENCH_CG_RTOL": "1e-3"})
    assert (env.frames, env.fused, env.render, env.single_gmm,
            env.single_orient, env.cg_rtol) == (200, False, False, "stress",
                                                False, 1e-3)


@pytest.mark.parametrize("iters,chunk,want", [
    ([3, 5, 2, 0], 0, {"4x20": 5}),
    ([3, 5, 2, 0, 7], 2, {"2x20": 7, "1x20": 7}),
    ([1], 3, {"1x20": 1})])
def test_window_trips(iters, chunk, want):
    """K1's launches implied by a window batch's trips: one a trip of each
    batch or chunk, which runs until its slowest window stops."""
    assert bench.window_trips(np.asarray(iters), chunk) == want


def test_main_default_run(monkeypatch, capsys):
    """``main(device="cpu")`` at BENCH_FRAMES=60, bench.py's defaults
    otherwise: exactly one stdout line with bench.py's four keys; stderr
    holds the fused record with bench.py's keys, both residuals, the
    roofline lines, the launch counts and the trips."""
    import json
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_FRAMES", str(N_FRAMES))
    assert bench.main([], device="cpu") == 0
    cap = capsys.readouterr()
    lines = [ln for ln in cap.out.splitlines() if ln.strip()]
    assert len(lines) == 1, cap.out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == bench.METRIC and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 100.0, 3)
    fused = [json.loads(ln) for ln in cap.err.splitlines()
             if ln.startswith('{"metric": "fused_two_stage')]
    assert len(fused) == 1 and set(fused[0]) == {
        "metric", "value", "unit", "sequential_fps"}
    assert "mesh size 1" in cap.err
    px = [float(m) for m in re.findall(
        r"^bench: (?:full-batch )?residual pixel error ([\d.]+)px",
        cap.err, re.M)]
    assert len(px) == 2 and all(0 < p < 2.0 for p in px), px
    assert cap.err.count("roofline[") == 2
    trips = json.loads(re.search(r"LM trips by system shape (\{.*\})",
                                 cap.err).group(1))
    # stage 1 twice, stage 2 four times, the fused fit four times
    assert set(trips) == {"1x6", "4x20"}


@pytest.mark.parametrize("piece", ["workload", "configs", "write_back",
                                   "residual", "single_problem"])
def test_smoke_recipe_pinned(golden, piece):
    """The twin's recipe functions, which chip_smoke.py calls, build what
    the smoke built when it restated bench.py (recorded from its own
    functions at 60 frames and the 300-vertex model; its configs at a
    fifth of the depth with 64 CG steps)."""
    w = bench.workload("cpu", N_FRAMES, 300)
    if piece == "workload":
        np.testing.assert_array_equal(w["kp"], golden["smoke_kp"])
        np.testing.assert_array_equal(w["starts"], golden["smoke_starts"])
        np.testing.assert_array_equal(w["anchor_idx"],
                                      golden["smoke_anchor_idx"])
        np.testing.assert_array_equal(w["r0c"], golden["smoke_r0c"])
        for i, a in enumerate(w["args"]):
            np.testing.assert_array_equal(a.numpy(), golden[f"smoke_args{i}"])
            assert a.dtype == torch.float32
    elif piece == "configs":
        c1, c2 = bench.stage_configs("pcg_kernel", 64, fused=True,
                                     s1_iters=bench.S1_ITERS // 5,
                                     s2_iters=bench.S2_ITERS // 5)
        assert repr(tuple(c1)) == str(golden["smoke_cfg1"])
        assert repr(tuple(c2)) == str(golden["smoke_cfg2"])
    elif piece in ("write_back", "residual"):
        st2 = MultiFrameResult(torch.as_tensor(golden["smoke_wb_params_in"]),
                               torch.as_tensor(golden["smoke_wb_shape_in"]),
                               *([None] * 7))
        fp, shp = bench.write_back(w, st2)
        if piece == "write_back":
            np.testing.assert_array_equal(fp.numpy(),
                                          golden["smoke_wb_frame_params"])
            np.testing.assert_array_equal(shp.numpy(),
                                          golden["smoke_wb_shape"])
        else:
            assert bench.full_batch_residual(w, fp, shp) == float(
                golden["smoke_full_batch_residual"])
            a = w["anchor_idx"]
            assert bench.full_batch_residual(w, fp[a], shp, frames=a) == float(
                golden["smoke_full_batch_residual_anchors"])
    else:
        for tag, dtype in (("f32", torch.float32), ("f64", F64)):
            prob = bench.single_problem(w, dtype)
            for k in ("base_offsets", "r0"):
                got = getattr(prob.spec, k)
                assert got.dtype == dtype
                np.testing.assert_array_equal(
                    got.numpy(), golden[f"smoke_single_{tag}_{k}"])
            np.testing.assert_array_equal(
                [prob.beta_pose, prob.beta_shape],
                golden[f"smoke_single_{tag}_betas"])
            np.testing.assert_array_equal(
                [float(c) for c in prob.cam], golden[f"smoke_single_{tag}_cam"])


GATE_FRAMES, STREAM_FRAMES, MODE_FRAMES = 6, 4, 4
# BENCH_SINGLE's other sub-modes, each recorded at MODE_FRAMES frames of
# the video (tests/test_torch_bench_modes.py)
SINGLE_MODES = {
    "multistart_eigh": {"BENCH_SINGLE_MULTISTART": "1",
                        "BENCH_SINGLE_TR": "eigh"},
    "stress_tr2": {"BENCH_SINGLE_GMM": "stress", "BENCH_SINGLE_TR_ITERS": "2"},
    "adaptive": {"BENCH_SINGLE_ADAPTIVE": "1", "BENCH_SINGLE_ADAPTIVE_PX": "0.5",
                 "BENCH_SINGLE_ORIENT": "0", "BENCH_SINGLE_PROPAGATE": "1"},
}
FREE_SCALE_COST_RTOL, FREE_SCALE_GAUGE_ATOL = 2e-6, 2e-3   # test_torch_single.py
ONLINE_ATOL = 1e-9                                          # test_torch_online.py
# a single-frame residual of the twin's fit against the reference's, free
# scale (measured on the gate: 1.9e-7 px with the GMM, 4.6e-5 without)
GATE_PX_ATOL = 1e-3


@pytest.fixture(scope="module")
def gate_prior():
    from smpltpu_torch.io.gmm import load_pose_prior_txt
    return load_pose_prior_txt(bench.PRIOR_PATH)


def test_gmm_gate_keypoints_match_bench(golden, gate_prior):
    """BENCH_SINGLE_GMM=1's workload (bench.py:686-708: ground truth near
    the prior's dominant component from default_rng(11), projected with
    1 px noise) through the twin, float32 as bench.py makes it: within
    KP_ATOL_PX of bench.py's, slots and confidences equal."""
    w = bench.workload("cpu", N_FRAMES)
    got = bench.gmm_gate_keypoints(w, gate_prior, GATE_FRAMES)
    want = golden["gate_kp"]
    np.testing.assert_allclose(got, want, rtol=0, atol=KP_ATOL_PX)
    np.testing.assert_array_equal(got[..., [0, 3]], want[..., [0, 3]])


@pytest.mark.parametrize("prior", ["gmm", "l2"])
def test_gate_residual_matches_bench(golden, w64, gate_prior, prior):
    """bench.py's residual of each frame's lowest-cost start (bench.py:
    801-806 with the GMM, :825-835 without) through the twin's pick
    (``best_of_starts``) and ``single_px``, on the reference's fits of the
    gate's starts: equal to bench.py's to 1e-6 px, and so is their gap."""
    from smpltpu_torch.solve.lm import LMResult
    prob = bench.single_problem(w64, F64,
                                gmm=gate_prior if prior == "gmm" else None)
    n_s, s_dim = golden["gate_starts"].shape[:2]
    st = LMResult(*(torch.as_tensor(golden[f"gate_{prior}_{f}"])
                    if f"gate_{prior}_{f}" in golden else None
                    for f in LMResult._fields))
    best_x = best_of_starts(st, n_s, s_dim)[0]
    px = bench.single_px(prob, best_x, golden["gate_kp"])
    assert abs(px - float(golden[f"gate_{prior}_px"])) <= SAMPLED_ATOL_PX


def test_gate_fits_match_reference(golden, w64, gate_prior):
    """The gate's fits in the twin, float64: the prior-seeded start set of
    bench.py (make_start_set with the prior's means) as the reference
    builds it, then the GMM and the no-GMM problem fitted from the
    reference's starts (100 trips, the exact trust region): each frame's
    best start the reference's, its cost within 2e-6 and its t / s within
    2e-3 (the free scale's gauge), the residuals and their gap within
    1e-3 px of bench.py's."""
    from smpltpu_torch.solve import build_fitter, make_start_set
    kp_g = golden["gate_kp"]
    starts = make_start_set(kp_g, bench.single_problem(w64, F64).spec,
                            w64["cam"], pose_seeds=np.asarray(
                                gate_prior["means"]))
    np.testing.assert_allclose(starts, golden["gate_starts"], rtol=0,
                               atol=1e-9)
    n_s, s_dim = starts.shape[:2]
    x0 = golden["gate_starts"].reshape(n_s * s_dim, -1)
    kp_fit = np.repeat(kp_g, s_dim, axis=0)
    px = {}
    for prior in ("gmm", "l2"):
        prob = bench.single_problem(w64, F64, gmm=gate_prior
                                    if prior == "gmm" else None)
        st = build_fitter(prob, 100, device="cpu", dtype=F64)(x0, kp_fit)
        x, cost, idx = best_of_starts(st, n_s, s_dim)
        want = golden[f"gate_{prior}_cost"].reshape(n_s, s_dim)
        np.testing.assert_array_equal(idx, np.argmin(want, axis=1))
        np.testing.assert_allclose(cost, want.min(axis=1),
                                   rtol=FREE_SCALE_COST_RTOL)
        wx = golden[f"gate_{prior}_x"].reshape(n_s, s_dim, -1)[
            np.arange(n_s), idx]
        np.testing.assert_allclose(_gauge_free(x), _gauge_free(wx),
                                   atol=FREE_SCALE_GAUGE_ATOL)
        px[prior] = bench.single_px(prob, x, kp_g)
        assert abs(px[prior] - float(golden[f"gate_{prior}_px"])) \
            <= GATE_PX_ATOL
    gap = float(golden["gate_gmm_px"]) - float(golden["gate_l2_px"])
    assert abs((px["gmm"] - px["l2"]) - gap) <= 2 * GATE_PX_ATOL


def _gauge_free(x):
    from tests.test_torch_single import _gauge_free as gauge_free
    return gauge_free(np.asarray(x))


def test_stream_routes_match_reference(golden, w64):
    """BENCH_STREAM, _SCAN and _PUMP through the twin at 4 frames, float64,
    from the reference's stage-1 shape: each route's fit of every frame
    within 1e-9 of bench.py's per-frame loop of the online step in the
    JAX package (the scale frozen, so one trajectory)."""
    env = bench.read_env({"BENCH_STREAM": "1", "BENCH_STREAM_SCAN": "1",
                          "BENCH_STREAM_PUMP": "1",
                          "BENCH_STREAM_FRAMES": str(STREAM_FRAMES)})
    shp0 = torch.as_tensor(golden["pcg40_stage1_shape"])
    fits = bench.stream_pass(w64, env, shp0, torch.device("cpu"), F64)
    assert set(fits) == {"stream", "scan", "pump"}
    for route, xs in fits.items():
        np.testing.assert_allclose(xs, golden["stream_x"], rtol=0,
                                   atol=ONLINE_ATOL, err_msg=route)


def record(path=GOLDEN):
    """bench.py's recipe in the JAX package at BENCH_FRAMES=60: the
    keypoints as bench.py makes them (float32), then, in float64 on those
    keypoints, the stages at the cut depth for each of CASES and for
    bench.py's default (pcg, 40 steps), the fused fit (pcg, 20 steps),
    bench.py's sampled residual and its write-back, and stage 1's spread
    against itself under jax.vmap at 40 steps. The ``smoke_*`` arrays
    already in ``path`` are carried over."""
    import jax
    import jax.numpy as jnp

    from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
    from smpltpu.energy import make_skeleton_spec, skeleton_joints_cam
    from smpltpu.energy.params import init_frame_params
    from smpltpu.energy.reproj import project
    from smpltpu.models import SMPLModel, make_synthetic_model
    from smpltpu.solve import (
        MultiFrameConfig,
        build_fused_two_stage,
        build_multi_fitter,
    )
    from smpltpu.utils import default_intrinsics

    out = {k: v for k, v in (np.load(path).items() if os.path.exists(path)
                             else ()) if k.startswith("smoke_")}
    wsize, overlap, n = bench.WSIZE, bench.OVERLAP, N_FRAMES
    # bench.py:85-132, as it runs them (float32)
    rng = np.random.default_rng(0)
    model = SMPLModel.from_dict(make_synthetic_model(), dtype=jnp.float32)
    cam = default_intrinsics(720, 1280)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    r0c = np.asarray(init_root_rotation(), np.float32)
    base = rng.normal(size=(23, 3)) * 0.15
    drift = rng.normal(size=(23, 3)) * 0.003
    fidx = np.arange(n, dtype=np.float32)
    ph = 1000.0 - np.abs(np.mod(fidx, 2000.0) - 1000.0)
    gt_np = np.zeros((n, 76), np.float32)
    gt_np[:, 0] = 1.0
    gt_np[:, 1] = 2e-3 * ph
    gt_np[:, 2] = 1e-3 * ph
    gt_np[:, 4] = 0.1 + 1e-3 * ph
    gt_np[:, 5] = -0.1
    gt_np[:, 6] = 3.2
    gt_np[:, 7:] = (base[None] + ph[:, None, None] * drift[None]
                    ).reshape(n, 69).astype(np.float32)
    uv = np.asarray(jax.jit(jax.vmap(
        lambda p: project(skeleton_joints_cam(
            p, jnp.zeros(10, jnp.float32), spec), cam)))(jnp.asarray(gt_np)))
    kp = np.zeros((n, N_KP_SLOTS, 4), np.float32)
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(
        size=(n, N_KP_SLOTS, 2)).astype(np.float32)
    kp[:, :, 3] = 1.0
    stride = wsize - overlap
    starts = list(range(0, n, stride))
    n_win = len(starts)
    kpw = np.zeros((n_win, wsize, N_KP_SLOTS, 4), np.float32)
    kpw[:, :, :, 0] = USE_SMPL
    validw = np.zeros((n_win, wsize), np.float32)
    for i, s in enumerate(starts):
        e = min(s + wsize, n)
        kpw[i, :e - s] = kp[s:e]
        validw[i, :e - s] = 1.0
    anchor_idx = np.arange(0, n, 10)
    n_a = len(anchor_idx)
    out.update(kp=kp, anchor_idx=anchor_idx, starts=np.asarray(starts))

    # float64 fits on those keypoints
    f64 = jnp.float64
    model64 = SMPLModel.from_dict(make_synthetic_model(), dtype=f64)
    cam64 = default_intrinsics(720, 1280, dtype=f64)
    spec64 = make_skeleton_spec(model64, init_root_rotation(), with_shape=True)
    init = np.asarray(init_frame_params(), np.float64)
    args1 = (np.tile(init, (n_a, 1)), np.zeros(10), kp[anchor_idx].astype(
        np.float64), np.tile(r0c.astype(np.float64), (n_a, 1, 1)))
    r0w = np.tile(r0c.astype(np.float64), (n_win, wsize, 1, 1))
    common = dict(beta_pose=5.0, lambda_temporal=3.0, cg_unroll=1,
                  cg_rtol=0.0, fused_cost=True)
    for linear, cg_iters in CASES + (("pcg", 40),):
        tag = linear if (linear, cg_iters) in CASES else f"{linear}{cg_iters}"
        cfg1 = MultiFrameConfig(beta_shape=25.0, max_iters=S1_ITERS,
                                linear=linear, cg_iters=cg_iters, **common)
        cfg = MultiFrameConfig(beta_shape=1e5, max_iters=S2_ITERS,
                               linear=linear, cg_iters=cg_iters, **common)
        fit1 = build_multi_fitter(spec64, cam64, cfg1, 10, dtype=f64)
        st1 = fit1(*map(jnp.asarray, args1))
        # bench.py:205-213
        anchor_params = np.asarray(st1.params)[:n_a]
        poses = np.zeros((n, anchor_params.shape[1]), np.float64)
        for k, fid in enumerate(anchor_idx):
            nxt = anchor_idx[k + 1] if k + 1 < len(anchor_idx) else n
            pb = (anchor_params[k + 1] if k + 1 < len(anchor_idx)
                  else anchor_params[k])
            for i in range(fid, min(nxt, n)):
                t = (i - fid) / max(nxt - fid, 1)
                poses[i] = (1 - t) * anchor_params[k] + t * pb
        # bench.py:216-245, one device, no chunks
        fit = build_multi_fitter(spec64, cam64, cfg, 10, dtype=f64)
        p0 = np.tile(init, (n_win, wsize, 1))
        for i, s in enumerate(starts):
            e = min(s + wsize, n)
            p0[i, :e - s] = poses[s:e]
        w0 = np.tile(np.asarray(st1.shape), (n_win, 1))
        st = jax.jit(jax.vmap(lambda a, b, c, d, e: fit(a, b, c, d, e)))(
            *map(jnp.asarray, (p0, w0, kpw.astype(np.float64), r0w,
                               validw.astype(np.float64))))
        for stage, res in (("stage1", st1), ("stage2", st)):
            for k, v in res._asdict().items():
                out[f"{tag}_{stage}_{k}"] = np.asarray(v)
        if tag == "pcg":
            fused = build_fused_two_stage(spec64, cam64, cfg1, cfg, 10,
                                          anchor_idx, starts, wsize, n,
                                          dtype=f64)
            f1, f2 = fused(*map(jnp.asarray, args1), jnp.asarray(kpw, f64),
                           jnp.asarray(r0w), jnp.asarray(validw, f64))
            for stage, res in (("stage1", f1), ("stage2", f2)):
                for k, v in res._asdict().items():
                    out[f"fused_{stage}_{k}"] = np.asarray(v)
        if linear == "pcg":
            # the reference against itself: stage 1 unbatched and under
            # jax.vmap, the relative cost after each trip
            st1_v = jax.vmap(fit1)(*(jnp.asarray(a)[None] for a in args1))
            ha = np.asarray(st1.cost_history)
            out[f"{tag}_stage1_vmap_spread"] = np.abs(
                np.asarray(st1_v.cost_history)[0] - ha) / ha
        if tag != "pcg40":
            continue
        out["pcg40_poses"] = poses
        # bench.py:329-343 on this fit's params, float64
        errs = []
        sample_joints = jax.jit(jax.vmap(
            lambda p, w: project(skeleton_joints_cam(p, w, spec64), cam64)))
        for i in range(0, n_win, max(1, n_win // 8)):
            s = starts[i]
            e = min(s + wsize, n)
            uvs = np.asarray(sample_joints(
                st.params[i][:e - s], jnp.tile(st.shape[i], (e - s, 1))))
            for k in range(0, e - s, 5):
                errs.append(np.linalg.norm(
                    uvs[k][USE_SMPL] - kp[s + k, :, 1:3], axis=-1).mean())
        out["sampled_px"] = np.asarray(np.mean(errs))
        # bench.py:366-372 on this fit's params, float32 as bench.py has them
        pa = np.asarray(st.params).astype(np.float32)
        frame_params = np.zeros((n, pa.shape[-1]), np.float32)
        for i, s in enumerate(starts):
            e = min(s + wsize, n)
            take = (e - s) if i == n_win - 1 else min(stride, e - s)
            frame_params[s:s + take] = pa[i, :take]
        out["frame_params"] = frame_params
    out.update(record_modes(kp, spec, cam, model64, cam64,
                            out["pcg40_stage1_shape"]))
    np.savez(path, **out)


def record_modes(kp, spec, cam, model64, cam64, shape1):
    """bench.py's BENCH_SINGLE=1 _GMM=1 recipe at BENCH_SINGLE_FRAMES=6 and
    its BENCH_STREAM loop at BENCH_STREAM_FRAMES=4, in the JAX package: the
    gate's keypoints as bench.py makes them (float32: ``spec``, ``cam``),
    then in float64 the prior-seeded start set, the GMM and the no-GMM fits
    from it and bench.py's residual of each (bench.py:686-835), and the
    online step driven frame by frame from the stage-1 shape ``shape1``
    (bench.py:513-545). -> dict of arrays."""
    import jax
    import jax.numpy as jnp

    from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
    from smpltpu.energy import make_skeleton_spec, skeleton_joints_cam
    from smpltpu.energy.params import init_frame_params
    from smpltpu.energy.reproj import project
    from smpltpu.io.gmm import load_pose_prior_txt
    from smpltpu.solve import (
        build_fitter,
        make_single_frame_problem,
        make_start_set,
    )
    from smpltpu.solve.online import OnlineConfig, build_online_step

    out = {}
    n_s = GATE_FRAMES
    gmm_d = load_pose_prior_txt(bench.PRIOR_PATH)
    rng_g = np.random.default_rng(11)
    c_kg = (-np.log(np.asarray(gmm_d["weights"]))
            + 0.5 * np.asarray(gmm_d["logdet_cov"]))
    top_g = int(np.argmin(c_kg))
    ell_g = np.linalg.cholesky(np.asarray(gmm_d["covs"], np.float64))[top_g]
    aa_g = (np.asarray(gmm_d["means"], np.float64)[top_g]
            + 0.3 * (ell_g @ rng_g.normal(size=(ell_g.shape[-1], n_s))).T)
    gt_g = np.zeros((n_s, 76), np.float32)
    gt_g[:, 0] = 1.0
    gt_g[:, 4:6] = rng_g.normal(size=(n_s, 2)) * 0.1
    gt_g[:, 6] = 3.2
    gt_g[:, 7:] = aa_g.astype(np.float32)
    uv_g = np.asarray(jax.jit(jax.vmap(
        lambda p: project(skeleton_joints_cam(
            p, jnp.zeros(10, jnp.float32), spec), cam)))(jnp.asarray(gt_g)))
    kp_s = np.zeros((n_s, N_KP_SLOTS, 4), np.float32)
    kp_s[:, :, 0] = USE_SMPL
    kp_s[:, :, 1:3] = uv_g[:, USE_SMPL] + rng_g.normal(
        size=(n_s, N_KP_SLOTS, 2)).astype(np.float32)
    kp_s[:, :, 3] = 1.0
    out["gate_kp"] = kp_s

    f64 = jnp.float64
    r0c = np.asarray(init_root_rotation(), np.float64)
    probs = {"gmm": make_single_frame_problem(
        model64, r0c, cam64, beta_pose=20.0, beta_shape=30.0, gmm_dict=gmm_d),
        "l2": make_single_frame_problem(model64, r0c, cam64, beta_pose=20.0,
                                        beta_shape=30.0)}
    starts = make_start_set(kp_s, probs["gmm"].spec, cam64,
                            pose_seeds=np.asarray(gmm_d["means"]))
    out["gate_starts"] = starts
    s_dim = starts.shape[1]
    x0 = jnp.asarray(starts.reshape(n_s * s_dim, -1), f64)
    kp_fit = jnp.asarray(np.repeat(kp_s, s_dim, axis=0), f64)
    for tag, prob in probs.items():
        st = build_fitter(prob, max_iters=100, dtype=f64)(x0, kp_fit)
        out[f"gate_{tag}_x"], out[f"gate_{tag}_cost"] = (
            np.asarray(st.x), np.asarray(st.cost))
        xs = np.asarray(st.x).reshape(n_s, s_dim, -1)
        cs = np.asarray(st.cost).reshape(n_s, s_dim)
        xb = jnp.asarray(xs[np.arange(n_s), np.argmin(cs, axis=1)])
        uv_s = np.asarray(jax.jit(jax.vmap(
            lambda p: project(skeleton_joints_cam(
                p, jnp.zeros(10, f64), prob.spec), cam64)))(xb))
        out[f"gate_{tag}_px"] = np.asarray(np.linalg.norm(
            uv_s[:, USE_SMPL] - kp_s[:, :, 1:3], axis=-1).mean())

    spec64 = make_skeleton_spec(model64, init_root_rotation(), with_shape=True)
    ocfg = OnlineConfig(beta_pose=5.0, lambda_temporal=3.0, max_iters=20)
    ostep = build_online_step(spec64, cam64, ocfg, model64.num_joints,
                              dtype=f64)
    kp_j = jnp.asarray(kp[:STREAM_FRAMES], f64)
    shp0 = jnp.asarray(shape1, f64)
    x_prev = jnp.asarray(init_frame_params(), f64)
    has_prev = jnp.asarray(0.0, f64)
    xs = []
    for i in range(STREAM_FRAMES):
        r = ostep(x_prev, shp0, kp_j[i], x_prev, has_prev)
        xs.append(np.asarray(r.x))
        x_prev, has_prev = r.x, jnp.asarray(1.0, f64)
    out["stream_x"] = np.stack(xs)
    for name, env in SINGLE_MODES.items():
        for k, v in _jax_single(env, kp[:MODE_FRAMES], model64, cam64,
                                gmm_d).items():
            out[f"single_{name}_{k}_px"] = np.asarray(v)
    return out


def _jax_single(env, kp_s, model64, cam64, gmm_d):
    """bench.py's BENCH_SINGLE (bench.py:649-813) in the JAX package,
    float64, in the sub-mode ``env`` selects, without the gate: ->
    {"single": the residual of each frame's best start, "adaptive": the
    adaptive start's, where it ran}."""
    import jax
    import jax.numpy as jnp

    from smpltpu.constants import USE_SMPL, init_root_rotation
    from smpltpu.energy import skeleton_joints_cam
    from smpltpu.energy.params import init_frame_params
    from smpltpu.energy.reproj import project
    from smpltpu.solve import (
        build_fitter,
        fit_adaptive,
        make_single_frame_problem,
        make_start_set,
    )
    from smpltpu.solve.lm import LMConfig

    f64 = jnp.float64
    n_s = len(kp_s)
    prob = make_single_frame_problem(
        model64, np.asarray(init_root_rotation(), np.float64), cam64,
        beta_pose=20.0, beta_shape=30.0,
        gmm_dict=gmm_d if env.get("BENCH_SINGLE_GMM") == "stress" else None)
    if env.get("BENCH_SINGLE_MULTISTART") == "1":
        starts = make_start_set(kp_s, prob.spec, cam64)
        s_dim = starts.shape[1]
        x0 = starts.reshape(n_s * s_dim, -1)
    else:
        s_dim = 1
        x0 = np.tile(np.asarray(init_frame_params(), np.float64), (n_s, 1))
    tr = env.get("BENCH_SINGLE_TR", "")
    tr_it = int(env.get("BENCH_SINGLE_TR_ITERS", "0"))
    lmcfg = None
    if tr or tr_it:
        lmcfg = LMConfig(max_iters=100, huber_delta=3.0, tr_solver=tr or "chol",
                         **({"tr_newton_iters": tr_it} if tr_it else {}))
    fitter = build_fitter(prob, max_iters=100, dtype=f64, lm_cfg=lmcfg)

    def px_of(x):
        uv = np.asarray(jax.jit(jax.vmap(lambda p: project(skeleton_joints_cam(
            p, jnp.zeros(10, f64), prob.spec), cam64)))(jnp.asarray(x, f64)))
        return float(np.linalg.norm(uv[:, USE_SMPL] - kp_s[:, :, 1:3],
                                    axis=-1).mean())
    px = {}
    if env.get("BENCH_SINGLE_ADAPTIVE") == "1":
        res = fit_adaptive(
            prob, kp_s, 100,
            px_thresh=float(env.get("BENCH_SINGLE_ADAPTIVE_PX", "6")),
            fitter=fitter, dtype=f64,
            orient=env.get("BENCH_SINGLE_ORIENT", "1") == "1",
            propagate=env.get("BENCH_SINGLE_PROPAGATE", "0") == "1")
        px["adaptive"] = px_of(res.x)
    st = fitter(jnp.asarray(x0, f64),
                jnp.asarray(np.repeat(kp_s, s_dim, axis=0), f64))
    xs = np.asarray(st.x).reshape(n_s, s_dim, -1)
    cs = np.asarray(st.cost).reshape(n_s, s_dim)
    px["single"] = px_of(xs[np.arange(n_s), np.argmin(cs, axis=1)])
    return px


def record_modes_only(path=GOLDEN):
    """``record_modes`` into ``path``, every other array kept."""
    import jax.numpy as jnp

    from smpltpu.constants import init_root_rotation
    from smpltpu.energy import make_skeleton_spec
    from smpltpu.models import SMPLModel, make_synthetic_model
    from smpltpu.utils import default_intrinsics

    out = {k: v for k, v in np.load(path).items()
           if not k.startswith(("gate_", "stream_"))}
    model = SMPLModel.from_dict(make_synthetic_model(), dtype=jnp.float32)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    model64 = SMPLModel.from_dict(make_synthetic_model(), dtype=jnp.float64)
    out.update(record_modes(out["kp"], spec, default_intrinsics(720, 1280),
                            model64, default_intrinsics(720, 1280,
                                                        dtype=jnp.float64),
                            out["pcg40_stage1_shape"]))
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_bench --record: rewrite the recorded JAX
    # results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] == ["--record-modes"]:
        # only the gate's and the stream's arrays, the rest kept as it is
        record_modes_only()
    elif sys.argv[1:] == ["--record"]:
        record()
    else:
        raise SystemExit("usage: python -m tests.test_torch_bench "
                         "--record | --record-modes")
