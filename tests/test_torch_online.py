"""The port's online (streaming) fit (``smpltpu_torch/solve/online.py``) and
``fit_adaptive(propagate=True)`` against the JAX package on the CPU in
float64.

The keypoints are projected from a smoothly drifting pose with a shape
(data, locked) and 1 px of noise. With the scale frozen (the online
default) the port follows the reference's trajectory: parameters held to
1e-9, costs to 1e-10 relative, trips and convergence exactly. A free scale
leaves the null direction (s, t) -> (a s, a t) of the single-frame
objective, along which each package's steps carry their own rounding
(``tests/test_torch_single.py``): there the costs are held to 2e-6 and the
gauge-free parameters (t / s) to 2e-3. On the CPU the trip graph's loop
(``OnlineGraph``) runs the functions of ``lm_solve`` eagerly, so it and the
pump built on it equal the eager step bit for bit.

The frozen-scale step and the scan run the JAX package live. The other
reference results (the GMM and free-scale steps, the fitter's step
sequence that the pump is held to, ``calibrate`` and the replay after it,
``fit_adaptive(propagate=True)``) are read from ``tests/data/online_jax_ref.npz``, which
``python -m tests.test_torch_online --record`` writes by running the JAX
functions on the same inputs: each costs seconds of XLA compilation on the
CPU, and the suite's time limit has no room for all of them.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smpltpu.solve.init as j_init
import smpltpu.solve.online as j_online
from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu.energy import GMMPrior as JGMM
from smpltpu.energy import make_skeleton_spec as j_spec
from smpltpu.models import SMPLModel as JModel
from smpltpu.models.synthetic import make_synthetic_model
from smpltpu.solve import build_fitter as j_build_fitter
from smpltpu.solve import make_single_frame_problem as j_problem
from smpltpu.utils import default_intrinsics as j_intrinsics
from smpltpu_torch.energy import project, skeleton_joints_cam
from smpltpu_torch.energy.priors import GMMPrior
from smpltpu_torch.energy.reproj import make_skeleton_spec
from smpltpu_torch.models import SMPLModel, make_synthetic_gmm
from smpltpu_torch.solve import init as t_init
from smpltpu_torch.solve import online as t_online
from smpltpu_torch.solve.lm import LMState
from smpltpu_torch.solve.single_frame import build_fitter, make_single_frame_problem
from smpltpu_torch.utils import default_intrinsics
from tests.test_torch_single import _gauge_free

F64 = torch.float64
N_STREAM = 10
CFG = dict(beta_pose=5.0, lambda_temporal=3.0, max_iters=20)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "online_jax_ref.npz")
BAND_THRESH = (2.0, 1e9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keypoints(spec, cam, params, shape, rng):
    """(F, 17, 4) keypoints of params (F, P) under ``shape``, 1 px noise."""
    uv = project(skeleton_joints_cam(torch.as_tensor(params),
                                     torch.as_tensor(shape), spec),
                 cam).numpy()
    kp = np.zeros((len(params), N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(size=(len(params),
                                                       N_KP_SLOTS, 2))
    kp[:, :, 3] = 1.0
    return kp


def _make_rig(small_model_dict, gmm_prior):
    jm = JModel.from_dict(small_model_dict, dtype=jnp.float64)
    tm = SMPLModel.from_dict(small_model_dict, device="cpu", dtype=F64)
    jcam = j_intrinsics(720, 1280, dtype=jnp.float64)
    tcam = default_intrinsics(720, 1280, device="cpu", dtype=F64)
    r0 = init_root_rotation()
    jspec, tspec = j_spec(jm, r0, True), make_skeleton_spec(tm, r0, True)
    rng = np.random.default_rng(21)
    gt = np.zeros((N_STREAM, 76))
    gt[:, 0] = 1.0
    gt[:, 1:4] = 0.1 * rng.normal(size=3) + 0.01 * np.arange(N_STREAM)[:, None]
    gt[:, 4:7] = [0.1, -0.1, 3.2]
    gt[:, 7:] = (0.15 * rng.normal(size=69)
                 + 0.01 * np.arange(N_STREAM)[:, None] * rng.normal(size=69))
    shape = 0.3 * rng.normal(size=10)
    kp = _keypoints(tspec, tcam, gt, shape, rng)
    jgmm = JGMM.from_dict(gmm_prior, beta=5.0, dtype=jnp.float64)
    return dict(jm=jm, tm=tm, jcam=jcam, tcam=tcam, jspec=jspec, tspec=tspec,
                gt=gt, shape=shape, kp=kp, jgmm=jgmm,
                tgmm=GMMPrior.from_jax(jgmm, device="cpu", dtype=F64),
                gmm_dict=gmm_prior)


@pytest.fixture(scope="module")
def rig(small_model_dict, gmm_prior):
    return _make_rig(small_model_dict, gmm_prior)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


STEP_CASES = {"frozen": dict(freeze_scale=True),
              "gmm": dict(freeze_scale=True),
              "free_scale": dict(freeze_scale=False)}


def _step_inputs(rig):
    """Two frames, the first of a stream (has_prev 0, from the init) and a
    tethered one (has_prev 1, from the previous frame's pose nudged)."""
    rng = np.random.default_rng(3)
    prev = np.stack([np.r_[1.0, 0, 0, 0, 0, 0, 3.0, np.zeros(69)],
                     rig["gt"][3] + 0.02 * rng.normal(size=76)])
    prev[1, 0] = 1.0
    return prev, np.array([0.0, 1.0]), rig["kp"][[0, 4]]


def _jax_step(rig, case):
    """The JAX step on each of the two frames: {x, cost, iters, conv,
    hist}, stacked."""
    step = j_online.build_online_step(
        rig["jspec"], rig["jcam"],
        j_online.OnlineConfig(**dict(CFG, **STEP_CASES[case])), 24,
        gmm=rig["jgmm"] if case == "gmm" else None, dtype=jnp.float64)
    prev, has, kp = _step_inputs(rig)
    outs = [step(jnp.asarray(prev[i]), jnp.asarray(rig["shape"]),
                 jnp.asarray(kp[i]), jnp.asarray(prev[i]),
                 jnp.asarray(has[i])) for i in range(2)]
    return {k: np.stack([np.asarray(getattr(o, f)) for o in outs])
            for k, f in (("x", "x"), ("cost", "cost"), ("iters", "iters_run"),
                         ("conv", "converged"), ("hist", "cost_history"))}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_online_step_matches_reference(rig, golden, case):
    """The two frames in one batch against the JAX step on each (live for
    the frozen case, recorded for the others)."""
    want = (_jax_step(rig, case) if case == "frozen"
            else {k[len(f"step_{case}_"):]: v for k, v in golden.items()
                  if k.startswith(f"step_{case}_")})
    step = t_online.build_online_step(
        rig["tspec"], rig["tcam"],
        t_online.OnlineConfig(**dict(CFG, **STEP_CASES[case])), 24,
        gmm=rig["tgmm"] if case == "gmm" else None, device="cpu", dtype=F64)
    prev, has, kp = _step_inputs(rig)
    got = step(prev, rig["shape"], kp, prev, has)
    x = got.x.numpy()
    if case == "free_scale":
        np.testing.assert_allclose(got.cost.numpy(), want["cost"], rtol=2e-6)
        np.testing.assert_allclose(_gauge_free(x), _gauge_free(want["x"]),
                                   atol=2e-3)
        return
    np.testing.assert_allclose(x, want["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.cost.numpy(), want["cost"], rtol=1e-10)
    np.testing.assert_array_equal(got.iters_run.numpy(), want["iters"])
    np.testing.assert_array_equal(got.converged.numpy(), want["conv"])
    np.testing.assert_allclose(got.cost_history.numpy(), want["hist"],
                               rtol=1e-10)


def _port_step(rig, cfg_kw):
    return t_online.build_online_step(
        rig["tspec"], rig["tcam"], t_online.OnlineConfig(**dict(CFG, **cfg_kw)),
        24, device="cpu", dtype=F64)


def test_untethered_step_is_the_single_frame_solve(rig):
    """lambda_temporal = 0 with a tethered frame: the tether rows are zero
    (residual and Jacobian), so the step is the port's pose-only
    single-frame solve at zero shape, trip for trip."""
    t_step = _port_step(rig, dict(lambda_temporal=0.0, max_iters=40))
    prob = make_single_frame_problem(
        rig["tm"], init_root_rotation(), rig["tcam"], beta_pose=5.0,
        freeze_scale=True)
    x0 = torch.as_tensor(rig["gt"][2:3] + 0.05)
    kp = torch.as_tensor(rig["kp"][2:3])
    got = t_step(x0, torch.zeros(10, dtype=F64), kp, x0 - 0.3,
                 torch.ones(1, dtype=F64))
    want = build_fitter(prob, 40, device="cpu", dtype=F64)(x0, kp)
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.cost.numpy(), want.cost.numpy(),
                               rtol=1e-12)
    assert torch.equal(got.iters_run, want.iters_run)
    assert torch.equal(got.converged, want.converged)


@pytest.mark.parametrize("gmm", [False, True], ids=["l2", "gmm"])
def test_tether_and_prior_jacobian_match_jacfwd(rig, gmm):
    """The plain rows' Jacobian (prior, then tether) and the keypoint
    blocks' against ``torch.func.jacfwd`` of the residual, per problem,
    with has_prev 0 and 1 in one batch."""
    prob = t_online._online_problem(
        rig["tspec"], rig["tcam"], t_online.OnlineConfig(**CFG), 24,
        rig["tgmm"] if gmm else None, device="cpu", dtype=F64)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rig["gt"][:2] + 0.05 * rng.normal(size=(2, 76)))
    prev = torch.as_tensor(rig["gt"][:2])
    fn = prob.residual_of(torch.as_tensor(rig["shape"]),
                          torch.as_tensor(rig["kp"][:2]), prev,
                          torch.tensor([0.0, 1.0], dtype=F64))
    rb, rp, jb, jp = fn(x, True)
    rb0, rp0, _, _ = fn(x, False)
    assert torch.equal(rb, rb0) and torch.equal(rp, rp0)
    assert rp.shape == (2, (70 if gmm else 69) + 76)
    for i in range(2):
        def plain(xi):
            return fn(xi[None].expand(2, -1), False)[1][i]

        def blocks(xi):
            return fn(xi[None].expand(2, -1), False)[0][i]
        np.testing.assert_allclose(jp[i].numpy(),
                                   torch.func.jacfwd(plain)(x[i]).numpy(),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(jb[i].numpy(),
                                   torch.func.jacfwd(blocks)(x[i]).numpy(),
                                   rtol=1e-7, atol=1e-7)
    # the first problem has no previous frame: its tether rows vanish
    assert not rp[0, -76:].any() and not jp[0, -76:].any()
    tmask = torch.ones(76, dtype=F64)
    tmask[0] = 0.0
    torch.testing.assert_close(jp[1, -76:], 3.0 * torch.diag(tmask))


def _stream_kp(rig):
    """The stream with two empty frames, the first one and one inside."""
    kp = rig["kp"].copy()
    kp[[0, 5], :, 1:] = 0.0
    return kp


def test_scan_matches_reference(rig):
    kp = _stream_kp(rig)
    cfg = dict(CFG, max_iters=15)
    x0 = np.r_[1.0, 0, 0, 0, 0, 0, 3.0, np.zeros(69)]
    want = j_online.build_online_scan(
        rig["jspec"], rig["jcam"], j_online.OnlineConfig(**cfg), 24,
        dtype=jnp.float64)(jnp.asarray(x0), jnp.asarray(rig["shape"]),
                           jnp.asarray(kp), 0.0)
    got = t_online.build_online_scan(
        rig["tspec"], rig["tcam"], t_online.OnlineConfig(**cfg), 24,
        device="cpu", dtype=F64)(x0, rig["shape"], kp, 0.0)
    xs, costs, iters, solved, conv = (a.numpy() for a in got)
    np.testing.assert_array_equal(solved, np.asarray(want[3]))
    assert not solved[0] and not solved[5] and solved.sum() == N_STREAM - 2
    np.testing.assert_array_equal(xs[0], x0)           # held from x0
    np.testing.assert_array_equal(xs[5], xs[4])        # held from frame 4
    assert costs[5] == 0.0 and iters[5] == 0 and not conv[5]
    np.testing.assert_allclose(xs, np.asarray(want[0]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(costs, np.asarray(want[1]), rtol=1e-10)
    np.testing.assert_array_equal(iters, np.asarray(want[2]))
    np.testing.assert_array_equal(conv, np.asarray(want[4]))
    assert iters.dtype == np.int32


def test_graph_loop_equals_lm_solve_bitwise(rig):
    """The trip graph's CPU loop and the eager ``lm_solve`` of the step:
    the same state, bit for bit, for a first and a tethered frame and at a
    trip budget that ends before convergence."""
    spec, cam = rig["tspec"], rig["tcam"]
    for max_iters, has in ((20, 0.0), (20, 1.0), (2, 1.0)):
        cfg = t_online.OnlineConfig(**dict(CFG, max_iters=max_iters))
        graph = t_online.OnlineGraph(spec, cam, cfg, 24, device="cpu",
                                     dtype=F64)
        step = t_online.build_online_step(spec, cam, cfg, 24, device="cpu",
                                          dtype=F64)
        prev = torch.as_tensor(rig["gt"][5:6] + 0.03)
        graph.set_start(prev[0], rig["shape"], has)
        graph.kp.copy_(torch.as_tensor(rig["kp"][6:7]))
        trips = graph.solve()
        want = step(prev, rig["shape"], rig["kp"][6:7], prev,
                    torch.full((1,), has, dtype=F64))
        assert trips == int(want.iters_run[0]) == graph.trips
        for name in LMState._fields:
            assert torch.equal(getattr(graph.state, name),
                               getattr(want, name)), name
    assert trips == 2


CALIB = dict(max_iters=30, beta_shape=5.0)


def _jax_calibrate(rig):
    """The JAX fitter's calibrate on the first four frames, then its replay
    over the whole stream (two empty frames)."""
    fit = j_online.OnlineFitter(rig["jm"], rig["jcam"],
                                j_online.OnlineConfig(**CFG),
                                dtype=jnp.float64)
    params = fit.calibrate(rig["kp"][:4], **CALIB)
    shape = np.asarray(fit.shape)
    xs, solved, costs, iters, conv = fit.replay(_stream_kp(rig))
    return dict(params=params, shape=shape, xs=xs, solved=solved,
                costs=costs, iters=iters, conv=conv)


def test_calibrate_matches_reference(rig, golden):
    """calibrate (the multi-frame fitter, tridiag) and the replay after it
    against the JAX fitter's (recorded), at tridiag's tolerances."""
    want = {k[len("calib_"):]: v for k, v in golden.items()
            if k.startswith("calib_")}
    fit = t_online.OnlineFitter(rig["tm"], rig["tcam"],
                                t_online.OnlineConfig(**CFG), device="cpu",
                                dtype=F64)
    got = fit.calibrate(rig["kp"][:4], **CALIB)
    np.testing.assert_allclose(got, want["params"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(fit.shape.numpy(), want["shape"], rtol=0,
                               atol=1e-8)
    assert fit.has_prev == 1.0 and fit.n_seen == 4
    assert fit.last_calib_ms > 0.0
    assert torch.equal(fit.prev, torch.as_tensor(got[-1]))
    kp = _stream_kp(rig)
    xs, solved, costs, iters, conv = fit.replay(kp)
    np.testing.assert_array_equal(solved, want["solved"])
    np.testing.assert_array_equal(iters, want["iters"])
    np.testing.assert_array_equal(conv, want["conv"])
    np.testing.assert_allclose(xs, want["xs"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(costs, want["costs"], rtol=1e-9)
    assert torch.equal(fit.prev, torch.as_tensor(xs[-1]))
    assert fit.n_seen == 4 + len(kp)


def _jax_step_sequence(rig):
    """The JAX fitter's step over the stream, frame by frame: {x, cost,
    iters, solved} stacked (cost and iters 0 on a held frame)."""
    fit = j_online.OnlineFitter(rig["jm"], rig["jcam"],
                                j_online.OnlineConfig(**CFG),
                                dtype=jnp.float64)
    outs = [fit.step(k) for k in _stream_kp(rig)]
    return dict(x=np.stack([x for x, _ in outs]),
                cost=np.array([0.0 if r is None else float(r.cost)
                               for _, r in outs]),
                iters=np.array([0 if r is None else int(r.iters_run)
                                for _, r in outs]),
                solved=np.array([r is not None for _, r in outs]))


def test_pump_matches_step(rig, golden):
    """The pump against the port's step sequence bit for bit (start, a
    stop that leaves the end state, a second stop, a restart) and against
    the JAX fitter's step sequence (recorded) at the step's tolerance;
    submit before start raises."""
    kp = _stream_kp(rig)
    want = {k[len("steps_"):]: v for k, v in golden.items()
            if k.startswith("steps_")}
    loop = t_online.OnlineFitter(rig["tm"], rig["tcam"],
                                 t_online.OnlineConfig(**CFG), device="cpu",
                                 dtype=F64)
    steps = [loop.step(k) for k in kp]
    fit = t_online.OnlineFitter(rig["tm"], rig["tcam"],
                                t_online.OnlineConfig(**CFG), device="cpu",
                                dtype=F64)
    pump = fit.make_pump()
    with pytest.raises(RuntimeError, match="pump not started"):
        pump.submit(kp[1])
    pump.start(fit.prev, fit.shape, fit.has_prev)
    out = [pump.submit(k) for k in kp[:6]]
    pump.stop()
    pump.stop()
    np.testing.assert_array_equal(pump.prev, out[-1][0])
    assert pump.has_prev == 1.0
    pump.start(pump.prev, fit.shape, pump.has_prev)
    out += [pump.submit(k) for k in kp[6:]]
    pump.stop()
    np.testing.assert_array_equal([o[3] for o in out], want["solved"])
    np.testing.assert_array_equal([o[2] for o in out], want["iters"])
    np.testing.assert_allclose(np.stack([o[0] for o in out]), want["x"],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose([o[1] for o in out], want["cost"], rtol=1e-10)
    for (x, cost, iters, solved), (sx, res) in zip(out, steps):
        assert solved == (res is not None)
        np.testing.assert_array_equal(x, sx)
        if solved:
            assert cost == float(res.cost[0])
            assert iters == int(res.iters_run[0])
        else:
            assert (cost, iters) == (0.0, 0)
    np.testing.assert_array_equal(out[0][0],
                                  np.r_[1.0, 0, 0, 0, 0, 0, 3.0, np.zeros(69)])
    np.testing.assert_array_equal(out[5][0], out[4][0])
    np.testing.assert_array_equal(pump.prev, steps[-1][0])


def _band_rig(model_dict, jax_problem=False):
    """tests/test_adaptive.py::band_rig rebuilt: a smooth amplitude ramp
    whose tail no static start reaches at 8 trips, each frame in its
    neighbour's basin. Here with the scale frozen and a pose prior
    (beta_pose 1): the reference's rig has neither, and its 69 joint angles
    against 34 keypoint rows leave null directions along which 8 trips end
    wherever each package's rounding puts them (the free scale is one more,
    module docstring). So posed, the band stays hard (frames 8-11 at 2 px)
    and the two packages' trajectories agree. The small model has the full
    one's skeleton. -> (port problem, keypoints[, JAX problem])."""
    tm = SMPLModel.from_dict(model_dict, device="cpu", dtype=F64)
    tcam = default_intrinsics(720, 1280, device="cpu", dtype=F64)
    tp = make_single_frame_problem(tm, init_root_rotation(), tcam,
                                   beta_pose=1.0, freeze_scale=True)
    rng = np.random.default_rng(17)
    f_dim = 12
    gt = np.tile(np.r_[1.0, 0, 0, 0, 0, 0, 3.0, np.zeros(69)], (f_dim, 1))
    axis = rng.normal(size=3)
    axis = axis / np.linalg.norm(axis)
    joint_dir = rng.normal(size=69)
    joint_dir = joint_dir / np.abs(joint_dir).max()
    amp = np.linspace(0.0, 1.0, f_dim)
    gt[:, 1:4] = axis * (2.4 * amp)[:, None]
    gt[:, 7:] = joint_dir[None] * (0.85 * amp)[:, None]
    uv = project(skeleton_joints_cam(torch.as_tensor(gt),
                                     torch.zeros(10, dtype=F64), tp.spec),
                 tcam).numpy()
    kp = np.zeros((f_dim, N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL]
    kp[:, :, 3] = 1.0
    if not jax_problem:
        return tp, kp
    jm = JModel.from_dict(model_dict, dtype=jnp.float64)
    jp = j_problem(jm, init_root_rotation(),
                   j_intrinsics(720, 1280, dtype=jnp.float64), beta_pose=1.0,
                   freeze_scale=True, dtype=jnp.float64)
    return tp, kp, jp


BAND_ITERS, BAND_PROPAGATE_ITERS = 8, 10
BAND_KEYS = ("hard_idx", "escalated", "cost", "px", "x", "converged",
             "iters_run")


def _jax_band(model_dict, thresh):
    _, kp, jp = _band_rig(model_dict, jax_problem=True)
    res = j_init.fit_adaptive(
        jp, kp, BAND_ITERS, px_thresh=thresh, dtype=jnp.float64,
        propagate=True, propagate_iters=BAND_PROPAGATE_ITERS,
        fitter=j_build_fitter(jp, max_iters=BAND_ITERS, dtype=jnp.float64))
    return {k: np.asarray(getattr(res, k)) for k in BAND_KEYS}


@pytest.mark.parametrize("thresh", BAND_THRESH, ids=["band", "nothing_hard"])
def test_fit_adaptive_propagate_matches_reference(small_model_dict, golden,
                                                  thresh):
    """fit_adaptive(propagate=True) against the JAX function's (recorded)."""
    want = {k: golden[f"band_{thresh:g}_{k}"] for k in BAND_KEYS}
    tp, kp = _band_rig(small_model_dict)
    got = t_init.fit_adaptive(tp, kp, BAND_ITERS, px_thresh=thresh,
                              dtype=F64, propagate=True,
                              propagate_iters=BAND_PROPAGATE_ITERS)
    np.testing.assert_array_equal(got.hard_idx, want["hard_idx"])
    np.testing.assert_array_equal(got.escalated, want["escalated"])
    if thresh > 1e8:
        assert got.hard_idx.size == 0 and not got.escalated.any()
    else:
        # the workload is band-hard and phase P clears it
        assert got.hard_idx.size >= 3 and got.escalated.any()
        assert (got.px > thresh).sum() == 0
    # fit_adaptive's tolerances of tests/test_torch_single.py; frame 0 is
    # the rest pose, fitted exactly: its cost is rounding (~1e-26), and so
    # is the trip at which ftol stops it (5 or 8)
    np.testing.assert_allclose(got.cost, want["cost"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.px, want["px"], rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got.x, want["x"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.converged, want["converged"])
    np.testing.assert_array_equal(got.iters_run[1:], want["iters_run"][1:])


def record(path=GOLDEN):
    """Run the JAX functions of the recorded cases on this file's inputs and
    write ``path``."""
    model_dict = make_synthetic_model(n_verts=300, n_shapes=10, seed=0)
    rig = _make_rig(model_dict, make_synthetic_gmm(n_comps=8, dim=69, seed=0))
    out = {}
    for case in ("gmm", "free_scale"):
        out.update({f"step_{case}_{k}": v
                    for k, v in _jax_step(rig, case).items()})
    out.update({f"calib_{k}": v for k, v in _jax_calibrate(rig).items()})
    out.update({f"steps_{k}": v for k, v in _jax_step_sequence(rig).items()})
    for thresh in BAND_THRESH:
        out.update({f"band_{thresh:g}_{k}": v
                    for k, v in _jax_band(model_dict, thresh).items()})
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_online --record: rewrite the recorded
    # reference results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_online --record")
    record()
