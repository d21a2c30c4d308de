"""The port's LM engine (``smpltpu_torch/solve/lm.py``), its Jacobian and
the priors and helpers under it, against the JAX package on the CPU in
float64.

The problems are single-frame fits of the 300-vertex model to keypoints
projected from a known pose with 1 px of noise, from the reference init.
``lm_solve`` is compared on gauge-fixed problems (``freeze_scale``): with
a free scale the single-frame objective has an exact null direction,
(s, t) -> (a s, a t) (projection is invariant to a uniform scaling about
the camera centre; ``test_scale_gauge_is_a_null_direction``), and the
chol and dogleg steps' components along it are rounding noise divided by
the 30 eps floor shift. Their trajectories then follow the rounding of
each implementation: measured, the reference alone moves its optimum by
up to 2 in the parameters when its starts change by 1e-15 relative. With
the gauge fixed, port and reference agree to 1e-13 in x over 30 trips,
so the state after one and five trips is held to 1e-10 (the radius,
which grows to 1e16 on the damped path, relative to its size).

Priors and helpers are closed-form functions of their inputs: 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smpltpu.energy.priors as j_priors
import smpltpu.energy.robust as j_robust
import smpltpu.energy.temporal as j_temporal
import smpltpu.solve.lm as j_lm
import smpltpu_torch.energy.priors as t_priors
import smpltpu_torch.solve.lm as t_lm
from smpltpu.constants import USE_SMPL, init_root_rotation
from smpltpu.energy import make_skeleton_spec as j_spec
from smpltpu.energy import skeleton_joints_cam as j_joints
from smpltpu.energy.reproj import project as j_project
from smpltpu.models import SMPLModel as JModel
from smpltpu.solve import build_fitter as j_build_fitter
from smpltpu.solve import make_single_frame_problem as j_problem
from smpltpu.utils import default_intrinsics as j_intrinsics
from smpltpu_torch.energy.robust import huber_block_weights
from smpltpu_torch.energy.temporal import temporal_residuals
from smpltpu_torch.models import SMPLModel
from smpltpu_torch.solve.single_frame import (
    _bounds_and_frozen,
    _residual_fn,
    make_single_frame_problem,
)
from smpltpu_torch.utils import default_intrinsics

F64 = torch.float64
ATOL = 1e-10
N_FRAMES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small LAPACK calls: one thread a process under the suite's
    parallel workers (see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_keypoints(jm, jcam, rng, n_frames):
    """(F, 17, 4) keypoints of known poses near the reference init, 1 px
    of noise."""
    spec = j_spec(jm, init_root_rotation(), with_shape=False)
    gt = np.zeros((n_frames, 76))
    gt[:, 0] = 1.0
    gt[:, 1:4] = 0.1 * rng.normal(size=(n_frames, 3))
    gt[:, 4:7] = [0.1, -0.1, 3.2]
    gt[:, 7:] = 0.15 * rng.normal(size=(n_frames, 69))
    uv = np.stack([np.asarray(j_project(j_joints(jnp.asarray(g),
                                                 jnp.zeros(10), spec), jcam))
                   for g in gt])
    kp = np.zeros((n_frames, 17, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(size=(n_frames, 17, 2))
    kp[:, :, 3] = 1.0
    return kp


@pytest.fixture(scope="module")
def rig(small_model_dict, gmm_prior):
    jm = JModel.from_dict(small_model_dict, dtype=jnp.float64)
    tm = SMPLModel.from_dict(small_model_dict, device="cpu", dtype=F64)
    jcam = j_intrinsics(720, 1280, dtype=jnp.float64)
    tcam = default_intrinsics(720, 1280, device="cpu", dtype=F64)
    kp = make_keypoints(jm, jcam, np.random.default_rng(7), N_FRAMES)
    x0 = np.zeros((N_FRAMES, 76))
    x0[:, 0], x0[:, 6] = 1.0, 3.0

    def problems(**kw):
        return (j_problem(jm, init_root_rotation(), jcam, beta_pose=2.0,
                          dtype=jnp.float64, **kw),
                make_single_frame_problem(tm, init_root_rotation(), tcam,
                                          beta_pose=2.0, **kw))
    return dict(jm=jm, tm=tm, jcam=jcam, tcam=tcam, kp=kp, x0=x0,
                gmm=gmm_prior, problems=problems)


def _solve(prob, x0, kp, cfg):
    """The port's lm_solve on the single-frame problem, bounds and frozen
    dims as build_fitter passes them."""
    lower, upper, frozen = _bounds_and_frozen(prob, device="cpu", dtype=F64)
    kp_t = torch.as_tensor(kp)
    return t_lm.lm_solve(lambda x, jac: _residual_fn(prob, kp_t, x, jac),
                         torch.as_tensor(x0), cfg, lower, upper, frozen)


def assert_state_matches(got, want, atol=ATOL):
    for name in ("x", "cost", "decrease_factor", "cost_history"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=atol, atol=atol, err_msg=name)
    np.testing.assert_allclose(got.radius.numpy(), np.asarray(want.radius),
                               rtol=atol, err_msg="radius")
    for name in ("converged", "n_accepted", "iters_run"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("trips", [1, 5])
@pytest.mark.parametrize("solver", ["chol", "eigh", "dogleg", "damped"])
def test_lm_solve_matches_reference(rig, solver, trips):
    """Every step rule after one and five trips, on the gauge-fixed
    pose-only problem (module docstring)."""
    jp, tp = rig["problems"](freeze_scale=True)
    kw = (dict(exact_tr=False) if solver == "damped"
          else dict(tr_solver=solver))
    want = j_build_fitter(jp, trips, dtype=jnp.float64,
                          lm_cfg=j_lm.LMConfig(max_iters=trips, **kw))(
        jnp.asarray(rig["x0"]), jnp.asarray(rig["kp"]))
    got = _solve(tp, rig["x0"], rig["kp"], t_lm.LMConfig(max_iters=trips, **kw))
    assert got.cost_history.shape == (N_FRAMES, trips)
    assert_state_matches(got, want)


def test_lm_state_from_numpy(rig):
    """The carry-over of a reference state: dtypes by field, values
    exact."""
    jp, tp = rig["problems"](freeze_scale=True)
    want = j_build_fitter(jp, 5, dtype=jnp.float64,
                          lm_cfg=j_lm.LMConfig(max_iters=5))(
        jnp.asarray(rig["x0"]), jnp.asarray(rig["kp"]))
    res = t_lm.LMResult.from_numpy(want, device="cpu", dtype=F64)
    st = t_lm.LMState.from_numpy(want[:7], device="cpu", dtype=F64)
    assert_state_matches(res, want, atol=0)
    assert st.converged.dtype == torch.bool and st.iters_run.dtype == torch.int32
    assert st.x.dtype == F64 and len(st) == 7
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(want.x))


def test_corrected_jacobian_matches_jacfwd(rig):
    """The LM's Jacobian of the Huber-corrected residual, assembled from
    the analytic keypoint Jacobian, the weight's closed-form slope and the
    prior rows, against ``torch.func.jacfwd`` of the corrected residual:
    pose+shape with the L2 prior and the GMM prior, far enough from the
    keypoints that most blocks sit in Huber's outer branch."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rig["x0"], 0.3 * rng.normal(size=(N_FRAMES, 10))], -1)
    x[:, 7:76] = 0.3 * rng.normal(size=(N_FRAMES, 69))
    x[:, 4:6] = 0.2 * rng.normal(size=(N_FRAMES, 2))
    kp = torch.as_tensor(rig["kp"])
    for kw in (dict(opt_shape=True, beta_shape=5.0),
               dict(gmm_dict=rig["gmm"])):
        _, tp = rig["problems"](**kw)
        xt = torch.as_tensor(x if tp.opt_shape else x[:, :76])

        def fn(v, jac):
            return _residual_fn(tp, kp, v, jac)

        r, jac = t_lm.corrected_residual_and_jacobian(fn, xt, 3.0)

        def corrected(v):
            rb, rp, _, _ = fn(v, False)
            w = t_lm.huber_correct_weight(torch.sum(rb * rb, -1), 3.0)
            return torch.cat([(rb * w[..., None]).flatten(1), rp], -1)

        full = torch.func.jacfwd(corrected)(xt)          # (N, R, N, P)
        want = torch.stack([full[i, :, i] for i in range(N_FRAMES)])
        torch.testing.assert_close(r, corrected(xt), rtol=0, atol=1e-12)
        torch.testing.assert_close(jac, want, rtol=1e-10, atol=1e-8)


def test_scale_gauge_is_a_null_direction(rig):
    """Projection is invariant to (s, t) -> (a s, a t): the keypoint
    Jacobian maps that direction to ~0, which is why the free-scale
    trajectories are held up to the gauge (module docstring)."""
    _, tp = rig["problems"]()
    x = torch.as_tensor(rig["x0"])
    _, _, jb, _ = _residual_fn(tp, torch.as_tensor(rig["kp"]), x, True)
    n = torch.zeros_like(x)
    n[:, 0], n[:, 4:7] = x[:, 0], x[:, 4:7]
    along = (jb.flatten(1, 2) @ n[..., None])[..., 0]
    assert float(along.abs().max()) < 1e-9 * float(jb.abs().max())


def _spd(rng, p, n, lam_min=0.5):
    a = rng.normal(size=(n, p, p))
    return a @ a.transpose(0, 2, 1) + lam_min * np.eye(p)


def test_chol_tr_step_interior_boundary_and_not_pd():
    """Interior: the floor-shifted Newton step. Boundary: the exact
    More-Sorensen step to the accuracy of four Newton trips (its length
    within 2 % of the radius, the eigh step within 2 % of its length).
    Not positive definite: NaN, with the boundary flag set."""
    rng = np.random.default_rng(0)
    p, n = 12, 3
    h = torch.as_tensor(_spd(rng, p, n))
    g = torch.as_tensor(rng.normal(size=(n, p)))
    newton = -torch.linalg.solve(h, g)
    big = 10.0 * torch.linalg.vector_norm(newton, dim=-1)
    step, boundary = t_lm.chol_tr_step(h, g, big, 4)
    assert not boundary.any()
    torch.testing.assert_close(step, newton, rtol=1e-12, atol=1e-12)

    radius = 0.1 * torch.linalg.vector_norm(newton, dim=-1)
    step, boundary = t_lm.chol_tr_step(h, g, radius, 4)
    exact, b_exact = t_lm.eigh_tr_step(h, g, radius)
    assert boundary.all() and b_exact.all()
    length = torch.linalg.vector_norm(step, dim=-1)
    assert float(((length - radius) / radius).abs().max()) < 0.02
    assert float(torch.linalg.vector_norm(step - exact, dim=-1).max()
                 / radius.min()) < 0.02

    bad = h - 50.0 * torch.eye(p, dtype=F64)
    step, boundary = t_lm.chol_tr_step(bad, g, radius, 4)
    assert torch.isnan(step).all() and boundary.all()


def test_not_pd_step_is_rejected(rig, monkeypatch):
    """A trip whose factorization fails takes no step: the state is kept,
    the trip counted and nothing accepted."""
    _, tp = rig["problems"](freeze_scale=True)
    real = t_lm.chol_tr_step

    def indefinite(h, g, radius, iters):
        eye = torch.eye(h.shape[-1], dtype=h.dtype)
        return real(h - 1e9 * eye, g, radius, iters)
    monkeypatch.setattr(t_lm, "chol_tr_step", indefinite)
    st = _solve(tp, rig["x0"], rig["kp"], t_lm.LMConfig(max_iters=1))
    np.testing.assert_array_equal(st.x.numpy(), rig["x0"])
    assert (st.n_accepted == 0).all() and (st.iters_run == 1).all()
    assert torch.isfinite(st.cost).all() and (st.radius == 1.0).all()


def test_frozen_dims_and_bounds(rig):
    """Frozen dims (the pose-only path's joints 10/11/22/23 and, with
    freeze_scale, the scale) keep their start exactly; a bound that binds
    holds every trip's iterate (projection) and is reached."""
    _, tp = rig["problems"](freeze_scale=True)
    lower, upper, frozen = _bounds_and_frozen(tp, device="cpu", dtype=F64)
    assert int(frozen.sum()) == 1 + 4 * 3
    upper = upper.clone()
    upper[6] = 3.05              # the fits want depth ~3.2
    kp_t = torch.as_tensor(rig["kp"])
    st = t_lm.lm_solve(lambda x, jac: _residual_fn(tp, kp_t, x, jac),
                       torch.as_tensor(rig["x0"]), t_lm.LMConfig(max_iters=20),
                       lower, upper, frozen)
    x = st.x.numpy()
    np.testing.assert_array_equal(x[:, frozen.numpy()],
                                  rig["x0"][:, frozen.numpy()])
    assert (x[:, 6] <= 3.05).all() and np.isclose(x[:, 6], 3.05).any()
    assert (st.n_accepted > 0).all()


def test_gmm_prior_matches_reference(rig):
    """GMMPrior.from_dict and from_jax, the residual with its hard
    assignment and the closed-form Jacobian against jax.jacfwd, batched,
    at points near several components."""
    gd = rig["gmm"]
    jg = j_priors.GMMPrior.from_dict(gd, beta=3.0, dtype=jnp.float64)
    tg = t_priors.GMMPrior.from_dict(gd, 3.0, device="cpu", dtype=F64)
    tj = t_priors.GMMPrior.from_jax(jg, device="cpu", dtype=F64)
    for a, b, c in zip(tg, tj, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    rng = np.random.default_rng(5)
    x = gd["means"][[0, 3, 5, 7]] + 0.2 * rng.normal(size=(4, 69))
    r, jac = t_priors.gmm_pose_prior_residual_and_jacobian(
        torch.as_tensor(x), tg)
    for i in range(4):
        xi = jnp.asarray(x[i])
        np.testing.assert_allclose(
            r[i].numpy(), np.asarray(j_priors.gmm_pose_prior_residual(xi, jg)),
            rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            jac[i].numpy(),
            np.asarray(jax.jacfwd(j_priors.gmm_pose_prior_residual)(xi, jg)),
            rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        t_priors.gmm_pose_prior_residual(torch.as_tensor(x), tg).numpy(),
        r.numpy())


def test_gmm_argmin_tie_takes_the_first_component(rig):
    """Two components with equal negative log-likelihood at x (a copy of
    component 2 placed first, its precision factor negated, and x their
    mean): both packages pick the first, and the Jacobian is its block."""
    gd = {k: np.asarray(v).copy() for k, v in rig["gmm"].items()}
    for k in ("weights", "means", "covs", "prec_cho", "logdet_cov"):
        gd[k] = np.concatenate([gd[k][2:3], gd[k]])
    gd["prec_cho"][3] = -gd["prec_cho"][0]   # same precision, other sign
    jg = j_priors.GMMPrior.from_dict(gd, beta=2.0, dtype=jnp.float64)
    tg = t_priors.GMMPrior.from_dict(gd, 2.0, device="cpu", dtype=F64)
    x = gd["means"][0]
    _, k = t_priors._assignment(torch.as_tensor(x), tg)
    assert int(k) == 0
    r, jac = t_priors.gmm_pose_prior_residual_and_jacobian(torch.as_tensor(x), tg)
    want = np.asarray(jax.jacfwd(j_priors.gmm_pose_prior_residual)(
        jnp.asarray(x), jg))
    np.testing.assert_allclose(jac.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(jac[:-1].numpy(), 2.0 * gd["prec_cho"][0].T,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(r.numpy(), np.asarray(
        j_priors.gmm_pose_prior_residual(jnp.asarray(x), jg)), atol=1e-12)


def test_huber_block_weights_and_temporal_residuals():
    rng = np.random.default_rng(2)
    blocks = rng.normal(size=(3, 17, 2)) * np.array([0.1, 1.0, 10.0])[:, None, None]
    blocks[0, 0] = 0.0
    np.testing.assert_allclose(
        huber_block_weights(torch.as_tensor(blocks), 3.0).numpy(),
        np.asarray(j_robust.huber_block_weights(jnp.asarray(blocks), 3.0)),
        rtol=1e-12, atol=1e-12)
    params = rng.normal(size=(5, 76))
    np.testing.assert_allclose(
        temporal_residuals(torch.as_tensor(params), 3.0, 24).numpy(),
        np.asarray(j_temporal.temporal_residuals(jnp.asarray(params),
                                                 jnp.asarray(3.0), 24)),
        rtol=1e-12, atol=1e-12)
