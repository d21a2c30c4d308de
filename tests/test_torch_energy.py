"""smpltpu_torch energy terms against the JAX package on the CPU in float64:
skeleton FK, projection, residuals, the analytic Jacobian (also against
torch.func.jacfwd), the Huber correction weight and its closed-form slope,
the L2 priors and the parameter layout. Inputs are made with numpy and
handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smpltpu.energy as jen
from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu.energy.jacobian import (
    keypoint_residuals_and_jacobian as j_res_jac,
)
from smpltpu.energy.params import init_frame_params as j_init_params
from smpltpu.energy.temporal import temporal_mask as j_temporal_mask
from smpltpu.models import SMPLModel as JModel
from smpltpu.solve.lm import huber_correct_weight as j_hw
from smpltpu.utils import default_intrinsics as j_intrinsics
from smpltpu_torch.energy import (
    keypoint_residuals,
    make_skeleton_spec,
    project,
    skeleton_joints_cam,
)
from smpltpu_torch.energy.jacobian import keypoint_residuals_and_jacobian
from smpltpu_torch.energy.params import frame_param_layout, init_frame_params
from smpltpu_torch.energy.priors import (
    l2_pose_prior_residual,
    shape_prior_residual,
)
from smpltpu_torch.energy.temporal import temporal_mask
from smpltpu_torch.models import SMPLModel, rodrigues
from smpltpu_torch.solve.lm import (
    _huber_rho,
    huber_correct_weight,
    huber_correct_weight_and_slope,
)
from smpltpu_torch.utils import default_intrinsics

F64 = torch.float64
CPU = torch.device("cpu")
W_IMG, H_IMG = 480, 270


def make_rig(model_dict, n_frames, seed, noise=1.0):
    """Ground-truth motion, keypoints with pixel noise, per-frame R0, all
    numpy float64; the keypoints are projected with the port's own FK."""
    rng = np.random.default_rng(seed)
    model = SMPLModel.from_dict(model_dict, device=CPU, dtype=F64)
    cam = default_intrinsics(W_IMG, H_IMG, device=CPU, dtype=F64)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    gt = np.zeros((n_frames, 76))
    gt[:, 0] = 1.0
    gt[:, 1:4] = 0.05 * rng.normal(size=(n_frames, 3))
    gt[:, 4:7] = [0.05, -0.05, 3.2]
    gt[:, 7:] = 0.15 * rng.normal(size=69) + 0.02 * rng.normal(
        size=(n_frames, 69))
    shape = 0.3 * rng.normal(size=10)
    uv = project(skeleton_joints_cam(torch.as_tensor(gt), torch.as_tensor(shape),
                                     spec), cam).numpy()
    kp = np.zeros((n_frames, N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + noise * rng.normal(
        size=(n_frames, N_KP_SLOTS, 2))
    kp[:, :, 3] = 1.0
    r0 = np.tile(init_root_rotation(), (n_frames, 1, 1))
    return {"model": model, "cam": cam, "spec": spec, "gt": gt,
            "shape": shape, "kp": kp, "r0": r0, "rng": rng}


def jax_rig(model_dict):
    jm = JModel.from_dict(model_dict, dtype=jnp.float64)
    cam = j_intrinsics(W_IMG, H_IMG, dtype=jnp.float64)
    spec = jen.make_skeleton_spec(jm, init_root_rotation(), with_shape=True)
    return jm, cam, spec


@pytest.fixture(scope="module")
def rigs(small_model_dict):
    rig = make_rig(small_model_dict, 6, seed=3)
    # a perturbed evaluation point with some invalid keypoint slots and a
    # per-frame root orientation
    rng = rig["rng"]
    p = rig["gt"] + 0.05 * rng.normal(size=rig["gt"].shape)
    p[:, 0] = 1.0 + 0.1 * rng.normal(size=6)
    rig["p"] = p
    rig["kp"][1, 3:6, 3] = 0.0
    rig["kp"][4, :, 3] = 0.0
    th = 0.2 * rng.normal(size=(6, 3))
    rig["r0"] = rodrigues(torch.as_tensor(th)).numpy() @ init_root_rotation()
    return rig, jax_rig(small_model_dict)


def test_skeleton_joints_cam_matches_jax(rigs):
    rig, (_, _, jspec) = rigs
    got = skeleton_joints_cam(torch.as_tensor(rig["p"]),
                              torch.as_tensor(rig["shape"]), rig["spec"],
                              torch.as_tensor(rig["r0"])).numpy()
    want = jax.vmap(lambda p, r: jen.skeleton_joints_cam(
        p, jnp.asarray(rig["shape"]), jspec, r))(
            jnp.asarray(rig["p"]), jnp.asarray(rig["r0"]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def test_project_matches_jax_with_zero_depth(rigs):
    """The z guard keeps a z = 0 row (and |z| < 1e-8 of either sign)
    finite, exactly as the reference does."""
    rig, (_, jcam, _) = rigs
    pts = np.array([[0.1, -0.2, 3.0], [0.3, 0.4, 0.0], [0.1, 0.1, -1e-9],
                    [0.2, 0.1, 5e-9], [-0.5, 0.2, -2.0]])
    got = project(torch.as_tensor(pts), rig["cam"]).numpy()
    want = np.asarray(jen.project(jnp.asarray(pts), jcam))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_keypoint_residuals_match_jax(rigs):
    rig, (_, jcam, jspec) = rigs
    got = keypoint_residuals(torch.as_tensor(rig["p"]),
                             torch.as_tensor(rig["shape"]),
                             torch.as_tensor(rig["kp"]), rig["cam"],
                             rig["spec"], torch.as_tensor(rig["r0"])).numpy()
    want = jax.vmap(lambda p, k, r: jen.keypoint_residuals(
        p, jnp.asarray(rig["shape"]), k, jcam, jspec, r))(
            jnp.asarray(rig["p"]), jnp.asarray(rig["kp"]),
            jnp.asarray(rig["r0"]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-9)
    assert np.all(got[4] == 0.0)          # a frame with no valid slot


def test_analytic_jacobian_matches_jax_and_jacfwd(rigs):
    """f64: the residuals are O(100) px and the Jacobian entries up to
    O(1e3) px per unit, so 1e-9 absolute is ~1e-12 relative, i.e. the same
    closed form up to summation order."""
    rig, (_, jcam, jspec) = rigs
    p, w = torch.as_tensor(rig["p"]), torch.as_tensor(rig["shape"])
    kp, r0 = torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"])
    res, jp, jw = keypoint_residuals_and_jacobian(p, w, kp, rig["cam"],
                                                  rig["spec"], r0)
    want = jax.vmap(lambda a, k, r: j_res_jac(
        a, jnp.asarray(rig["shape"]), k, jcam, jspec, r))(
            jnp.asarray(rig["p"]), jnp.asarray(rig["kp"]),
            jnp.asarray(rig["r0"]))
    for got, ref in zip((res, jp, jw), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-9)
    # independent oracle: forward-mode autodiff of the residual function
    for f in (0, 1):
        def fn(a, b, f=f):
            return keypoint_residuals(a, b, kp[f], rig["cam"], rig["spec"],
                                      r0[f])
        jp_ad, jw_ad = torch.func.jacfwd(fn, argnums=(0, 1))(p[f], w)
        np.testing.assert_allclose(jp[f].numpy(), jp_ad.numpy(), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(jw[f].numpy(), jw_ad.numpy(), rtol=0,
                                   atol=1e-9)


DELTA = 3.0
S_GRID = np.array([0.0, 1e-30, 1e-6, 0.5, 8.999999999, 9.0, 9.000000001,
                   9.5, 30.0, 1e4, 1e8])


def test_huber_weight_and_slope_match_jax_jvp():
    """w(s) and dw/ds at s = 0, around delta^2 = 9 and far above it, against
    JAX's forward-mode value (the reference takes the slope with jax.jvp)
    and torch.func.jvp of the port's own weight. Tolerance: 1e-12 relative,
    plus 1e-15 absolute for s just above delta^2, where the slope is the
    difference of two terms of ~1/9 that cancel to ~3e-12, so each form's
    rounding (1e-17 on the terms) shows as ~1e-7 relative."""
    s = torch.as_tensor(S_GRID)
    w, slope = huber_correct_weight_and_slope(s, DELTA)
    jw_ref, jslope = jax.jvp(lambda t: j_hw(t, DELTA), (jnp.asarray(S_GRID),),
                             (jnp.ones(len(S_GRID)),))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw_ref), rtol=1e-14)
    np.testing.assert_allclose(huber_correct_weight(s, DELTA).numpy(),
                               np.asarray(jw_ref), rtol=1e-14)
    np.testing.assert_allclose(slope.numpy(), np.asarray(jslope), rtol=1e-12,
                               atol=1e-15)
    _, tslope = torch.func.jvp(lambda t: huber_correct_weight(t, DELTA), (s,),
                               (torch.ones_like(s),))
    np.testing.assert_allclose(slope.numpy(), tslope.numpy(), rtol=1e-12,
                               atol=1e-15)
    assert np.all(slope.numpy()[S_GRID <= DELTA ** 2] == 0.0)


def test_huber_slope_finite_on_masked_rows_f32():
    """float32, s = 0 (a masked row): the closed form stays finite (0)."""
    s = torch.zeros(4, dtype=torch.float32)
    w, slope = huber_correct_weight_and_slope(s, DELTA)
    assert torch.all(w == 1.0) and torch.all(slope == 0.0)


def test_huber_rho_matches_jax():
    from smpltpu.solve.lm import _huber_rho as j_rho
    np.testing.assert_allclose(_huber_rho(torch.as_tensor(S_GRID), DELTA).numpy(),
                               np.asarray(j_rho(jnp.asarray(S_GRID), DELTA)),
                               rtol=1e-15)


def test_priors_layout_and_mask_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=69)
    np.testing.assert_allclose(
        l2_pose_prior_residual(torch.as_tensor(x), 5.0).numpy(),
        np.asarray(jen.l2_pose_prior_residual(jnp.asarray(x), 5.0)), rtol=0)
    np.testing.assert_allclose(
        shape_prior_residual(torch.as_tensor(x[:10]), 25.0).numpy(),
        np.asarray(jen.shape_prior_residual(jnp.asarray(x[:10]), 25.0)), rtol=0)
    assert frame_param_layout(24) == jen.frame_param_layout(24)
    np.testing.assert_array_equal(
        init_frame_params(device=CPU, dtype=F64).numpy(),
        np.asarray(j_init_params(dtype=jnp.float64)))
    np.testing.assert_array_equal(
        temporal_mask(24, device=CPU, dtype=F64).numpy(),
        np.asarray(j_temporal_mask(24, jnp.float64)))
