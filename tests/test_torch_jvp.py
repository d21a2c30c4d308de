"""The forward-mode assembly (``MultiFrameConfig.jacobian="jvp"``) and the
reference's whole ``MultiFrameConfig`` on the CPU, against the port's
analytic assembly and the JAX package's ``"jvp"``.

Inputs are made from generators seeded here (not from the suite's session
``rng``: its state depends on which files ran before in the worker, which
is what makes ``tests/test_jacobian.py::test_fitter_optimum_matches_jvp``
and its neighbour intermittent, ROADMAP Queue 3). The JAX results (its
``"jvp"`` assembly and fitter, whose ``jax.linearize`` takes XLA seconds
to compile) are read from ``tests/data/jvp_jax_ref.npz``, which ``python
-m tests.test_torch_jvp --record`` writes from the same inputs.

Tolerances: both assemblies are exact derivatives of one function, so in
float64 they agree to rounding, rtol 1e-10 of each piece's scale (the
reference's tests/test_jacobian.py holds its two paths so); in float32 the
jvp pieces stay finite on masked rows (s = 0) and padded frames and within
1e-4 of the float64 pieces' scale. The fitters are held as the tridiag
fitters are (tests/test_torch_tridiag.py): cost 1e-9, params 1e-8,
counts exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu_torch.energy import (
    keypoint_residuals,
    make_skeleton_spec,
    project,
    skeleton_joints_cam,
)
from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.models import SMPLModel, make_synthetic_model
from smpltpu_torch.parallel import build_sharded_lm_fitter, run_ranks
from smpltpu_torch.solve import MultiFrameConfig, build_multi_fitter
from smpltpu_torch.solve.multi_frame import corrected_frame_assembly
from smpltpu_torch.utils import default_intrinsics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "jvp_jax_ref.npz")
W_IMG, H_IMG = 720, 1280
PIECE_RTOL, F32_RTOL = 1e-10, 1e-4
COST_RTOL, PARAM_ATOL = 1e-9, 1e-8
HUBER_DELTA = 2.0           # small enough that some rows are past it
CFG = dict(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
           max_iters=15, huber_delta=HUBER_DELTA)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


def rig(dtype=torch.float64):
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=300, n_shapes=10,
                                                     seed=0),
                                device="cpu", dtype=dtype)
    cam = default_intrinsics(W_IMG, H_IMG, device="cpu", dtype=dtype)
    return cam, make_skeleton_spec(model, init_root_rotation(), with_shape=True)


def assembly_inputs(n_win=2, f=4, seed=11, masked=True):
    """A perturbed evaluation point of (W, F) frames, 3 px keypoint noise
    (rows past the Huber threshold) and, ``masked``, invalid slots (masked
    rows, s = 0) and one all-padded frame."""
    rng = np.random.default_rng(seed)
    cam, spec = rig()
    gt = np.tile(init_frame_params(device="cpu", dtype=torch.float64).numpy(),
                 (n_win, f, 1))
    gt[..., 7:] += 0.2 * rng.normal(size=(n_win, f, 69))
    shape = 0.3 * rng.normal(size=(n_win, 1, 10))
    uv = project(skeleton_joints_cam(torch.as_tensor(gt), torch.as_tensor(shape),
                                     spec), cam).numpy()
    kp = np.zeros((n_win, f, N_KP_SLOTS, 4))
    kp[..., 0] = USE_SMPL
    kp[..., 1:3] = uv[..., USE_SMPL, :] + 3.0 * rng.normal(
        size=(n_win, f, N_KP_SLOTS, 2))
    kp[..., 3] = 1.0
    if masked:
        kp[0, 1, 2:7, 1:] = 0.0          # invalid slots
        kp[1, -1, :, 1:] = 0.0           # a padded frame
    p = gt + 0.05 * rng.normal(size=gt.shape)
    p[..., 0] = 1.0 + 0.05 * rng.normal(size=(n_win, f))
    r0 = np.tile(np.asarray(init_root_rotation()), (n_win, f, 1, 1))
    return p, shape, kp, r0


def _pieces(dtype, jacobian, inputs=None):
    cam, spec = rig(dtype)
    p, shape, kp, r0 = (torch.as_tensor(a, dtype=dtype)
                        for a in inputs or assembly_inputs())
    return corrected_frame_assembly(p, shape, kp, r0, cam, spec, HUBER_DELTA,
                                    jacobian, with_cost=True)


NAMES = ("h_pp", "b_pw", "h_ww", "g_p", "g_w", "cost")


def _close(got, want, rtol):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


def test_jvp_assembly_matches_analytic_and_jax(golden):
    """Every piece, with the Huber correction on rows past the threshold,
    masked rows and a padded frame: jvp against analytic, and against the
    reference's jvp assembly."""
    jvp = _pieces(torch.float64, "jvp")
    analytic = _pieces(torch.float64, "analytic")
    _close(jvp, analytic, PIECE_RTOL)
    _close(jvp, [golden[f"asm_{n}"] for n in NAMES], PIECE_RTOL)
    # the inputs reach both branches of the weight, and masked rows
    cam, spec = rig()
    p, shape, kp, r0 = (torch.as_tensor(a) for a in assembly_inputs())
    s = (keypoint_residuals(p, shape, kp, cam, spec, r0)
         .unflatten(-1, (-1, 2)) ** 2).sum(-1)
    assert bool((s > HUBER_DELTA ** 2).any() and (s < HUBER_DELTA ** 2).any()
                and (s == 0).any())


def test_jvp_assembly_float32_masked_rows_finite():
    """In float32 the jvp pieces are finite on masked rows (s = 0), where
    the weight's constant branch passes a zero tangent, and on the padded
    frame, and agree with float64 to float32's rounding."""
    got = _pieces(torch.float32, "jvp")
    want = _pieces(torch.float64, "jvp")
    for name, g in zip(NAMES, got):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
    _close(got, want, F32_RTOL)
    # the padded frame contributes nothing
    assert float(got[0][1, -1].abs().max()) == 0.0


def test_config_takes_the_reference_fields():
    """``MultiFrameConfig(**jax_cfg._asdict())`` builds the port's config:
    every field of the reference's, in its order, with an equal default."""
    from smpltpu.solve.multi_frame import MultiFrameConfig as JConfig

    assert MultiFrameConfig._fields == JConfig._fields
    assert MultiFrameConfig._field_defaults == JConfig._field_defaults
    jax_cfg = JConfig(**dict(CFG, jacobian="jvp", cg_unroll=4, linear="cr"))
    cfg = MultiFrameConfig(**jax_cfg._asdict())
    assert cfg._asdict() == jax_cfg._asdict()


def test_unknown_jacobian_raises():
    cam, spec = rig()
    with pytest.raises(ValueError, match="unknown jacobian"):
        build_multi_fitter(spec, cam, MultiFrameConfig(
            **dict(CFG, jacobian="jacfwd")), 10, device="cpu",
            dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown jacobian"):
        _pieces(torch.float64, "reverse")


def fit_inputs(f=6, seed=12):
    """A cold 6-frame fit: the init pose on noisy keypoints of a motion."""
    p, shape, kp, r0 = assembly_inputs(1, f, seed, masked=False)
    kp[0, 2, 4:6, 3] = 0.0
    p0 = np.tile(init_frame_params(device="cpu", dtype=torch.float64).numpy(),
                 (f, 1))
    return p0, np.zeros(10), kp[0], r0[0]


@pytest.mark.parametrize("fused_cost,cg_unroll", [(True, 1), (False, 3)])
def test_fitter_jvp_matches_analytic_and_jax(golden, fused_cost, cg_unroll):
    """The fitter with ``jacobian="jvp"`` reaches the analytic fitter's
    optimum along the same trajectory, and the reference's jvp fitter's;
    ``cg_unroll`` changes nothing."""
    from smpltpu_torch.solve import MultiFrameResult
    cam, spec = rig()
    args = [torch.as_tensor(a) for a in fit_inputs()]
    kw = dict(CFG, fused_cost=fused_cost, cg_unroll=cg_unroll)

    def run(jacobian):
        return build_multi_fitter(spec, cam, MultiFrameConfig(
            **dict(kw, jacobian=jacobian)), 10, device="cpu",
            dtype=torch.float64)(*args)
    got, want = run("jvp"), run("analytic")
    ref = MultiFrameResult(*(golden[f"fit{int(fused_cost)}_{k}"]
                             for k in MultiFrameResult._fields))
    assert int(got.n_accepted) > 3
    for other in (want, ref):
        for field in ("iters_run", "converged", "n_accepted"):
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          np.asarray(getattr(other, field)))
        for field in ("cost", "cost_history"):
            np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                       np.asarray(getattr(other, field)),
                                       rtol=COST_RTOL)
        for field in ("params", "shape"):
            np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                       np.asarray(getattr(other, field)),
                                       rtol=0, atol=PARAM_ATOL)


def test_sharded_lm_forwards_jacobian():
    """The frame-sharded LM on two ranks takes ``cfg.jacobian`` to its
    assembly: jvp and analytic give one result."""
    cam, spec = rig()
    args = [torch.as_tensor(a) for a in fit_inputs(f=4)]

    def fit(jacobian):
        cfg = MultiFrameConfig(**dict(CFG, max_iters=3, jacobian=jacobian))
        return run_ranks(2, lambda mesh: build_sharded_lm_fitter(
            mesh, spec, cam, cfg, 10, cg_iters=30, dtype=torch.float64)(
                *args))[0]
    got, want = fit("jvp"), fit("analytic")
    np.testing.assert_allclose(got.cost.numpy(), want.cost.numpy(),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(got.params.numpy(), want.params.numpy(),
                               rtol=0, atol=PARAM_ATOL)


def record(path=GOLDEN):
    """The JAX package's jvp assembly (vmapped over the frames) and its
    jvp fitter on this file's inputs, float64."""
    import jax
    import jax.numpy as jnp

    import smpltpu.energy as jen
    from smpltpu.constants import init_root_rotation as j_r0
    from smpltpu.models import SMPLModel as JModel
    from smpltpu.solve.multi_frame import MultiFrameConfig as JConfig
    from smpltpu.solve.multi_frame import build_multi_fitter as j_build
    from smpltpu.solve.multi_frame import corrected_frame_assembly as j_asm
    from smpltpu.utils import default_intrinsics as j_intrinsics

    jm = JModel.from_dict(make_synthetic_model(n_verts=300, n_shapes=10,
                                               seed=0), dtype=jnp.float64)
    cam = j_intrinsics(W_IMG, H_IMG, dtype=jnp.float64)
    spec = jen.make_skeleton_spec(jm, j_r0(), with_shape=True)
    out = {}
    p, shape, kp, r0 = map(jnp.asarray, assembly_inputs())

    def frame(p_f, w, kp_f, r0_f):
        return j_asm(p_f, w, kp_f, r0_f, cam, spec, HUBER_DELTA,
                     jacobian="jvp", with_cost=True)
    per_win = jax.vmap(frame, in_axes=(0, None, 0, 0))
    pieces = jax.jit(jax.vmap(per_win))(p, shape[:, 0], kp, r0)
    for name, v in zip(NAMES, pieces):
        out[f"asm_{name}"] = np.asarray(v)
    args = [jnp.asarray(a) for a in fit_inputs()]
    for fused in (1, 0):
        res = j_build(spec, cam, JConfig(**dict(CFG, fused_cost=bool(fused),
                                                jacobian="jvp")), 10,
                      dtype=jnp.float64)(*args)
        for k, v in res._asdict().items():
            out[f"fit{fused}_{k}"] = np.asarray(v)
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_jvp --record: rewrite the recorded JAX
    # results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_jvp --record")
    record()
