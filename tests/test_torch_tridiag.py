"""The port's exact arrowhead solve (``linear="tridiag"``) against the JAX
package on the CPU in float64: the block-tridiagonal elimination alone
(and against a dense solve of the assembled matrix), the multi-frame
fitter with it, the chunked window fit, the cached ``fit_multi_frame`` and
``linear="pcg_block"`` against the exact solve and the reference.

Tolerances (f64): the elimination runs the reference's operations in its
order (upper Cholesky factors, S_prev^{-1} by a solve against the
identity), so it agrees with it to rounding: rtol 1e-10. With an exact
step the fitter has no truncated CG to amplify summation order (the PCG
tests need 2e-5): measured here, costs agree to 1.3e-13 relative and
params to 4e-15 absolute at most, so the fitter is held to 1e-9 in cost
and 1e-8 in params, counts exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smpltpu.energy as jen
from smpltpu.constants import init_root_rotation
from smpltpu.models import SMPLModel as JModel
from smpltpu.solve import MultiFrameConfig as JConfig
from smpltpu.solve import build_multi_fitter as j_build
from smpltpu.solve.tridiag import block_tridiag_solve as j_tridiag
from smpltpu.utils import default_intrinsics as j_intrinsics
from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.solve import (
    MultiFrameConfig,
    build_chunked_window_fit,
    build_multi_fitter,
    fit_multi_frame,
)
from smpltpu_torch.solve import multi_frame
from smpltpu_torch.solve.multi_frame import arrow_tridiag
from smpltpu_torch.solve.tridiag import block_tridiag_solve
from tests.test_torch_energy import H_IMG, W_IMG, make_rig

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small LAPACK and elementwise calls; under the
    suite's parallel workers, MKL's and OpenMP's eight threads a process
    oversubscribe the cores and spin (measured: 237 s against 19 s for
    the same tests beside six busy processes). One thread per process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
CPU = torch.device("cpu")
SOLVE_RTOL = 1e-10
COST_RTOL, PARAM_ATOL = 1e-9, 1e-8


def _system(rng, lead, f, p=7, r=4):
    """A random SPD block-tridiagonal system in the solver's layout: (P, P)
    diagonal blocks, off-diagonal blocks c_f diag(m) with m[0] = 0 (the
    frozen scale), R right-hand sides; ``lead`` leading (window) axes."""
    a = rng.normal(size=lead + (f, p, p)) * 0.3
    d = a @ np.swapaxes(a, -1, -2) + 2.0 * np.eye(p)
    c = -np.abs(rng.normal(size=lead + (f - 1,))) * 0.6
    m = np.ones(p)
    m[0] = 0.0
    return d, c, m, rng.normal(size=lead + (f, p, r))


def _dense(d, c, m):
    """The assembled (F P, F P) matrix of one system."""
    f, p = d.shape[0], d.shape[-1]
    t = np.zeros((f * p, f * p))
    for i in range(f):
        t[i * p:(i + 1) * p, i * p:(i + 1) * p] = d[i]
    for i in range(f - 1):
        e = c[i] * np.diag(m)
        t[i * p:(i + 1) * p, (i + 1) * p:(i + 2) * p] = e
        t[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = e
    return t


@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("f", [1, 2, 5, 20])
def test_block_tridiag_solve_matches_jax_and_dense(f, windows):
    rng = np.random.default_rng(100 + f)
    lead = () if windows is None else (windows,)
    d, c, m, rhs = _system(rng, lead, f)
    got = block_tridiag_solve(*(torch.as_tensor(x) for x in (d, c, m, rhs)))
    solve = (j_tridiag if windows is None else
             jax.vmap(j_tridiag, in_axes=(0, 0, None, 0)))
    want = np.asarray(solve(*(jnp.asarray(x) for x in (d, c, m, rhs))))
    assert got.shape == rhs.shape and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=SOLVE_RTOL,
                               atol=SOLVE_RTOL * np.abs(want).max())
    for k in np.ndindex(*lead):
        x = np.linalg.solve(_dense(d[k], c[k], m),
                            rhs[k].reshape(f * d.shape[-1], -1))
        np.testing.assert_allclose(got.numpy()[k].reshape(x.shape), x,
                                   rtol=SOLVE_RTOL,
                                   atol=SOLVE_RTOL * np.abs(x).max())


@pytest.mark.parametrize("bad_frame", [0, 3])
def test_block_tridiag_solve_not_positive_definite_gives_nan(bad_frame):
    """A block that is not positive definite: the reference's cho_factor
    gives NaN; ``cholesky_ex`` would give a finite partial factor, which
    the port turns into NaN, so the LM step that needed it is rejected in
    both packages."""
    rng = np.random.default_rng(7)
    d, c, m, rhs = _system(rng, (), 5)
    d[bad_frame] -= 50.0 * np.eye(d.shape[-1])
    got = block_tridiag_solve(*(torch.as_tensor(x) for x in (d, c, m, rhs)))
    want = np.asarray(j_tridiag(*(jnp.asarray(x) for x in (d, c, m, rhs))))
    assert np.isnan(want).any()
    assert torch.isnan(got).any()
    # the frames the NaN reaches are the same in both
    np.testing.assert_array_equal(torch.isnan(got).any(-1).any(-1).numpy(),
                                  np.isnan(want).any(-1).any(-1))


@pytest.mark.parametrize("f", [1, 6])
def test_arrow_tridiag_matches_dense(f):
    """The exact arrowhead solve the fitter's "tridiag" runs (elimination,
    then the shape Schur complement), on two windows, against a dense
    solve of the assembled [T B; B^T C] system."""
    rng = np.random.default_rng(30 + f)
    d, c, m, _ = _system(rng, (2,), f)
    n_s, p = 3, d.shape[-1]
    b = rng.normal(size=(2, f, p, n_s)) * 0.2
    cw = rng.normal(size=(2, n_s, n_s))
    c_reg = cw @ np.swapaxes(cw, -1, -2) + 2.0 * np.eye(n_s)
    g_p, g_w = rng.normal(size=(2, f, p)), rng.normal(size=(2, n_s))
    dp, dw = arrow_tridiag(*(torch.as_tensor(x) for x in
                             (d, c, m, b, c_reg, g_p, g_w)))
    for k in range(2):
        a = np.zeros((f * p + n_s,) * 2)
        a[:f * p, :f * p] = _dense(d[k], c[k], m)
        a[:f * p, f * p:] = b[k].reshape(f * p, n_s)
        a[f * p:, :f * p] = a[:f * p, f * p:].T
        a[f * p:, f * p:] = c_reg[k]
        x = np.linalg.solve(a, -np.concatenate([g_p[k].ravel(), g_w[k]]))
        np.testing.assert_allclose(dp[k].numpy().ravel(), x[:f * p],
                                   rtol=SOLVE_RTOL, atol=SOLVE_RTOL)
        np.testing.assert_allclose(dw[k].numpy(), x[f * p:], rtol=SOLVE_RTOL,
                                   atol=SOLVE_RTOL)


@pytest.fixture(scope="module")
def jax_side(small_model_dict):
    jm = JModel.from_dict(small_model_dict, dtype=jnp.float64)
    cam = j_intrinsics(W_IMG, H_IMG, dtype=jnp.float64)
    spec = jen.make_skeleton_spec(jm, init_root_rotation(), with_shape=True)
    return cam, spec


def _p0(n, depth=3.0):
    return np.tile(init_frame_params(depth=depth, device=CPU, dtype=F64).numpy(),
                   (n, 1))


def _assert_match(got, want, param_mask=None):
    for field in ("iters_run", "converged", "n_accepted"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    for field in ("cost", "cost_history"):
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=COST_RTOL, atol=0)
    gp, wp = np.asarray(got.params), np.asarray(want.params)
    if param_mask is not None:
        gp, wp = gp[param_mask], wp[param_mask]
    np.testing.assert_allclose(gp, wp, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(np.asarray(got.shape), np.asarray(want.shape),
                               rtol=0, atol=PARAM_ATOL)


CFG = dict(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
           max_iters=20, linear="tridiag")


@pytest.mark.parametrize("fused_cost", [True, False])
def test_stage1_tridiag_matches_jax(small_model_dict, jax_side, fused_cost):
    """Stage 1 as the CLI runs it: one unbatched 8-frame solve with a
    shared shape, the default config's exact solve."""
    rig = make_rig(small_model_dict, 8, seed=21)
    kw = dict(CFG, fused_cost=fused_cost)
    fit = build_multi_fitter(rig["spec"], rig["cam"], MultiFrameConfig(**kw),
                             10, device=CPU, dtype=F64)
    got = fit(torch.as_tensor(_p0(8)), torch.zeros(10, dtype=F64),
              torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
    jcam, jspec = jax_side
    want = j_build(jspec, jcam, JConfig(**kw), 10, dtype=jnp.float64)(
        jnp.asarray(_p0(8)), jnp.zeros(10), jnp.asarray(rig["kp"]),
        jnp.asarray(rig["r0"]))
    assert got.params.shape == (8, 76) and int(got.n_accepted) > 3
    _assert_match(got, want)


def _windows(rig, starts, f):
    """Windows of ``f`` frames at ``starts``, the ones past the end padded
    (keypoints masked, frame_valid 0), with distinct start depths."""
    n = rig["kp"].shape[0]
    kpw = np.zeros((len(starts), f) + rig["kp"].shape[1:])
    r0w = np.tile(init_root_rotation(), (len(starts), f, 1, 1))
    vw = np.zeros((len(starts), f))
    for i, s in enumerate(starts):
        e = min(s + f, n)
        kpw[i, :e - s] = rig["kp"][s:e]
        r0w[i, :e - s] = rig["r0"][s:e]
        vw[i, :e - s] = 1.0
    p0w = np.stack([_p0(f, depth=3.0 + 0.1 * i) for i in range(len(starts))])
    return p0w, kpw, r0w, vw


@pytest.mark.parametrize("fused_cost", [True, False])
def test_padded_window_batch_tridiag_matches_jax_vmap(small_model_dict,
                                                      jax_side, fused_cost):
    """Four 6-frame windows as one batch, the last two padded, under the
    stage-2 shape lock, against jax.vmap of the reference fitter; three of
    the windows converge at different trips (30-34 of 40), so the masked
    loop's freeze is exercised."""
    rig = make_rig(small_model_dict, 18, seed=22)
    p0w, kpw, r0w, vw = _windows(rig, [0, 5, 10, 15], 6)
    shape0 = 0.1 * rig["rng"].normal(size=10)
    kw = dict(CFG, beta_shape=1e5, max_iters=40, fused_cost=fused_cost)
    fit = build_multi_fitter(rig["spec"], rig["cam"], MultiFrameConfig(**kw),
                             10, device=CPU, dtype=F64)
    got = fit(*(torch.as_tensor(x) for x in (p0w, shape0, kpw, r0w, vw)))
    jcam, jspec = jax_side
    jfit = j_build(jspec, jcam, JConfig(**kw), 10, dtype=jnp.float64)
    want = jax.jit(jax.vmap(lambda a, c, d, e: jfit(a, jnp.asarray(shape0),
                                                    c, d, e)))(
        *(jnp.asarray(x) for x in (p0w, kpw, r0w, vw)))
    assert len(set(got.iters_run.tolist())) > 2
    _assert_match(got, want, param_mask=vw > 0)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_chunked_window_fit_equals_one_batch(small_model_dict, chunk):
    """Chunks of 1, 2 and 3 of five windows (3 leaves a ragged last chunk)
    give the one batch's per-window results, in f64 to the last bit up to
    the batched kernels' summation order."""
    rig = make_rig(small_model_dict, 22, seed=23)
    p0w, kpw, r0w, vw = _windows(rig, [0, 5, 10, 15, 20], 5)
    shape0 = np.tile(0.1 * rig["rng"].normal(size=10), (5, 1))
    fit = build_multi_fitter(rig["spec"], rig["cam"],
                             MultiFrameConfig(**dict(CFG, beta_shape=1e5,
                                                     max_iters=10,
                                                     fused_cost=True)),
                             10, device=CPU, dtype=F64)
    args = tuple(torch.as_tensor(x) for x in (p0w, shape0, kpw, r0w, vw))
    whole = fit(*args)
    got = build_chunked_window_fit(fit, chunk)(*args)
    for a, b in zip(got, whole):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="chunk_size"):
        build_chunked_window_fit(fit, 0)


def test_fit_multi_frame_caches_per_problem(small_model_dict, jax_side,
                                            monkeypatch):
    """The cached wrapper: one fitter per (problem, config, frames, dtype,
    device), equal to the reference's ``fit_multi_frame``."""
    from smpltpu.solve.multi_frame import fit_multi_frame as j_fit_multi

    monkeypatch.setattr(multi_frame, "_multi_cache", {})
    rig = make_rig(small_model_dict, 6, seed=24)
    cfg = MultiFrameConfig(**dict(CFG, max_iters=8))
    args = (torch.as_tensor(_p0(6)), torch.zeros(10, dtype=F64),
            torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
    got = fit_multi_frame(rig["spec"], rig["cam"], cfg, *args)
    again = fit_multi_frame(rig["spec"], rig["cam"], cfg, *args)
    assert len(multi_frame._multi_cache) == 1
    fit_multi_frame(rig["spec"], rig["cam"], cfg, args[0][:4], args[1],
                    args[2][:4], args[3][:4])
    assert len(multi_frame._multi_cache) == 2
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jcam, jspec = jax_side
    want = j_fit_multi(jspec, jcam, JConfig(**dict(CFG, max_iters=8)),
                       *(jnp.asarray(a.numpy()) for a in args))
    _assert_match(got, want)


def _mean_px(rig, st):
    from smpltpu_torch.constants import USE_SMPL
    from smpltpu_torch.energy import project, skeleton_joints_cam
    uv = project(skeleton_joints_cam(st.params, st.shape, rig["spec"]),
                 rig["cam"]).numpy()
    return float(np.linalg.norm(uv[:, USE_SMPL] - rig["kp"][:, :, 1:3],
                                axis=-1).mean())


def test_pcg_block_reaches_the_exact_optimum(small_model_dict):
    """linear="pcg_block" (CG with the first linearization's (P, P) blocks
    and shape block inverted once per fit as its preconditioner) lands at
    the exact solve's optimum, fused and plain loops, as
    tests/test_multi_frame.py:306 holds the reference's: cost within 1 %,
    pixel error within 1 % + 0.05 px of the exact path's (from a cold
    start the stale preconditioner changes the trajectory, not the
    optimum)."""
    rig = make_rig(small_model_dict, 6, seed=4, noise=0.0)
    base = dict(beta_pose=2.0, beta_shape=10.0, lambda_temporal=2.0,
                max_iters=80)

    def run(linear, fused):
        cfg = MultiFrameConfig(**base, linear=linear, cg_iters=400,
                               fused_cost=fused)
        return build_multi_fitter(rig["spec"], rig["cam"], cfg, 10,
                                  device=CPU, dtype=F64)(
            torch.as_tensor(_p0(6)), torch.zeros(10, dtype=F64),
            torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
    exact = run("tridiag", False)
    e_exact = _mean_px(rig, exact)
    for fused in (False, True):
        blk = run("pcg_block", fused)
        np.testing.assert_allclose(float(blk.cost), float(exact.cost),
                                   rtol=1e-2)
        assert _mean_px(rig, blk) <= e_exact * 1.01 + 0.05


def test_pcg_block_matches_jax(small_model_dict, jax_side):
    """The first LM iteration of pcg_block at 40 CG steps, fused and plain,
    against the reference's: the preconditioner and the step are the
    reference's to rounding (measured 2e-13 in params). Later iterations
    are not compared this tightly: 40 truncated CG steps on these cold-start
    systems amplify summation order (the Jacobi PCG differs from the
    reference by 7e-4 after one iteration here; tests/test_torch_fit.py)."""
    rig = make_rig(small_model_dict, 6, seed=4)
    jcam, jspec = jax_side
    for fused in (False, True):
        kw = dict(beta_pose=2.0, beta_shape=10.0, lambda_temporal=2.0,
                  max_iters=1, linear="pcg_block", cg_iters=40,
                  fused_cost=fused)
        got = build_multi_fitter(rig["spec"], rig["cam"],
                                 MultiFrameConfig(**kw), 10, device=CPU,
                                 dtype=F64)(
            torch.as_tensor(_p0(6)), torch.zeros(10, dtype=F64),
            torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
        want = j_build(jspec, jcam, JConfig(**kw), 10, dtype=jnp.float64)(
            jnp.asarray(_p0(6)), jnp.zeros(10), jnp.asarray(rig["kp"]),
            jnp.asarray(rig["r0"]))
        _assert_match(got, want)
