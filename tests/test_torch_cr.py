"""The port's cyclic-reduction exact solve (``linear="cr"``) against the
JAX package on the CPU in float64: the block-tridiagonal solve alone
(against the reference's ``block_tridiag_solve_cr``, run eagerly, and a
dense solve), the arrowhead solve with it, and the multi-frame fitter with
it (one window, a padded window batch, the chunked window fit and the
fused two-stage fit) against the reference's ``cr`` fits and the port's
own ``tridiag`` fits.

The reference's ``cr`` fits take XLA tens of seconds each to compile on
the CPU (it unrolls the recursion), so they are read from
``tests/data/cr_jax_ref.npz``, which ``python -m tests.test_torch_cr
--record`` writes from the same inputs.

Tolerances (f64): the solve runs the reference's operations in its order
(the same levels, the same products; out-of-range neighbours are zero
blocks where the reference gathers a clipped block and multiplies it by a
zero coupler), so it agrees with it to rounding, rtol 1e-10, and with a
dense solve to the reference's atol 1e-8 (tests/test_multi_frame.py:31-34
uses F in {1, 2, 6, 7, 8, 13, 20}). An exact step leaves no truncated CG to
amplify summation order, so the fits are held to the tridiag tolerances
of tests/test_torch_tridiag.py: 1e-9 in cost, 1e-8 in params, counts
exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

from smpltpu_torch.constants import init_root_rotation
from smpltpu_torch.models.synthetic import make_synthetic_model
from smpltpu_torch.solve import (
    MultiFrameConfig,
    build_chunked_window_fit,
    build_fused_two_stage,
    build_multi_fitter,
)
from smpltpu_torch.solve.multi_frame import arrow_tridiag
from smpltpu_torch.solve.tridiag import block_tridiag_solve, block_tridiag_solve_cr
from tests.test_torch_energy import make_rig
from tests.test_torch_tridiag import (
    SOLVE_RTOL,
    _assert_match,
    _dense,
    _p0,
    _system,
    _windows,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "cr_jax_ref.npz")
F64 = torch.float64
CPU = torch.device("cpu")
DENSE_ATOL = 1e-8
CR_FRAMES = [1, 2, 6, 7, 8, 13, 20]
CFG = dict(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
           max_iters=20, linear="cr")
WINDOW_CFG = dict(CFG, beta_shape=1e5, max_iters=40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def model_dict():
    return make_synthetic_model(n_verts=300, n_shapes=10, seed=0)


@pytest.mark.parametrize("windows", [None, 3])
@pytest.mark.parametrize("f", CR_FRAMES)
def test_block_tridiag_solve_cr_matches_jax_and_dense(f, windows):
    import jax
    import jax.numpy as jnp

    from smpltpu.solve.tridiag import block_tridiag_solve_cr as j_cr

    rng = np.random.default_rng(200 + f)
    lead = () if windows is None else (windows,)
    d, c, m, rhs = _system(rng, lead, f)
    got = block_tridiag_solve_cr(*(torch.as_tensor(x) for x in (d, c, m, rhs)))
    solve = j_cr if windows is None else jax.vmap(j_cr, in_axes=(0, 0, None, 0))
    want = np.asarray(solve(*(jnp.asarray(x) for x in (d, c, m, rhs))))
    assert got.shape == rhs.shape and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=SOLVE_RTOL,
                               atol=SOLVE_RTOL * np.abs(want).max())
    for k in np.ndindex(*lead):
        x = np.linalg.solve(_dense(d[k], c[k], m),
                            rhs[k].reshape(f * d.shape[-1], -1))
        np.testing.assert_allclose(got.numpy()[k].reshape(x.shape), x,
                                   rtol=0, atol=DENSE_ATOL)


@pytest.mark.parametrize("f", [5, 20])
def test_block_tridiag_solve_cr_matches_elimination(f):
    """The two exact solves of the port give one solution, batched over
    two leading axes."""
    rng = np.random.default_rng(300 + f)
    args = [torch.as_tensor(x) for x in _system(rng, (2, 3), f)]
    torch.testing.assert_close(block_tridiag_solve_cr(*args),
                               block_tridiag_solve(*args), rtol=SOLVE_RTOL,
                               atol=SOLVE_RTOL)


@pytest.mark.parametrize("bad_frame", [0, 3])
def test_block_tridiag_solve_cr_not_positive_definite_gives_nan(bad_frame):
    """A block that is not positive definite gives NaN, as in the
    reference and in the port's tridiag (an odd block fails in its
    level's factorization, an even one in the next level's)."""
    import jax.numpy as jnp

    from smpltpu.solve.tridiag import block_tridiag_solve_cr as j_cr

    rng = np.random.default_rng(7)
    d, c, m, rhs = _system(rng, (), 5)
    d[bad_frame] -= 50.0 * np.eye(d.shape[-1])
    got = block_tridiag_solve_cr(*(torch.as_tensor(x) for x in (d, c, m, rhs)))
    want = np.asarray(j_cr(*(jnp.asarray(x) for x in (d, c, m, rhs))))
    assert np.isnan(want).any() and torch.isnan(got).any()


@pytest.mark.parametrize("f", [1, 7])
def test_arrow_tridiag_cr_matches_dense(f):
    """The arrowhead solve with ``linear="cr"`` (cyclic reduction, then the
    shape Schur complement), on two windows, against a dense solve."""
    rng = np.random.default_rng(40 + f)
    d, c, m, _ = _system(rng, (2,), f)
    n_s, p = 3, d.shape[-1]
    b = rng.normal(size=(2, f, p, n_s)) * 0.2
    cw = rng.normal(size=(2, n_s, n_s))
    c_reg = cw @ np.swapaxes(cw, -1, -2) + 2.0 * np.eye(n_s)
    g_p, g_w = rng.normal(size=(2, f, p)), rng.normal(size=(2, n_s))
    args = [torch.as_tensor(x) for x in (d, c, m, b, c_reg, g_p, g_w)]
    dp, dw = arrow_tridiag(*args, linear="cr")
    for k in range(2):
        a = np.zeros((f * p + n_s,) * 2)
        a[:f * p, :f * p] = _dense(d[k], c[k], m)
        a[:f * p, f * p:] = b[k].reshape(f * p, n_s)
        a[f * p:, :f * p] = a[:f * p, f * p:].T
        a[f * p:, f * p:] = c_reg[k]
        x = np.linalg.solve(a, -np.concatenate([g_p[k].ravel(), g_w[k]]))
        np.testing.assert_allclose(dp[k].numpy().ravel(), x[:f * p],
                                   rtol=0, atol=DENSE_ATOL)
        np.testing.assert_allclose(dw[k].numpy(), x[f * p:], rtol=0,
                                   atol=DENSE_ATOL)
    tri = arrow_tridiag(*args)
    for a, b in zip((dp, dw), tri):
        torch.testing.assert_close(a, b, rtol=SOLVE_RTOL, atol=SOLVE_RTOL)


def _fit(rig, kw, *args):
    fit = build_multi_fitter(rig["spec"], rig["cam"], MultiFrameConfig(**kw),
                             10, device=CPU, dtype=F64)
    return fit(*(torch.as_tensor(a) for a in args))


def _recorded(golden, tag):
    from smpltpu_torch.solve import MultiFrameResult
    return MultiFrameResult(*(golden[f"{tag}_{k}"]
                              for k in MultiFrameResult._fields))


def stage1_inputs(model_dict):
    rig = make_rig(model_dict, 8, seed=21)
    return rig, (_p0(8), np.zeros(10), rig["kp"], rig["r0"])


def window_inputs(model_dict):
    rig = make_rig(model_dict, 18, seed=22)
    p0w, kpw, r0w, vw = _windows(rig, [0, 5, 10, 15], 6)
    shape0 = np.tile(0.1 * rig["rng"].normal(size=10), (4, 1))
    return rig, (p0w, shape0, kpw, r0w, vw)


def two_stage_inputs(model_dict):
    """tests/test_torch_fit.py's fused two-stage case: 40 frames, anchors
    every 10th, 8-frame windows with overlap 2 (the last ones padded)."""
    n, skip, wsize, overlap = 40, 10, 8, 2
    rig = make_rig(model_dict, n, seed=9)
    anchor_idx = np.arange(0, n, skip)
    starts = list(range(0, n, wsize - overlap))
    kpw = np.zeros((len(starts), wsize) + rig["kp"].shape[1:])
    vw = np.zeros((len(starts), wsize))
    for i, s in enumerate(starts):
        e = min(s + wsize, n)
        kpw[i, :e - s] = rig["kp"][s:e]
        vw[i, :e - s] = 1.0
    r0w = np.tile(init_root_rotation(), (len(starts), wsize, 1, 1))
    common = dict(beta_pose=5.0, lambda_temporal=3.0, linear="cr",
                  fused_cost=True)
    cfgs = (dict(common, beta_shape=25.0, max_iters=10),
            dict(common, beta_shape=1e5, max_iters=5))
    args = (_p0(len(anchor_idx)), np.zeros(10), rig["kp"][anchor_idx],
            rig["r0"][anchor_idx], kpw, r0w, vw)
    return rig, cfgs, (anchor_idx, starts, wsize, n), args


@pytest.mark.parametrize("fused_cost", [True, False])
def test_stage1_cr_matches_jax_and_tridiag(model_dict, golden, fused_cost):
    """Stage 1 as the CLI runs it: one unbatched 8-frame solve."""
    rig, args = stage1_inputs(model_dict)
    kw = dict(CFG, fused_cost=fused_cost)
    got = _fit(rig, kw, *args)
    assert got.params.shape == (8, 76) and int(got.n_accepted) > 3
    _assert_match(got, _recorded(golden, f"stage1_{int(fused_cost)}"))
    _assert_match(got, _fit(rig, dict(kw, linear="tridiag"), *args))


@pytest.mark.parametrize("fused_cost", [True, False])
def test_padded_window_batch_cr_matches_jax_and_tridiag(model_dict, golden,
                                                         fused_cost):
    """Four 6-frame windows as one batch, the last two padded, under the
    stage-2 shape lock; the windows converge at different trips."""
    rig, args = window_inputs(model_dict)
    kw = dict(WINDOW_CFG, fused_cost=fused_cost)
    got = _fit(rig, kw, *args)
    valid = args[-1] > 0
    assert len(set(got.iters_run.tolist())) > 2
    _assert_match(got, _recorded(golden, f"windows_{int(fused_cost)}"),
                  param_mask=valid)
    _assert_match(got, _fit(rig, dict(kw, linear="tridiag"), *args),
                  param_mask=valid)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_window_fit_cr_matches_jax(model_dict, golden, chunk):
    """The chunked window fit with cr: chunks of 1 and 3 of the four
    windows give the reference's batched results."""
    rig, args = window_inputs(model_dict)
    fit = build_multi_fitter(rig["spec"], rig["cam"],
                             MultiFrameConfig(**dict(WINDOW_CFG, fused_cost=True)),
                             10, device=CPU, dtype=F64)
    got = build_chunked_window_fit(fit, chunk)(*(torch.as_tensor(a)
                                                 for a in args))
    _assert_match(got, _recorded(golden, "windows_1"), param_mask=args[-1] > 0)


def test_fit_multi_frame_cr_matches_jax(model_dict, golden, monkeypatch):
    """The cached ``fit_multi_frame`` takes cr through its fitter."""
    from smpltpu_torch.solve import fit_multi_frame, multi_frame

    monkeypatch.setattr(multi_frame, "_multi_cache", {})
    rig, args = stage1_inputs(model_dict)
    got = fit_multi_frame(rig["spec"], rig["cam"],
                          MultiFrameConfig(**dict(CFG, fused_cost=True)),
                          *(torch.as_tensor(a) for a in args))
    _assert_match(got, _recorded(golden, "stage1_1"))


def test_sharded_window_fit_cr_matches_jax(model_dict, golden):
    """Window data parallelism on two gloo ranks (threads) with the cr
    fitter: each rank's block of the windows, gathered, gives the
    reference's batched results."""
    from smpltpu_torch.parallel import run_ranks, sharded_window_fit

    rig, args = window_inputs(model_dict)
    fit = build_multi_fitter(rig["spec"], rig["cam"],
                             MultiFrameConfig(**dict(WINDOW_CFG, fused_cost=True)),
                             10, device=CPU, dtype=F64)
    res = run_ranks(2, lambda mesh: sharded_window_fit(
        mesh, fit, *(torch.as_tensor(a) for a in args)))
    for r in res:
        _assert_match(r, _recorded(golden, "windows_1"),
                      param_mask=args[-1] > 0)


def test_fused_two_stage_cr_matches_jax_and_tridiag(model_dict, golden):
    rig, (cfg1, cfg2), geo, args = two_stage_inputs(model_dict)

    def run(linear):
        return build_fused_two_stage(
            rig["spec"], rig["cam"], MultiFrameConfig(**dict(cfg1, linear=linear)),
            MultiFrameConfig(**dict(cfg2, linear=linear)), 10, *geo,
            device=CPU, dtype=F64)(*map(torch.as_tensor, args))
    st1, st2 = run("cr")
    valid = args[-1] > 0
    _assert_match(st1, _recorded(golden, "two_stage1"))
    _assert_match(st2, _recorded(golden, "two_stage2"), param_mask=valid)
    t1, t2 = run("tridiag")
    _assert_match(st1, t1)
    _assert_match(st2, t2, param_mask=valid)


def record(path=GOLDEN):
    """The JAX package's ``cr`` fits on this file's inputs (jit, f64)."""
    import jax
    import jax.numpy as jnp

    import smpltpu.energy as jen
    from smpltpu.constants import init_root_rotation as j_r0
    from smpltpu.models import SMPLModel as JModel
    from smpltpu.solve import MultiFrameConfig as JConfig
    from smpltpu.solve import build_fused_two_stage as j_two_stage
    from smpltpu.solve import build_multi_fitter as j_build
    from smpltpu.utils import default_intrinsics as j_intrinsics
    from tests.test_torch_energy import H_IMG, W_IMG

    md = make_synthetic_model(n_verts=300, n_shapes=10, seed=0)
    jm = JModel.from_dict(md, dtype=jnp.float64)
    cam = j_intrinsics(W_IMG, H_IMG, dtype=jnp.float64)
    spec = jen.make_skeleton_spec(jm, j_r0(), with_shape=True)
    out = {}

    def keep(tag, res):
        for k, v in res._asdict().items():
            out[f"{tag}_{k}"] = np.asarray(v)
    _, args = stage1_inputs(md)
    for fused in (1, 0):
        fit = j_build(spec, cam, JConfig(**dict(CFG, fused_cost=bool(fused))),
                      10, dtype=jnp.float64)
        keep(f"stage1_{fused}", fit(*map(jnp.asarray, args)))
    _, (p0w, shape0, kpw, r0w, vw) = window_inputs(md)
    for fused in (1, 0):
        fit = j_build(spec, cam,
                      JConfig(**dict(WINDOW_CFG, fused_cost=bool(fused))), 10,
                      dtype=jnp.float64)
        keep(f"windows_{fused}", jax.jit(jax.vmap(fit))(
            *map(jnp.asarray, (p0w, shape0, kpw, r0w, vw))))
    _, (cfg1, cfg2), geo, args = two_stage_inputs(md)
    w1, w2 = j_two_stage(spec, cam, JConfig(**cfg1), JConfig(**cfg2), 10,
                         *geo, dtype=jnp.float64)(*map(jnp.asarray, args))
    keep("two_stage1", w1)
    keep("two_stage2", w2)
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_cr --record: rewrite the recorded JAX
    # results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_cr --record")
    record()
