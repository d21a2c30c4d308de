"""bench.py's long-video recipe through the port against the JAX package on
the CPU in float64, at a small size: stage 1 on every 10th frame as one
window, the anchors interpolated into the window starts, stage 2 in chunks
of windows (bench.py with BENCH_CHUNK > 0, 64 CG steps). The port's side
is the multi CLI's sequential route for long videos
(``--batched-windows --init-from-anchors --window-chunk N``):
``build_multi_fitter`` on the anchors, the CLI's host interpolation
(``pipeline/multi.py::interpolate_from_anchors``) and window packing
(``window_inputs``), then ``build_chunked_window_fit``. The reference side
is bench.py's sequence: ``smpltpu.solve.build_multi_fitter`` on the
anchors, bench.py's host interpolation loop, then
``build_chunked_window_fit`` on the windows.

Size: the 300-vertex synthetic model, 60 frames, anchors every 10th,
windows of 8 with overlap 2 (10 windows, the last ones padded), chunks of
3 (the last chunk ragged: one window), 64 CG steps. The reference's fits
take XLA tens of seconds to compile on the CPU, so they are read from
``tests/data/long_jax_ref.npz``, which ``python -m tests.test_torch_long
--record`` writes from the same inputs.

Tolerances (f64): with ``linear="tridiag"`` the exact solve's 1e-9 in
cost and 1e-8 in params, counts exact (tests/test_torch_tridiag.py). With
``linear="pcg"`` the final cost, params and shape are held to the port's
PCG tolerance, 2e-5 and 5e-4, counts exact (tests/test_torch_fit.py: a
truncated CG amplifies summation order). The cost history on the way is
held to the reference's own spread, recorded beside its results: the
same solves in a second layout (stage 1 under ``jax.vmap``, stage 2 as
one batch) move the reference's history by up to 3.8e-3 (stage 1;
stage 2: 3.5e-4), because the CG truncated at 64 steps carries the
summation order into every trip's cost before convergence. The port
against the reference moves it by up to 1.4e-3 (both stages), the port's
chunks against its own one batch by 7.0e-4, while the final costs agree
to 3.4e-7.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from smpltpu_torch.constants import init_root_rotation
from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.models.synthetic import make_synthetic_model
from smpltpu_torch.pipeline.multi import (
    interpolate_from_anchors,
    window_inputs,
)
from smpltpu_torch.solve import (
    MultiFrameConfig,
    MultiFrameResult,
    build_chunked_window_fit,
    build_multi_fitter,
)
from smpltpu_torch.solve.two_stage import interp_tables, interpolate_anchors
from tests import test_torch_fit, test_torch_tridiag
from tests.test_torch_energy import make_rig
from tests.test_torch_tridiag import _p0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "long_jax_ref.npz")
F64 = torch.float64
CPU = torch.device("cpu")
N_FRAMES, SKIP, WSIZE, OVERLAP, CHUNK, CG_ITERS = 60, 10, 8, 2, 3, 64
COMMON = dict(beta_pose=5.0, lambda_temporal=3.0, cg_iters=CG_ITERS,
              fused_cost=True)
CFG1 = dict(COMMON, beta_shape=25.0, max_iters=40)
CFG2 = dict(COMMON, beta_shape=1e5, max_iters=40)


def history_rtol(golden):
    """The reference's largest move of its own cost history between two
    layouts of the same solves, as recorded beside its results."""
    return float(max(golden["pcg_stage1_history_spread"],
                     golden["pcg_stage2_history_spread"]))


def _assert_pcg_match(got, want, param_mask=None, *, history_rtol):
    """The PCG fits: counts exact, the optimum (final cost, params, shape)
    to tests/test_torch_fit.py's tolerances, the history to
    ``history_rtol``."""
    for field in ("iters_run", "converged", "n_accepted"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(want.cost),
                               rtol=test_torch_fit.COST_RTOL, atol=0)
    np.testing.assert_allclose(np.asarray(got.cost_history),
                               np.asarray(want.cost_history),
                               rtol=history_rtol, atol=0)
    gp, wp = np.asarray(got.params), np.asarray(want.params)
    if param_mask is not None:
        gp, wp = gp[param_mask], wp[param_mask]
    np.testing.assert_allclose(gp, wp, rtol=0,
                               atol=test_torch_fit.PARAM_ATOL)
    np.testing.assert_allclose(np.asarray(got.shape), np.asarray(want.shape),
                               rtol=0, atol=test_torch_fit.PARAM_ATOL)


def matcher(linear, golden):
    """The assertion holding a ``linear`` fit to another."""
    if linear == "pcg":
        return functools.partial(_assert_pcg_match,
                                 history_rtol=history_rtol(golden))
    return test_torch_tridiag._assert_match


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dict():
    return make_synthetic_model(n_verts=300, n_shapes=10, seed=0)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def long_inputs(model_dict):
    """The video, its anchors and its window batch as bench.py builds them
    (bench.py:122-132): windows past the end padded with masked keypoints
    and frame_valid 0. Returns (rig, (anchor_idx, starts, WSIZE,
    N_FRAMES), the fused fit's arguments)."""
    rig = make_rig(model_dict, N_FRAMES, seed=31)
    anchor_idx = np.arange(0, N_FRAMES, SKIP)
    starts = list(range(0, N_FRAMES, WSIZE - OVERLAP))
    kpw = np.zeros((len(starts), WSIZE) + rig["kp"].shape[1:])
    vw = np.zeros((len(starts), WSIZE))
    for i, s in enumerate(starts):
        e = min(s + WSIZE, N_FRAMES)
        kpw[i, :e - s] = rig["kp"][s:e]
        vw[i, :e - s] = 1.0
    r0w = np.tile(init_root_rotation(), (len(starts), WSIZE, 1, 1))
    args = (_p0(len(anchor_idx)), np.zeros(10), rig["kp"][anchor_idx],
            rig["r0"][anchor_idx], kpw, r0w, vw)
    return rig, (anchor_idx, starts, WSIZE, N_FRAMES), args


def host_interpolation(anchor_params, anchor_idx, n_frames):
    """bench.py's host loop (bench.py:203-211), which the multi CLI's
    ``--init-from-anchors`` also runs: frame i between anchors k and k+1
    gets the lerp of their params, frames past the last anchor its params."""
    poses = np.zeros((n_frames, anchor_params.shape[1]), anchor_params.dtype)
    for k, fid in enumerate(anchor_idx):
        nxt = anchor_idx[k + 1] if k + 1 < len(anchor_idx) else n_frames
        pb = (anchor_params[k + 1] if k + 1 < len(anchor_idx)
              else anchor_params[k])
        for i in range(fid, min(nxt, n_frames)):
            t = (i - fid) / max(nxt - fid, 1)
            poses[i] = (1 - t) * anchor_params[k] + t * pb
    return poses


def port_fit(rig, geo, args, linear, chunk):
    """The multi CLI's sequential route for long videos
    (``--batched-windows --init-from-anchors --window-chunk chunk``):
    stage 1 on the anchors, the CLI's host interpolation and window
    packing, then the windows through ``build_chunked_window_fit`` (chunk
    0: one batch). Returns (stage-1 result, stage-2 result)."""
    anchor_idx, starts, wsize, n = geo
    p0a, shape0, kpa, r0a = map(torch.as_tensor, args[:4])
    fit1 = build_multi_fitter(rig["spec"], rig["cam"],
                              MultiFrameConfig(**CFG1, linear=linear), 10,
                              device=CPU, dtype=F64)
    st1 = fit1(p0a, shape0, kpa, r0a)
    default_pose = init_frame_params(device=CPU, dtype=F64).numpy()
    poses = np.tile(default_pose, (n, 1))
    interpolate_from_anchors(poses, anchor_idx, st1.params.numpy())
    packs = [window_inputs(s, wsize, poses, rig["r0"], rig["kp"],
                           default_pose) for s in starts]
    bp, bk, br, bv = (torch.as_tensor(np.stack([p[j] for p in packs]),
                                      dtype=F64) for j in (1, 2, 3, 4))
    bw = st1.shape.expand(len(starts), -1)
    fit2 = build_multi_fitter(rig["spec"], rig["cam"],
                              MultiFrameConfig(**CFG2, linear=linear), 10,
                              device=CPU, dtype=F64)
    if chunk:
        fit2 = build_chunked_window_fit(fit2, chunk)
    return st1, fit2(bp, bw, bk, br, bv)


def _recorded(golden, tag):
    return MultiFrameResult(*(golden[f"{tag}_{k}"]
                              for k in MultiFrameResult._fields))


@pytest.mark.parametrize("linear", ["pcg", "tridiag"])
def test_long_recipe_matches_jax(model_dict, golden, linear):
    """Stage 1 on the 6 anchors, then 10 windows in chunks of 3 (3, 3, 3
    and a ragged 1): both stages against the reference's sequential
    recipe; the windows converge at different trips, so each chunk stops
    at its own."""
    rig, geo, args = long_inputs(model_dict)
    st1, st2 = port_fit(rig, geo, args, linear, CHUNK)
    assert st1.params.shape == (N_FRAMES // SKIP, 76)
    assert st2.params.shape == (10, WSIZE, 76)
    match = matcher(linear, golden)
    match(st1, _recorded(golden, f"{linear}_stage1"))
    match(st2, _recorded(golden, f"{linear}_stage2"), param_mask=args[-1] > 0)
    trips = [int(st2.iters_run[s:s + CHUNK].max()) for s in range(0, 10, CHUNK)]
    assert len(set(trips)) > 1


@pytest.mark.parametrize("linear", ["pcg", "tridiag"])
def test_chunked_stage2_matches_one_batch(model_dict, golden, linear):
    """A converged window keeps its state, so chunks of 3 and of 1 give
    each window the result of one batch of all ten (the port's PCG ends
    no window's CG on another's residual), to the rounding that the batch
    width moves: the exact solve's 1e-9, the PCG's tolerances."""
    rig, geo, args = long_inputs(model_dict)
    _, whole = port_fit(rig, geo, args, linear, 0)
    valid = args[-1] > 0
    match = matcher(linear, golden)
    for chunk in (CHUNK, 1):
        _, st2 = port_fit(rig, geo, args, linear, chunk)
        match(st2, whole, param_mask=valid)


def test_interpolation_at_100k_frames_matches_host_loop():
    """Over the 100 000-frame video's 10 000 anchors the fused fit's
    interpolation and the multi CLI's host loop give bench.py's host
    loop's poses bit for bit (the lerp is the same two products and a sum
    in f64)."""
    n = 100_000
    anchor_idx = np.arange(0, n, 10)
    ap = np.random.default_rng(5).normal(size=(len(anchor_idx), 76))
    want = host_interpolation(ap, anchor_idx, n)
    seg, hi, t = interp_tables(anchor_idx, n)
    fused = interpolate_anchors(torch.as_tensor(ap), torch.as_tensor(seg),
                                torch.as_tensor(hi),
                                torch.as_tensor(t)[:, None]).numpy()
    np.testing.assert_array_equal(fused, want)
    cli = np.zeros_like(ap, shape=(n, ap.shape[1]))
    interpolate_from_anchors(cli, anchor_idx, ap)
    np.testing.assert_array_equal(cli, want)


def record(path=GOLDEN):
    """bench.py's long recipe in the JAX package on this file's inputs
    (f64): stage 1 by ``build_multi_fitter``, the host interpolation, then
    ``build_chunked_window_fit`` in chunks of CHUNK."""
    import jax
    import jax.numpy as jnp

    import smpltpu.energy as jen
    from smpltpu.constants import init_root_rotation as j_r0
    from smpltpu.energy.params import init_frame_params as j_init
    from smpltpu.models import SMPLModel as JModel
    from smpltpu.solve import MultiFrameConfig as JConfig
    from smpltpu.solve import build_chunked_window_fit as j_chunked
    from smpltpu.solve import build_multi_fitter as j_build
    from smpltpu.utils import default_intrinsics as j_intrinsics
    from tests.test_torch_energy import H_IMG, W_IMG

    md = make_synthetic_model(n_verts=300, n_shapes=10, seed=0)
    jm = JModel.from_dict(md, dtype=jnp.float64)
    cam = j_intrinsics(W_IMG, H_IMG, dtype=jnp.float64)
    spec = jen.make_skeleton_spec(jm, j_r0(), with_shape=True)
    _, (anchor_idx, starts, wsize, n), args = long_inputs(md)
    p0a, shape0, kpa, r0a, kpw, r0w, vw = args
    out = {}
    for linear in ("pcg", "tridiag"):
        fit1 = j_build(spec, cam, JConfig(**CFG1, linear=linear), 10,
                       dtype=jnp.float64)
        st1 = fit1(*map(jnp.asarray, (p0a, shape0, kpa, r0a)))
        poses = host_interpolation(np.asarray(st1.params), anchor_idx, n)
        p0w = np.tile(np.asarray(j_init(), np.float64), (len(starts), wsize, 1))
        for i, s in enumerate(starts):
            e = min(s + wsize, n)
            p0w[i, :e - s] = poses[s:e]
        w0 = np.tile(np.asarray(st1.shape), (len(starts), 1))
        fit2 = j_build(spec, cam, JConfig(**CFG2, linear=linear), 10,
                       dtype=jnp.float64)
        st2 = j_chunked(fit2, CHUNK)(*map(jnp.asarray, (p0w, w0, kpw, r0w, vw)))
        for tag, res in (("stage1", st1), ("stage2", st2)):
            for k, v in res._asdict().items():
                out[f"{linear}_{tag}_{k}"] = np.asarray(v)
        if linear == "pcg":
            # the reference against itself in a second layout of the same
            # solves: stage 1 under jax.vmap, stage 2 as one batch
            st1_v = jax.vmap(fit1)(*(jnp.asarray(a)[None] for a in
                                     (p0a, shape0, kpa, r0a)))
            st2_b = j_chunked(fit2, len(starts))(
                *map(jnp.asarray, (p0w, w0, kpw, r0w, vw)))
            for tag, a, b in (("stage1", st1, st1_v), ("stage2", st2, st2_b)):
                ha = np.atleast_2d(np.asarray(a.cost_history))
                hb = np.asarray(b.cost_history).reshape(ha.shape)
                out[f"pcg_{tag}_history_spread"] = np.max(
                    np.abs(ha - hb) / np.abs(ha))
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_long --record: rewrite the recorded JAX
    # results (under the test session's JAX settings: x64, CPU)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_long --record")
    record()
