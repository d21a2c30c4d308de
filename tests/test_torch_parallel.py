"""The port's multi-device path (``smpltpu_torch/parallel``) on the CPU:
ranks as threads over gloo (``run_ranks``), against the port's own
one-rank and unsharded results and against the JAX package's
``smpltpu/parallel`` on its virtual 8-device mesh.

Inputs are float64 on the 300-vertex model, made from fixed seeds with
numpy (not from the suite's session ``rng``: its state depends on which
test files ran before in the same worker, and that is what made
``tests/test_parallel.py::test_sharded_frame_fit_matches_unsharded``
intermittent, ROADMAP Queue 3). The JAX results are read from
``tests/data/parallel_jax_ref.npz``, which ``python -m
tests.test_torch_parallel --record`` writes from the same inputs.

Tolerances. The reference's own (``tests/test_parallel.py:253-261``): the
sharded LM's mesh invariance at atol 1e-5, its agreement with the exact
one-device solve at atol 1e-4 and cost rtol 1e-6. Measured here, over 1,
2 and 4 ranks: the LM and the GN step agree to ~1e-11 among themselves
and with the exact solve (60 CG steps converge these 8 frames), so the
port is held to the reference's bounds and to the JAX package's results
at the same ones. Window and frame data parallelism are per-problem
independent: at 2 and 4 ranks they equal the unsharded batched fit to
1e-12. Frame DP is held to the unsharded JAX fitter (deterministic; the
JAX sharded run is not its oracle) with the scale frozen, the gauge fix
under which the two follow one trajectory (ROADMAP Queue 3).
"""

import os
import sys

import numpy as np
import pytest
import torch

from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu_torch.energy import make_skeleton_spec, project, skeleton_joints_cam
from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.models import SMPLModel
from smpltpu_torch.models.synthetic import make_synthetic_model
from smpltpu_torch.parallel import (
    build_sharded_gn_step,
    build_sharded_lm_fitter,
    frames_mesh,
    run_ranks,
    sharded_frame_fit,
    sharded_window_fit,
)
from smpltpu_torch.solve import (
    MultiFrameConfig,
    build_fitter,
    build_multi_fitter,
    make_single_frame_problem,
)
from smpltpu_torch.utils import default_intrinsics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "parallel_jax_ref.npz")
F64 = torch.float64
CFG = dict(beta_pose=2.0, beta_shape=5.0, lambda_temporal=1.5)
LM_ITERS, CG_ITERS, N_FRAMES, FRAME_ITERS = 4, 60, 8, 30
INVARIANCE_ATOL, EXACT_ATOL, EXACT_COST_RTOL = 1e-5, 1e-4, 1e-6
DP_TOL = 1e-12
FRAME_COST_RTOL, FRAME_PARAMS_ATOL = 1e-9, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rig():
    """(model, camera, spec) in float64 on the CPU."""
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=300, n_shapes=10,
                                                     seed=0),
                                device="cpu", dtype=F64)
    cam = default_intrinsics(720, 1280, device="cpu", dtype=F64)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    return model, cam, spec


def kp_batch(seed, *shape):
    """Random (deliberately unfittable) keypoints (``tests/test_parallel.py::
    _kp_batch``): (*shape, K, 4)."""
    rng = np.random.default_rng(seed)
    kp = np.zeros(shape + (N_KP_SLOTS, 4))
    kp[..., 0] = USE_SMPL
    kp[..., 1:3] = 400 + 120 * rng.normal(size=shape + (N_KP_SLOTS, 2))
    kp[..., 3] = 1.0
    return kp


def lm_inputs(f=N_FRAMES, seed=1):
    """(params0 (f, P), shape0, kp, r0) as numpy."""
    params = np.tile(init_frame_params(device="cpu", dtype=F64).numpy(), (f, 1))
    r0 = np.tile(np.asarray(init_root_rotation()), (f, 1, 1))
    return params, np.zeros(10), kp_batch(seed, f), r0


def window_inputs(n_win=6, wlen=3, seed=2):
    params = np.tile(init_frame_params(device="cpu", dtype=F64).numpy(),
                     (n_win, wlen, 1))
    r0 = np.tile(np.asarray(init_root_rotation()), (n_win, wlen, 1, 1))
    valid = np.ones((n_win, wlen))
    valid[-1, -1] = 0.0     # a padded frame in the last window
    kp = kp_batch(seed, n_win, wlen)
    kp[-1, -1, :, 3] = 0.0
    return params, np.zeros((n_win, 10)), kp, r0, valid


def frame_inputs(f=8, seed=3):
    """Realizable single-frame problems (``tests/test_parallel.py``'s frame
    DP data, from a fixed seed): keypoints projected from a true pose plus
    1 px noise, starts near it. -> (x0, kp) numpy."""
    rng = np.random.default_rng(seed)
    model, cam, _ = rig()
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=False)
    gt = np.tile(init_frame_params(device="cpu", dtype=F64).numpy(), (f, 1))
    gt[:, 7:] += 0.1 * rng.normal(size=(f, 69))
    uv = project(skeleton_joints_cam(torch.as_tensor(gt), torch.zeros(f, 10,
                                                                    dtype=F64),
                                     spec), cam).numpy()
    kp = np.zeros((f, N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(size=(f, N_KP_SLOTS, 2))
    kp[:, :, 3] = 1.0
    return gt + 0.03 * rng.normal(size=gt.shape), kp


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return dict(g)


def run_lm(n, cfg, args, valid=None):
    _, cam, spec = rig()

    def body(mesh):
        fit = build_sharded_lm_fitter(mesh, spec, cam, cfg, 10,
                                      cg_iters=CG_ITERS, dtype=F64)
        return fit(*map(t, args), None if valid is None else t(valid)), mesh.calls
    return run_ranks(n, body)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_exchange_is_a_ring_and_one_rank_is_its_own_halo(n):
    """``exchange`` shifts rows along the cyclic ring (``ppermute``); at
    one rank the partner is the rank itself, and the row comes back as it
    is; ``all_reduce`` sums and ``all_gather`` concatenates in rank
    order."""
    def body(mesh):
        r = mesh.rank
        row = torch.full((3,), float(r), dtype=F64)
        total = mesh.all_reduce(torch.tensor([r + 1.0], dtype=F64))
        return (mesh.exchange(row, 1), mesh.exchange(row, -1), total,
                mesh.all_gather(torch.tensor([r, -r])),
                mesh.shard(torch.arange(4 * n)))
    for r, (fwd, bwd, total, gathered, block) in enumerate(run_ranks(n, body)):
        assert torch.equal(fwd, torch.full((3,), (r - 1.0) % n, dtype=F64))
        assert torch.equal(bwd, torch.full((3,), (r + 1.0) % n, dtype=F64))
        assert float(total) == n * (n + 1) / 2
        assert gathered.tolist() == [v for k in range(n) for v in (k, -k)]
        assert block.tolist() == list(range(4 * r, 4 * r + 4))
    if n > 1:
        with pytest.raises(ValueError, match="not divisible"):
            run_ranks(n, lambda m: m.shard(torch.zeros(4 * n + 1)))
        with pytest.raises(ValueError, match="store"):
            frames_mesh(n, "cpu")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gn_step_mesh_invariance(golden, n):
    """One sharded GN step: the same step on 1, 2 and 4 ranks, and the JAX
    package's on 4 devices."""
    _, cam, spec = rig()
    cfg = MultiFrameConfig(max_iters=1, **CFG)
    params, w, kp, r0 = lm_inputs()

    def body(mesh):
        step = build_sharded_gn_step(mesh, spec, cam, cfg, 10,
                                     cg_iters=CG_ITERS, dtype=F64)
        return step(t(params), t(w), t(kp), t(r0))
    res = run_ranks(n, body)
    for r in res[1:]:   # every rank returns the whole result
        assert torch.equal(r.params, res[0].params)
    np.testing.assert_allclose(res[0].params.numpy(), golden["gn_params"],
                               rtol=0, atol=INVARIANCE_ATOL)
    np.testing.assert_allclose(res[0].shape.numpy(), golden["gn_shape"],
                               rtol=0, atol=INVARIANCE_ATOL)
    assert float(res[0].cg_residual) < 1e-6


@pytest.fixture(scope="module")
def lm_runs():
    """The sharded LM on ``lm_inputs`` by rank count, run once each: {n:
    [(result, collective counts) of each rank]}."""
    cfg = MultiFrameConfig(max_iters=LM_ITERS, **CFG)
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = run_lm(n, cfg, lm_inputs())
        return runs[n]
    return get


@pytest.mark.parametrize("n", [1, 2, 4])
def test_lm_mesh_invariance_and_exact_parity(golden, lm_runs, n):
    """The whole sharded LM on 1, 2 and 4 ranks reaches the one-rank
    optimum, that of the port's exact one-device fitter (tridiag) and the
    JAX package's sharded LM on 4 devices; the control state is the same
    on every rank; 4 ranks make the collectives the trips need and no
    more."""
    cfg = MultiFrameConfig(max_iters=LM_ITERS, **CFG)
    args = lm_inputs()
    outs = lm_runs(n)
    res, calls = outs[0]
    lm_one_rank = lm_runs(1)[0][0]
    for other, _ in outs[1:]:
        for a, b in zip(res, other):
            assert torch.equal(a, b)
    assert int(res.n_accepted) > 0
    np.testing.assert_allclose(res.params.numpy(), lm_one_rank.params.numpy(),
                               rtol=0, atol=INVARIANCE_ATOL)
    np.testing.assert_allclose(res.shape.numpy(), lm_one_rank.shape.numpy(),
                               rtol=0, atol=INVARIANCE_ATOL)
    _, cam, spec = rig()
    ref = build_multi_fitter(spec, cam, cfg, 10, device="cpu", dtype=F64)(
        *map(t, args))
    np.testing.assert_allclose(res.params.numpy(), ref.params.numpy(),
                               rtol=0, atol=EXACT_ATOL)
    np.testing.assert_allclose(float(res.cost), float(ref.cost),
                               rtol=EXACT_COST_RTOL)
    assert int(res.n_accepted) == int(ref.n_accepted)
    np.testing.assert_allclose(res.params.numpy(), golden["lm_params"],
                               rtol=0, atol=INVARIANCE_ATOL)
    np.testing.assert_allclose(float(res.cost), float(golden["lm_cost"]),
                               rtol=EXACT_COST_RTOL)
    np.testing.assert_allclose(res.cost_history.numpy(),
                               golden["lm_cost_history"], rtol=EXACT_COST_RTOL)
    if n > 1:
        # a CG step: two halo exchanges, two all_reduces
        assert calls["send"] == calls["recv"] > 2 * CG_ITERS * LM_ITERS
        assert calls["all_reduce"] < 2.5 * CG_ITERS * LM_ITERS


def test_lm_cg_rtol_exit(golden, lm_runs):
    """``cg_rtol``: a tight tolerance exit reproduces the fixed trips'
    optimum (the reference's bounds), on 2 ranks; as the JAX package's."""
    cfg = MultiFrameConfig(max_iters=LM_ITERS, cg_rtol=1e-10, **CFG)
    got = {0.0: lm_runs(2)[0][0], 1e-10: run_lm(2, cfg, lm_inputs())[0][0]}
    np.testing.assert_allclose(float(got[1e-10].cost), float(got[0.0].cost),
                               rtol=1e-6)
    np.testing.assert_allclose(got[1e-10].params.numpy(),
                               got[0.0].params.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[1e-10].params.numpy(),
                               golden["lm_rtol_params"], rtol=0,
                               atol=INVARIANCE_ATOL)


def test_lm_frame_valid_padding(golden):
    """Six real frames padded to eight (frame_valid = 0, keypoints masked)
    on 2 ranks reach the optimum of the exact fit of the six alone."""
    params, w, kp, r0 = lm_inputs()
    kp[6:] = 0.0
    valid = (np.arange(N_FRAMES) < 6).astype(np.float64)
    cfg = MultiFrameConfig(max_iters=LM_ITERS, **CFG)
    res = run_lm(2, cfg, (params, w, kp, r0), valid)[0][0]
    _, cam, spec = rig()
    ref = build_multi_fitter(spec, cam, cfg, 10, device="cpu", dtype=F64)(
        t(params[:6]), t(w), t(kp[:6]), t(r0[:6]))
    np.testing.assert_allclose(res.params.numpy()[:6], ref.params.numpy(),
                               rtol=0, atol=EXACT_ATOL)
    np.testing.assert_allclose(res.params.numpy(), golden["pad_params"],
                               rtol=0, atol=INVARIANCE_ATOL)


@pytest.mark.parametrize("n,chunk", [(2, 2), (3, 0)])
def test_window_dp_matches_unsharded(golden, n, chunk):
    """Window data parallelism (6 windows of 3, one frame padded), plain
    and chunked (3 local windows, chunk 2: a ragged chunk), equals the
    unsharded batched fit; and the JAX package's window DP on 2
    devices."""
    _, cam, spec = rig()
    cfg = MultiFrameConfig(beta_pose=2.0, beta_shape=1e5, lambda_temporal=1.0,
                           max_iters=15)
    fitter = build_multi_fitter(spec, cam, cfg, 10, device="cpu", dtype=F64)
    args = [t(a) for a in window_inputs()]
    ref = fitter(*args)
    got = run_ranks(n, lambda m: sharded_window_fit(m, fitter, *args,
                                                    chunk=chunk))[0]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=DP_TOL,
                                   atol=DP_TOL)
    np.testing.assert_allclose(got.cost.numpy(), golden["window_cost"],
                               rtol=EXACT_COST_RTOL)
    np.testing.assert_allclose(got.params.numpy(), golden["window_params"],
                               rtol=0, atol=EXACT_ATOL)


@pytest.fixture(scope="module")
def frame_fit():
    """(fitter, x0, kp, the unsharded fit) of the frame-DP problems: scale
    frozen (the gauge fix under which the port follows the reference's
    trajectory, ROADMAP Queue 3)."""
    model, cam, _ = rig()
    prob = make_single_frame_problem(model, init_root_rotation(), cam,
                                     beta_pose=2.0, freeze_scale=True)
    fitter = build_fitter(prob, max_iters=FRAME_ITERS, device="cpu",
                          dtype=F64)
    x0, kp = (t(a) for a in frame_inputs())
    return fitter, x0, kp, fitter(x0, kp)


@pytest.mark.parametrize("n,chunk", [(2, 0), (4, 3)])
def test_frame_dp_matches_unsharded(golden, frame_fit, n, chunk):
    """Frame data parallelism of 8 single-frame problems, plain and in
    chunks (3 does not divide the local block of 2: a pad), equals the
    unsharded fit; and the unsharded JAX fitter."""
    fitter, x0, kp, ref = frame_fit
    got = run_ranks(n, lambda m: sharded_frame_fit(m, fitter, x0, kp,
                                                   chunk=chunk))[0]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=DP_TOL,
                                   atol=DP_TOL)
    np.testing.assert_allclose(got.cost.numpy(), golden["frame_cost"],
                               rtol=FRAME_COST_RTOL)
    np.testing.assert_allclose(got.x.numpy(), golden["frame_x"], rtol=0,
                               atol=FRAME_PARAMS_ATOL)


def record(path=GOLDEN):
    """The JAX package's results on this file's inputs: the sharded GN
    step and LM on 4 of the 8 virtual devices, window DP on 2, and the
    unsharded single-frame fitter."""
    import jax.numpy as jnp

    from smpltpu.constants import init_root_rotation as j_r0
    from smpltpu.energy import make_skeleton_spec as j_spec
    from smpltpu.models import SMPLModel as JModel
    from smpltpu.parallel import frames_mesh as j_mesh
    from smpltpu.parallel import shard_frames
    from smpltpu.parallel.sharded import (
        build_sharded_gn_step as j_gn,
        build_sharded_lm_fitter as j_lm,
        sharded_window_fit as j_window,
    )
    from smpltpu.solve import build_fitter as j_build_fitter
    from smpltpu.solve import make_single_frame_problem as j_problem
    from smpltpu.solve.multi_frame import MultiFrameConfig as JConfig
    from smpltpu.solve.multi_frame import build_multi_fitter as j_multi
    from smpltpu.utils import default_intrinsics as j_intrinsics

    model = JModel.from_dict(make_synthetic_model(n_verts=300, n_shapes=10,
                                                  seed=0), dtype=jnp.float64)
    cam = j_intrinsics(720, 1280, dtype=jnp.float64)
    spec = j_spec(model, j_r0(), with_shape=True)
    out = {}
    mesh = j_mesh(4)

    def sharded(*arrs):
        return [shard_frames(mesh, jnp.asarray(a)) for a in arrs]
    params, w, kp, r0 = lm_inputs()
    step = j_gn(mesh, spec, cam, JConfig(max_iters=1, **CFG), 10,
                cg_iters=CG_ITERS, dtype=jnp.float64)
    p_s, k_s, r_s = sharded(params, kp, r0)
    res = step(p_s, jnp.asarray(w), k_s, r_s)
    out["gn_params"], out["gn_shape"] = np.asarray(res.params), np.asarray(res.shape)
    for tag, kw in (("lm", {}), ("lm_rtol", {"cg_rtol": 1e-10})):
        fit = j_lm(mesh, spec, cam, JConfig(max_iters=LM_ITERS, **CFG, **kw),
                   10, cg_iters=CG_ITERS, dtype=jnp.float64)
        res = fit(p_s, jnp.asarray(w), k_s, r_s)
        out[f"{tag}_params"] = np.asarray(res.params)
        out[f"{tag}_cost"] = np.asarray(res.cost)
        out[f"{tag}_cost_history"] = np.asarray(res.cost_history)
    kp_pad = kp.copy()
    kp_pad[6:] = 0.0
    valid = (np.arange(N_FRAMES) < 6).astype(np.float64)
    fit = j_lm(mesh, spec, cam, JConfig(max_iters=LM_ITERS, **CFG), 10,
               cg_iters=CG_ITERS, dtype=jnp.float64)
    res = fit(p_s, jnp.asarray(w), *sharded(kp_pad, r0, valid))
    out["pad_params"] = np.asarray(res.params)

    cfg_w = JConfig(beta_pose=2.0, beta_shape=1e5, lambda_temporal=1.0,
                    max_iters=15)
    st = j_window(j_mesh(2, axis="windows"),
                  j_multi(spec, cam, cfg_w, 10, dtype=jnp.float64),
                  *map(jnp.asarray, window_inputs()), axis="windows")
    out["window_params"], out["window_cost"] = (np.asarray(st.params),
                                                np.asarray(st.cost))

    prob = j_problem(model, j_r0(), cam, beta_pose=2.0, dtype=jnp.float64,
                     freeze_scale=True)
    x0, kp_f = frame_inputs()
    st = j_build_fitter(prob, max_iters=FRAME_ITERS, dtype=jnp.float64)(
        jnp.asarray(x0), jnp.asarray(kp_f))
    out["frame_x"], out["frame_cost"] = np.asarray(st.x), np.asarray(st.cost)
    np.savez(path, **out)


if __name__ == "__main__":
    # python -m tests.test_torch_parallel --record: rewrite the recorded
    # JAX results (under the test session's JAX settings: x64, CPU, eight
    # virtual devices)
    import tests.conftest  # noqa: F401

    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.test_torch_parallel --record")
    record()
