"""The port's multi-frame LM, fused two-stage pipeline and frame evaluation
against the JAX package on the CPU in float64, on keypoints made with
numpy. ``linear="pcg"`` on both sides: the JAX "pcg" loop is the same
recursion as the kernel path ("pcg_kernel"), and on the CPU the port's
"pcg_kernel" takes the same plain loop.

Tolerances (f64): cost rtol 2e-5 and params atol 5e-4, iteration and
acceptance counts exact. Both sides run the same arithmetic in another
summation order (~1e-15 relative per step), but a CG truncated at 16-24
steps on these ill-conditioned systems amplifies that: the first steps
agree to 1e-13, and from the step where the damping gets small the costs
drift apart at 1e-7..5e-6. The reference does no better against itself:
the same windows through its fitter alone and under jax.vmap differ by up
to 7.8e-6 in cost and 1.05e-4 in params (tests/test_two_stage.py allows
1e-6 and 1e-3 between its own two compilations). 2e-5 / 5e-4 hold that
drift; a wrong term, guard or rule in the step moves the cost by 1e-3 or
more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smpltpu.energy as jen
from smpltpu.constants import init_root_rotation
from smpltpu.models import SMPLModel as JModel
from smpltpu.pipeline.common import batched_frame_eval as j_frame_eval
from smpltpu.render.jax_raster import pick_patch, rasterize_zbuffer
from smpltpu.render.pallas_raster import render_overlay_tiled
from smpltpu.solve import MultiFrameConfig as JConfig
from smpltpu.solve import build_fused_two_stage as j_two_stage
from smpltpu.solve import build_multi_fitter as j_build
from smpltpu.utils import default_intrinsics as j_intrinsics
from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.pipeline import common as pipeline_common
from smpltpu_torch.pipeline.common import (
    batched_frame_eval,
    overlay_image,
    render_frames,
)
from smpltpu_torch.solve import (
    MultiFrameConfig,
    build_fused_two_stage,
    build_multi_fitter,
)
from tests.test_torch_energy import H_IMG, W_IMG, make_rig

F64 = torch.float64
CPU = torch.device("cpu")
COST_RTOL, PARAM_ATOL = 2e-5, 5e-4


@pytest.fixture(scope="module")
def jax_side(small_model_dict):
    jm = JModel.from_dict(small_model_dict, dtype=jnp.float64)
    cam = j_intrinsics(W_IMG, H_IMG, dtype=jnp.float64)
    spec = jen.make_skeleton_spec(jm, init_root_rotation(), with_shape=True)
    return jm, cam, spec


def _p0(n, depth=3.0):
    return np.tile(init_frame_params(depth=depth, device=CPU, dtype=F64).numpy(),
                   (n, 1))


def _assert_results_match(got, want, param_mask=None):
    np.testing.assert_array_equal(np.asarray(got.iters_run),
                                  np.asarray(want.iters_run))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(np.asarray(got.n_accepted),
                                  np.asarray(want.n_accepted))
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(want.cost),
                               rtol=COST_RTOL, atol=0)
    np.testing.assert_allclose(np.asarray(got.cost_history),
                               np.asarray(want.cost_history),
                               rtol=COST_RTOL, atol=0)
    gp, wp = np.asarray(got.params), np.asarray(want.params)
    if param_mask is not None:
        gp, wp = gp[param_mask], wp[param_mask]
    np.testing.assert_allclose(gp, wp, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(np.asarray(got.shape), np.asarray(want.shape),
                               rtol=0, atol=PARAM_ATOL)


CFG = dict(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
           max_iters=25, linear="pcg", cg_iters=24)


@pytest.mark.parametrize("fused_cost,dogleg", [(True, True), (False, True),
                                               (True, False)])
def test_single_window_matches_jax(small_model_dict, jax_side, fused_cost,
                                   dogleg):
    """One 5-frame window, shared shape: the product path (dogleg, fused
    cost), the separate cost pass, and ceres-style damping."""
    rig = make_rig(small_model_dict, 5, seed=7)
    kw = dict(CFG, fused_cost=fused_cost, dogleg=dogleg)
    fit = build_multi_fitter(rig["spec"], rig["cam"], MultiFrameConfig(**kw),
                             10, device=CPU, dtype=F64)
    got = fit(torch.as_tensor(_p0(5)), torch.zeros(10, dtype=F64),
              torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
    _, jcam, jspec = jax_side
    jfit = j_build(jspec, jcam, JConfig(**kw), 10, dtype=jnp.float64)
    want = jfit(jnp.asarray(_p0(5)), jnp.zeros(10), jnp.asarray(rig["kp"]),
                jnp.asarray(rig["r0"]))
    assert got.params.shape == (5, 76) and got.cost_history.shape == (25,)
    _assert_results_match(got, want)
    assert float(got.cost) < float(got.cost_history[0]) or int(got.iters_run) == 0


def test_padded_window_batch_matches_jax_vmap(small_model_dict, jax_side):
    """Three 6-frame windows solved as one batch, the last two frames of the
    third window padding (masked keypoints, frame_valid 0), against
    jax.vmap of the reference fitter; the windows converge at different
    trips, so the masked loop's freeze is exercised."""
    rig = make_rig(small_model_dict, 16, seed=8)
    n_win, f = 3, 6
    kpw = np.stack([rig["kp"][s:s + f] for s in (0, 5, 10)])
    r0w = np.stack([rig["r0"][s:s + f] for s in (0, 5, 10)])
    vw = np.ones((n_win, f))
    vw[2, 4:] = 0.0
    kpw[2, 4:, :, 3] = 0.0
    p0w = np.stack([_p0(f, depth=d) for d in (3.0, 3.1, 3.3)])
    shape0 = 0.1 * rig["rng"].normal(size=10)
    kw = dict(CFG, beta_shape=1e3, max_iters=30, fused_cost=True)
    fit = build_multi_fitter(rig["spec"], rig["cam"], MultiFrameConfig(**kw),
                             10, device=CPU, dtype=F64)
    got = fit(torch.as_tensor(p0w), torch.as_tensor(shape0),
              torch.as_tensor(kpw), torch.as_tensor(r0w), torch.as_tensor(vw))
    _, jcam, jspec = jax_side
    jfit = j_build(jspec, jcam, JConfig(**kw), 10, dtype=jnp.float64)
    want = jax.jit(jax.vmap(lambda a, c, d, e: jfit(a, jnp.asarray(shape0),
                                                    c, d, e)))(
        jnp.asarray(p0w), jnp.asarray(kpw), jnp.asarray(r0w), jnp.asarray(vw))
    _assert_results_match(got, want, param_mask=vw > 0)


def test_fused_two_stage_matches_jax(small_model_dict, jax_side):
    """40 frames, anchors every 10th frame, 8-frame windows with overlap 2
    (the last windows run past the video end and are padded), 10/5 LM
    iterations, 16 CG steps."""
    n, skip, wsize, overlap = 40, 10, 8, 2
    rig = make_rig(small_model_dict, n, seed=9)
    anchor_idx = np.arange(0, n, skip)
    starts = list(range(0, n, wsize - overlap))
    kpw = np.zeros((len(starts), wsize) + rig["kp"].shape[1:])
    vw = np.zeros((len(starts), wsize))
    for i, s in enumerate(starts):
        e = min(s + wsize, n)
        kpw[i, :e - s] = rig["kp"][s:e]
        vw[i, :e - s] = 1.0
    r0w = np.tile(init_root_rotation(), (len(starts), wsize, 1, 1))
    common = dict(beta_pose=5.0, lambda_temporal=3.0, linear="pcg",
                  cg_iters=16, fused_cost=True)
    cfg1 = dict(common, beta_shape=25.0, max_iters=10)
    cfg2 = dict(common, beta_shape=1e5, max_iters=5)
    args = (_p0(len(anchor_idx)), np.zeros(10), rig["kp"][anchor_idx],
            rig["r0"][anchor_idx], kpw, r0w, vw)

    run = build_fused_two_stage(rig["spec"], rig["cam"],
                                MultiFrameConfig(**cfg1),
                                MultiFrameConfig(**cfg2), 10,
                                anchor_idx, starts, wsize, n, device=CPU,
                                dtype=F64)
    st1, st2 = run(*map(torch.as_tensor, args))
    _, jcam, jspec = jax_side
    jrun = j_two_stage(jspec, jcam, JConfig(**cfg1), JConfig(**cfg2), 10,
                       anchor_idx, starts, wsize, n, dtype=jnp.float64)
    w1, w2 = jrun(*map(jnp.asarray, args))
    assert st1.params.shape == (len(anchor_idx), 76)
    assert st2.params.shape == (len(starts), wsize, 76)
    _assert_results_match(st1, w1)
    _assert_results_match(st2, w2, param_mask=vw > 0)


def test_linear_options(small_model_dict):
    """pcg_kernel takes the same plain loop on the CPU; cyclic reduction
    ("cr") gives the fit of the exact "tridiag" solve (both held against
    the reference in tests/test_torch_tridiag.py and test_torch_cr.py, the
    block preconditioner in tests/test_torch_single.py); an unknown name
    raises."""
    rig = make_rig(small_model_dict, 4, seed=10)
    outs = {}
    for lin in ("pcg", "pcg_kernel"):
        fit = build_multi_fitter(
            rig["spec"], rig["cam"],
            MultiFrameConfig(**dict(CFG, linear=lin, max_iters=4,
                                    fused_cost=True)), 10,
            device=CPU, dtype=F64)
        outs[lin] = fit(torch.as_tensor(_p0(4)), torch.zeros(10, dtype=F64),
                        torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
    for a, b in zip(outs["pcg"], outs["pcg_kernel"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the two exact solves (elimination and cyclic reduction) give one fit
    exact = {}
    for lin in ("tridiag", "cr"):
        exact[lin] = build_multi_fitter(
            rig["spec"], rig["cam"],
            MultiFrameConfig(**dict(CFG, linear=lin, max_iters=4,
                                    fused_cost=True)), 10,
            device=CPU, dtype=F64)(
            torch.as_tensor(_p0(4)), torch.zeros(10, dtype=F64),
            torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"]))
    _assert_results_match(exact["cr"], exact["tridiag"])
    with pytest.raises(ValueError, match="unknown linear solver"):
        build_multi_fitter(rig["spec"], rig["cam"],
                           MultiFrameConfig(**dict(CFG, linear="pcg-kernel")),
                           10, device=CPU, dtype=F64)


def test_batched_frame_eval_and_render_match_jax(small_model_dict, jax_side):
    """Per-frame errors (scale discarded, full-model joints) and skinned
    vertices through the LBS path, f64: 1e-10 (same sums, other order);
    the overlay render of a frame through the host painter, and through
    the z-buffer pixel for pixel against ``render_overlay_tiled``."""
    rig = make_rig(small_model_dict, 7, seed=11)
    params = rig["gt"].copy()
    params[:, 0] = 1.1
    shapes = np.tile(rig["shape"], (7, 1))
    err, verts = batched_frame_eval(rig["model"], params, shapes, rig["r0"],
                                    rig["kp"], rig["cam"])
    jm, jcam, _ = jax_side
    jerr, jverts = j_frame_eval(jm, params, shapes, rig["r0"], rig["kp"], jcam)
    np.testing.assert_allclose(err, jerr, rtol=0, atol=1e-10)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-10)
    img = np.zeros((H_IMG, W_IMG, 3), np.uint8)
    out = overlay_image(rig["model"], verts[0], img, rig["cam"])
    assert out is img and int((img > 0).any(axis=-1).sum()) > 0
    # the on-device path (K3's plain version on the CPU) over a frame that
    # already holds the host render, pixel for pixel against the reference
    want = render_overlay_tiled(jverts[0], jm.faces, img,
                                *(float(c) for c in jcam))
    out = overlay_image(rig["model"], verts[0], img, rig["cam"],
                        use_jax=True)
    assert out is img
    np.testing.assert_array_equal(img, want)


def test_render_frames_matches_jax(small_model_dict, jax_side, monkeypatch):
    """The render of every frame (FK, skinning, face setup, z-buffer) in
    chunks of 3 frames, against the reference's skinned vertices through
    ``rasterize_zbuffer``, pixel for pixel."""
    monkeypatch.setattr(pipeline_common, "SKIN_BATCH", 3)
    rig = make_rig(small_model_dict, 7, seed=12)
    params = rig["gt"].copy()
    shape = rig["shape"]
    gray, covered = render_frames(rig["model"], params, shape, rig["r0"],
                                  rig["cam"], H_IMG, W_IMG)
    assert gray.shape == (7, H_IMG, W_IMG) and gray.dtype == torch.uint8
    assert covered.shape == (7, H_IMG, W_IMG) and covered.dtype == torch.bool
    jm, jcam, _ = jax_side
    _, jverts = j_frame_eval(jm, params, np.tile(shape, (7, 1)), rig["r0"],
                             rig["kp"], jcam)
    for k in range(7):
        g, c = rasterize_zbuffer(
            jnp.asarray(jverts[k]), jnp.asarray(np.asarray(jm.faces, np.int32)),
            *(float(v) for v in jcam), H_IMG, W_IMG,
            patch=pick_patch(jverts[k], jm.faces, *(float(v) for v in jcam)))
        np.testing.assert_array_equal(covered[k].numpy(), np.asarray(c))
        np.testing.assert_array_equal(gray[k].numpy(), np.asarray(g))
        assert int(c.sum()) > 100


def test_render_frames_writes_each_chunk_once(small_model_dict, monkeypatch):
    """``render_frames`` hands every chunk's frames of its result to
    ``rasterize_verts`` as ``out=``, so no chunk is rendered into a buffer
    of its own and copied: each call's ``out`` shares the result's memory,
    at the chunk's offset."""
    monkeypatch.setattr(pipeline_common, "SKIN_BATCH", 3)
    calls = []
    real = pipeline_common.rasterize_verts

    def spy(verts, *args, out=None, **kw):
        calls.append((int(verts.shape[0]), out))
        return real(verts, *args, out=out, **kw)
    monkeypatch.setattr(pipeline_common, "rasterize_verts", spy)
    rig = make_rig(small_model_dict, 7, seed=13)
    gray, covered = render_frames(rig["model"], rig["gt"].copy(), rig["shape"],
                                  rig["r0"], rig["cam"], H_IMG, W_IMG)
    assert [n for n, _ in calls] == [3, 3, 1]
    frame = H_IMG * W_IMG
    for k, (n, out) in enumerate(calls):
        assert out is not None and out[0].shape == (n, H_IMG, W_IMG)
        assert out[0].data_ptr() == gray.data_ptr() + 3 * k * frame
        assert out[1].data_ptr() == covered.data_ptr() + 3 * k * frame
    assert int(covered.flatten(1).sum(1).min()) > 100
