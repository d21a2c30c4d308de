"""SMPL-X on the port's video path, on the CPU, held to the plain SMPL-X of
``tests/plain_smplx.py`` (float64, TF32 off) on seeded random weights at a
small size: the full 55-joint tree, 400 vertices, 10 + 10 shape and
expression directions, 12 PCA components a hand.

Tolerances and why:

* joints and vertices (FK and K2's plain version) 1e-12 m: the same
  products in another order (the port regresses the rest joints through
  ``joint_shape_reg`` and blends the transforms before applying them);
* residuals 1e-10 px relative, the analytic Jacobian (the hand
  coefficients' columns by the chain rule) against ``torch.func.jacfwd``
  of the plain residual 1e-10 relative to its largest entry: float64
  rounding along a 10-level chain, read 1e-15 to 1e-13;
* a fit's reported cost against the plain cost at its returned params
  1e-10 relative: the port's cost is read off the corrected residuals of
  the same linearization;
* K1's plain version at P = 94 against a dense solve of the same
  arrowhead system 1e-8 relative, after enough CG steps to converge;
* SMPL's path: bit for bit against ``tests/data/smpl_pin.npz``, recorded
  before the whole-body layout (``python -m tests.smpl_pin --record``).
"""

import json
import os

import numpy as np
import pytest
import torch

from smpltpu_torch.constants import SMPL_PARENTS, init_root_rotation
from smpltpu_torch.energy import make_skeleton_spec
from smpltpu_torch.energy.jacobian import keypoint_residuals_and_jacobian
from smpltpu_torch.energy.reproj import Camera, keypoint_residuals
from smpltpu_torch.io import load_keypoint_dir, load_smpl_npz, save_smpl_npz
from smpltpu_torch.models.registry import resolve_model
from smpltpu_torch.models.smpl import SMPLModel, UnsupportedModelError, tree_levels
from smpltpu_torch.models.smplx import (
    MP_HAND_MAP,
    SMPLX_PARENTS,
    USE_SMPLX,
    make_synthetic_smplx,
)
from smpltpu_torch.ops.cg import arrow_matvec, arrow_pcg_torch
from smpltpu_torch.ops.lbs import joint_affines, lbs_torch, prepare_lbs_operands
from smpltpu_torch.solve import MultiFrameConfig, build_fused_two_stage
from smpltpu_torch.solve.two_stage import interp_tables
from smpltpu_torch.utils.image import imwrite
from smpltpu_torch.utils.writeback import params_to_pose
from tests import plain_smplx as P
from tests import smpl_pin

F64 = torch.float64
CAM = (500.0, 510.0, 160.0, 120.0)
R0 = torch.as_tensor(init_root_rotation())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch calls under the suite's parallel workers: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smplx():
    d = make_synthetic_smplx(n_verts=400, n_faces=796, seed=3)
    return d, SMPLModel.from_dict(d, device="cpu", dtype=F64), P.make(d)


def _cam(dtype=F64):
    return Camera(*(torch.tensor(v, dtype=dtype) for v in CAM))


def _frames(pm, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = P.init_params(pm, n)
    x[:, 0] = 1.1
    x[:, 1:4] = 0.3 * torch.randn((n, 3), generator=g, dtype=F64)
    x[:, 7:] = 0.4 * torch.randn((n, x.shape[1] - 7), generator=g, dtype=F64)
    return x, 0.5 * torch.randn((n, 10), generator=g, dtype=F64)


def _video_kp(pm, n, seed, noise=1.0):
    """(n, 47, 4) keypoints of a smooth motion with moving hands, projected
    by the plain skeleton at the zero shape, plus ``noise`` px."""
    g = torch.Generator().manual_seed(seed)
    f = torch.arange(n, dtype=F64)[:, None]
    x = P.init_params(pm, n)
    x[:, 1:4] = torch.tensor([0.05, 0.1, 0.0], dtype=F64)
    x[:, 4:7] = torch.tensor([0.0, -0.1, 3.2], dtype=F64)
    x[:, 7:] = (0.2 * torch.randn((1, x.shape[1] - 7), generator=g, dtype=F64)
                * torch.cos(0.15 * f + torch.rand((1, x.shape[1] - 7), generator=g,
                                                 dtype=F64) * 6.0))
    uv = P.project(P.skeleton_joints(pm, x, torch.zeros(10, dtype=F64),
                                     R0.expand(n, 3, 3)), CAM)
    kp = torch.zeros((n, len(USE_SMPLX), 4), dtype=F64)
    kp[..., 0] = torch.as_tensor(USE_SMPLX, dtype=F64)
    kp[..., 1:3] = uv[:, USE_SMPLX] + noise * torch.randn(
        (n, len(USE_SMPLX), 2), generator=g, dtype=F64)
    kp[..., 3] = 1.0
    return kp


def test_synthetic_smplx_has_the_published_sizes_and_tree():
    d = resolve_model("synthetic_smplx")
    assert d["v_template"].shape == (10475, 3) and d["faces"].shape == (20908, 3)
    assert d["shapedirs"].shape == (10475, 3, 20) and d["num_betas"] == 10
    assert d["posedirs"].shape == (10475, 3, 486)
    assert d["J_regressor"].shape == (55, 10475) and d["weights"].shape == (10475, 55)
    assert d["hand_components"].shape == (2, 45, 45) and d["hand_mean"].shape == (2, 45)
    np.testing.assert_array_equal(d["parents"], P.PARENTS)
    np.testing.assert_array_equal(SMPLX_PARENTS[:22], SMPL_PARENTS[:22])
    assert len(tree_levels(SMPLX_PARENTS)) == 10 and len(tree_levels(SMPL_PARENTS)) == 8
    # each hand's basis: orthogonal rows, standard deviations decreasing
    for h in range(2):
        c = d["hand_components"][h]
        gram = c @ c.T
        np.testing.assert_allclose(gram, np.diag(np.diag(gram)), atol=1e-12)
        assert np.all(np.diff(np.diag(gram)) < 0)


@pytest.mark.parametrize("n_cols", [20, 400])
def test_npz_loader_reads_smplx_key_names(tmp_path, smplx, n_cols):
    """A file written under SMPL-X's own keys (hands_componentsl/r,
    hands_meanl/r, a 55-joint kintree, shapedirs with the expression
    directions after the shape ones: at 10 in a 20-column file, at 300 in
    a 400-column one) loads into the port's dict."""
    d = smplx[0]
    rng = np.random.default_rng(0)
    sd = rng.normal(size=(400, 3, n_cols))
    expr0 = 10 if n_cols == 20 else 300
    sd[..., :10] = d["shapedirs"][..., :10]
    sd[..., expr0:expr0 + 10] = d["shapedirs"][..., 10:]
    kintree = np.stack([np.where(d["parents"] < 0, 4294967295, d["parents"]),
                        np.arange(55)])
    path = tmp_path / "SMPLX_TEST.npz"
    np.savez(path, v_template=d["v_template"], shapedirs=sd, f=d["faces"],
             J_regressor=d["J_regressor"], weights=d["weights"], kintree_table=kintree,
             posedirs=d["posedirs"], hands_componentsl=d["hand_components"][0],
             hands_componentsr=d["hand_components"][1], hands_meanl=d["hand_mean"][0],
             hands_meanr=d["hand_mean"][1])
    got = load_smpl_npz(str(path))
    for k in ("v_template", "shapedirs", "J_regressor", "weights", "faces", "parents",
              "joint_shape_reg", "hand_components", "hand_mean", "posedirs"):
        np.testing.assert_allclose(got[k], d[k], rtol=0, atol=1e-15, err_msg=k)
    assert got["num_betas"] == 10
    # the port's own writer round-trips it, under the same key names
    save_smpl_npz(str(tmp_path / "again.npz"), got)
    assert "hands_componentsl" in np.load(tmp_path / "again.npz").files
    back = load_smpl_npz(str(tmp_path / "again.npz"))
    for k in got:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(got[k]))


def test_fk_and_skinning_match_the_plain_forward(smplx):
    """The render's FK (``params_to_pose`` + ``joint_affines``) and K2's
    plain version with the 20-column basis (expression at zero) against
    the plain forward pass."""
    _, m, pm = smplx
    x, betas = _frames(pm, 5, 1)
    r0 = R0.expand(5, 3, 3)
    pose = params_to_pose(x, r0, 55, m.hand_pca())
    shp = m.skin_shape(betas)
    g_aff, joints = joint_affines(m, shp, pose.rotations, pose.root_pos)
    verts = lbs_torch(shp, g_aff, prepare_lbs_operands(m)).transpose(1, 2)
    want_j, want_v = P.forward(pm, x, betas, r0)
    np.testing.assert_allclose(joints, want_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(verts, want_v, rtol=0, atol=1e-12)


def test_residuals_and_jacobian_match_the_plain_residual(smplx):
    """94 residual rows of 47 slots (some masked) and the 94 x 94 analytic
    Jacobian, the hand coefficients' columns included, against jacfwd of
    the plain residual; the shape columns too."""
    _, m, pm = smplx
    spec = make_skeleton_spec(m, init_root_rotation(), with_shape=True)
    n = 4
    x, betas = _frames(pm, n, 2)
    g = torch.Generator().manual_seed(4)
    kp = torch.zeros((n, 47, 4), dtype=F64)
    kp[..., 0] = torch.as_tensor(USE_SMPLX, dtype=F64)
    kp[..., 1:3] = 120.0 + 40.0 * torch.randn((n, 47, 2), generator=g, dtype=F64)
    kp[..., 3] = (torch.rand((n, 47), generator=g) > 0.2).to(F64)
    r0 = R0.expand(n, 3, 3)
    cam = _cam()

    def plain(xx, bb):
        return P.kp_residuals(pm, CAM, xx, bb, kp, r0).flatten(-2)
    want = plain(x, betas)
    np.testing.assert_allclose(keypoint_residuals(x, betas, kp, cam, spec, r0), want,
                               rtol=1e-10, atol=1e-10)
    res, jp, jw = keypoint_residuals_and_jacobian(x, betas, kp, cam, spec, r0)
    assert jp.shape == (n, 94, 94) and jw.shape == (n, 94, 10)
    jx, jb = torch.func.jacfwd(plain, argnums=(0, 1))(x, betas)
    idx = torch.arange(n)
    jx, jb = jx[idx, :, idx], jb[idx, :, idx]
    np.testing.assert_allclose(res, want, rtol=1e-10, atol=1e-10)
    assert float((jp - jx).abs().max() / jx.abs().max()) < 1e-10
    assert float((jw - jb).abs().max() / jb.abs().max()) < 1e-10
    assert float(jx[..., 70:].abs().max()) > 1.0       # the hands' columns bite


def test_k2_plain_version_at_55_joints_and_20_directions(smplx):
    """``lbs_torch`` at (nJ 55, nS 20), expression coefficients non-zero,
    against the per-vertex formula out[v] = sum_j W[v,j] G_j [v_sh; 1]."""
    _, m, _ = smplx
    g = torch.Generator().manual_seed(5)
    shapes = torch.randn((3, 20), generator=g, dtype=F64)
    aff = torch.randn((3, 55, 3, 4), generator=g, dtype=F64)
    got = lbs_torch(shapes, aff, prepare_lbs_operands(m))
    v_sh = m.v_template + torch.einsum("vxs,bs->bvx", m.shapedirs, shapes)
    homo = torch.cat([v_sh, torch.ones_like(v_sh[..., :1])], -1)
    want = torch.einsum("vj,bjck,bvk->bcv", m.weights, aff, homo)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_k1_plain_version_at_p94_solves_the_arrowhead_system():
    """``arrow_pcg_torch`` at P = 94, nS = 10 (two windows of 5 frames,
    an SPD arrowhead system), 400 CG steps, against a dense solve."""
    g = torch.Generator().manual_seed(6)
    w_n, f_n, p, n_s = 2, 5, 94, 10
    a = torch.randn((w_n, f_n, p, p), generator=g, dtype=F64)
    d = a @ a.transpose(-1, -2) / p + 4.0 * torch.eye(p, dtype=F64)
    off = -0.5 * torch.rand((w_n, f_n - 1), generator=g, dtype=F64)
    tm = torch.ones(p, dtype=F64)
    tm[0] = 0.0
    b = 0.1 * torch.randn((w_n, f_n, p, n_s), generator=g, dtype=F64)
    c = 10.0 * torch.eye(n_s, dtype=F64).expand(w_n, n_s, n_s).clone()
    g_p = torch.randn((w_n, f_n, p), generator=g, dtype=F64)
    g_w = torch.randn((w_n, n_s), generator=g, dtype=F64)
    dp, dw = arrow_pcg_torch(d, off, tm, b, c, g_p, g_w, iters=400)
    n = f_n * p
    for w in range(w_n):
        dense = torch.zeros((n + n_s, n + n_s), dtype=F64)
        for f in range(f_n):
            dense[f * p:(f + 1) * p, f * p:(f + 1) * p] = d[w, f]
            dense[f * p:(f + 1) * p, n:] = b[w, f]
            dense[n:, f * p:(f + 1) * p] = b[w, f].T
            if f + 1 < f_n:
                e = torch.diag(off[w, f] * tm)
                dense[f * p:(f + 1) * p, (f + 1) * p:(f + 2) * p] = e
                dense[(f + 1) * p:(f + 2) * p, f * p:(f + 1) * p] = e
        dense[n:, n:] = c[w]
        want = torch.linalg.solve(dense, -torch.cat([g_p[w].reshape(-1), g_w[w]]))
        got = torch.cat([dp[w].reshape(-1), dw[w]])
        assert float((got - want).abs().max() / want.abs().max()) < 1e-8
    # the plain matvec is the dense matrix's
    v_p = torch.randn((1, f_n, p), generator=g, dtype=F64)
    v_w = torch.randn((1, n_s), generator=g, dtype=F64)
    u, u_w = arrow_matvec(d[-1:], off[-1:], tm, b[-1:], c[-1:], v_p, v_w)
    np.testing.assert_allclose(torch.cat([u.reshape(-1), u_w.reshape(-1)]),
                               dense @ torch.cat([v_p.reshape(-1), v_w.reshape(-1)]),
                               rtol=0, atol=1e-12)


def _fit_case(m, pm, n=60, dtype=F64):
    """The fused two-stage fit of a 60-frame video (anchors every 10
    frames, 20-frame windows overlapping by 5) on the plain PCG."""
    spec = make_skeleton_spec(m, init_root_rotation(), with_shape=True)
    kp = _video_kp(pm, n, 7).to(dtype)
    anchors, starts, wsize = list(range(0, n, 10)), list(range(0, n, 15)), 20
    cfg1 = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
                            max_iters=25, linear="pcg", cg_iters=64, fused_cost=True)
    cfg2 = cfg1._replace(beta_shape=1e5, max_iters=15)
    run = build_fused_two_stage(spec, _cam(dtype), cfg1, cfg2, 10, anchors, starts,
                                wsize, n, device="cpu", dtype=dtype)
    f = np.asarray(starts)[:, None] + np.arange(wsize)
    valid = torch.as_tensor(f < n, dtype=dtype)
    kpw = kp[torch.as_tensor(np.minimum(f, n - 1))] * valid[..., None, None]
    kpw[..., 0] = kp[0, :, 0]
    p0 = P.init_params(pm, len(anchors)).to(dtype)
    r0 = R0.to(dtype)
    st1, st2 = run(p0, torch.zeros(10, dtype=dtype), kp[anchors],
                   r0.expand(len(anchors), 3, 3), kpw,
                   r0.expand(len(starts), wsize, 3, 3), valid)
    return dict(kp=kp, anchors=anchors, starts=starts, wsize=wsize, kpw=kpw,
                valid=valid, st1=st1, st2=st2, cfg1=cfg1, cfg2=cfg2)


def test_fused_two_stage_fit_against_the_plain_cost(smplx):
    """Each problem's reported cost against the plain cost at its returned
    params (1e-10 relative), and no window ends costlier than its start:
    stage 1's anchors interpolated (hand coefficients linearly, as every
    dim)."""
    _, m, pm = smplx
    c = _fit_case(m, pm)
    st1, st2, cfg1, cfg2 = c["st1"], c["st2"], c["cfg1"], c["cfg2"]
    n_a = len(c["anchors"])
    ones = torch.ones((1, n_a), dtype=F64)
    r0a = R0.expand(1, n_a, 3, 3)
    e1 = P.multi_cost(pm, CAM, 5.0, 25.0, 3.0, st1.params[None], st1.shape[None],
                      c["kp"][c["anchors"]][None], r0a, ones)
    e1_0 = P.multi_cost(pm, CAM, 5.0, 25.0, 3.0, P.init_params(pm, n_a)[None],
                        torch.zeros((1, 10), dtype=F64), c["kp"][c["anchors"]][None],
                        r0a, ones)
    assert abs(float(st1.cost) - float(e1[0])) <= 1e-10 * float(e1[0])
    assert float(e1[0]) < float(e1_0[0])
    w_n = len(c["starts"])
    r0w = R0.expand(w_n, c["wsize"], 3, 3)
    e2 = P.multi_cost(pm, CAM, 5.0, 1e5, 3.0, st2.params, st2.shape, c["kpw"], r0w,
                      c["valid"])
    np.testing.assert_allclose(st2.cost, e2, rtol=1e-10, atol=0)
    seg, hi, t = interp_tables(c["anchors"], 60)
    t = torch.as_tensor(t)[:, None]
    poses = (1.0 - t) * st1.params[seg] + t * st1.params[hi]
    f = np.asarray(c["starts"])[:, None] + np.arange(c["wsize"])
    p0w = torch.where(torch.as_tensor(f < 60)[..., None],
                      poses[torch.as_tensor(np.minimum(f, 59))], P.init_params(pm, 1))
    e0 = P.multi_cost(pm, CAM, 5.0, 1e5, 3.0, p0w, st2.shape, c["kpw"], r0w, c["valid"])
    assert bool(torch.all(e2 <= e0)) and bool(torch.all(st2.iters_run > 0))
    # the fit explains the keypoints: the mean residual is near the noise
    res = P.kp_residuals(pm, CAM, st2.params, st2.shape[:, None], c["kpw"], r0w)
    assert float(res.norm(dim=-1).sum() / c["kpw"][..., 3].sum()) < 3.0


def _write_holistic(root, kp, width, height, drop_hands=()):
    """Frame files of MediaPipe Holistic objects whose body and hand
    landmarks put the 47 slots at kp (n, 47, 4)'s pixels, but for the two
    pelvis slots, which the loader takes as the hips' midpoint."""
    from smpltpu_torch.constants import MP_MAP
    kdir, idir = root / "kps", root / "imgs"
    kdir.mkdir()
    idir.mkdir()
    n = kp.shape[0]
    for i in range(n):
        pose = [{"x": 0.0, "y": 0.0, "visibility": 0.0} for _ in range(33)]
        for s in range(15):
            jid = int(USE_SMPLX[s])
            pose[int(MP_MAP[jid])] = {"x": float(kp[i, s, 1]) / width,
                                      "y": float(kp[i, s, 2]) / height,
                                      "visibility": 0.99}
        frame = {"pose": pose}
        for h, key in enumerate(("left_hand", "right_hand")):
            hand = [{"x": 0.0, "y": 0.0} for _ in range(21)]
            for k, lm in enumerate(MP_HAND_MAP.tolist()):
                s = 17 + 15 * h + k
                hand[lm] = {"x": float(kp[i, s, 1]) / width,
                            "y": float(kp[i, s, 2]) / height}
            frame[key] = [] if (i, key) in drop_hands else hand
        (kdir / f"frame_{i:04d}.json").write_text(json.dumps(frame))
        imwrite(str(idir / f"frame_{i:04d}.png"),
                np.full((height, width, 3), 40, np.uint8))
    return kdir, idir


def test_holistic_keypoint_files_load_into_47_slots(tmp_path, smplx):
    """Holistic objects load into the 47-slot array (an empty hand list
    leaves its slots invisible); a 33-landmark list file gives its body
    slots and invisible hands, as the SMPL loader reads it; the native
    parser refuses the whole-body layout by name."""
    from smpltpu_torch.io.keypoints import keypoints_to_dense, load_mp_json
    _, _, pm = smplx
    kp = _video_kp(pm, 3, 9, noise=0.0).numpy()
    kdir, _ = _write_holistic(tmp_path, kp, 320, 240, drop_hands={(1, "right_hand")})
    got, paths = load_keypoint_dir(str(kdir), 320, 240, layout="smplx")
    assert got.shape == (3, 47, 4) and len(paths) == 3
    np.testing.assert_array_equal(got[..., 0], np.broadcast_to(USE_SMPLX, (3, 47)))
    want_vis = np.ones((3, 47))
    want_vis[1, 32:] = 0.0
    np.testing.assert_array_equal(got[..., 3], want_vis)
    want = kp.copy()
    want[:, 15:17, 1:3] = 0.5 * (kp[:, 0:1, 1:3] + kp[:, 1:2, 1:3])
    ok = want_vis > 0
    np.testing.assert_allclose(got[..., 1:3][ok], want[..., 1:3][ok], rtol=0, atol=1e-9)
    # the list format
    lst = tmp_path / "list"
    lst.mkdir()
    body = json.loads((kdir / "frame_0000.json").read_text())["pose"]
    (lst / "a.json").write_text(json.dumps(body))
    got_l, _ = load_keypoint_dir(str(lst), 320, 240, layout="smplx")
    np.testing.assert_array_equal(got_l[0, :17], keypoints_to_dense(
        load_mp_json(str(lst / "a.json"), 320, 240)))
    assert not got_l[0, 17:, 3].any()
    smpl_l, _ = load_keypoint_dir(str(lst), 320, 240, backend="python")
    np.testing.assert_array_equal(smpl_l[0], got_l[0, :17])
    with pytest.raises(ValueError, match="native"):
        load_keypoint_dir(str(kdir), 320, 240, backend="native", layout="smplx")


def test_multi_cli_fits_and_renders_smplx(tmp_path, smplx):
    """``python -m smpltpu_torch.pipeline.multi synthetic_smplx:400 ...``
    on the CPU, the benchmark's route (fused stages, batched windows,
    anchors interpolated, the render through K3's plain version): every
    frame logged and drawn, params (F, 94)."""
    from smpltpu_torch.pipeline import multi
    d = resolve_model("synthetic_smplx:400")
    pm = P.make(d)
    kp = _video_kp(pm, 12, 11, noise=0.5).numpy()
    kdir, idir = _write_holistic(tmp_path, kp, 320, 240)
    out = tmp_path / "out"
    argv = ["synthetic_smplx:400", str(kdir), str(idir), str(out), "6", "6", "4",
            "8", "3", "--s2-iters", "4", "--batched-windows", "--init-from-anchors",
            "--fused-stages", "--jax-render", "--linear", "pcg"]
    assert multi.main(argv, device="cpu") == 0
    params = np.load(out / "params_multi.npz")["params"]
    assert params.shape == (12, 94) and np.isfinite(params).all()
    rows = [r.split(",") for r in open(out / "log.csv").read().splitlines()[1:]]
    windows = rows[3:]                     # after the 3 anchors' rows
    assert {int(r[0]) for r in windows} == set(range(12))
    assert np.mean([float(r[1]) for r in windows]) < 3.0
    assert len(list(out.glob("frame_*_multi.png"))) == 12


def test_smpl_path_is_bitwise_unchanged():
    """SMPL's fit (both stages, f64 and f32), Jacobian, FK and skinning
    on the synthetic model, bit for bit as recorded."""
    want = np.load(smpl_pin.PIN)
    got = smpl_pin.compute()
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cli", ["single", "stream", "multi_data_init"])
def test_smpl_only_clis_refuse_smplx_by_name(tmp_path, smplx, capsys, cli):
    import importlib
    _, _, pm = smplx
    kdir, idir = _write_holistic(tmp_path, _video_kp(pm, 2, 1).numpy(), 320, 240)
    argv = ["synthetic_smplx:400", str(kdir), str(idir), str(tmp_path / "o")]
    if cli == "multi_data_init":
        cli, argv = "multi", argv + ["--data-init"]
    mod = importlib.import_module(f"smpltpu_torch.pipeline.{cli}")
    assert mod.main(argv, device="cpu") == 1
    assert "UnsupportedModelError" in capsys.readouterr().err


def test_online_fit_and_sharded_solvers_refuse_smplx(smplx):
    from smpltpu_torch.parallel import build_sharded_lm_fitter
    from smpltpu_torch.solve.online import OnlineConfig, OnlineGraph, build_online_step
    _, m, _ = smplx
    spec = make_skeleton_spec(m, init_root_rotation(), with_shape=True)
    with pytest.raises(UnsupportedModelError, match="online"):
        OnlineGraph(spec, _cam(), OnlineConfig(), 55, device="cpu", dtype=F64)
    with pytest.raises(UnsupportedModelError, match="online"):
        build_online_step(spec, _cam(), OnlineConfig(), 55, device="cpu", dtype=F64)
    cfg = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
                           max_iters=2)
    with pytest.raises(UnsupportedModelError, match="sharded"):
        build_sharded_lm_fitter(None, spec, _cam(), cfg, 10, dtype=F64)


def test_fit_video_refuses_smplx(smplx):
    from smpltpu_torch.pipeline import fit_video
    d = smplx[0]
    with pytest.raises(UnsupportedModelError, match="fit_video"):
        fit_video(d, np.zeros((2, 47, 4)), 320, 240, mode="multi", device="cpu")
