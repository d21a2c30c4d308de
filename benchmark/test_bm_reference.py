"""The plain reference against the program at tiny sizes on the CPU, in
float64: the skeleton, the objectives, the render and the solvers agree.
(The benchmark's own runs never import the program into the reference;
these tests hold the two side by side.)"""

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark import reference as ref

port = pytest.importorskip("smpltpu_torch")
from smpltpu_torch.energy import make_skeleton_spec  # noqa: E402
from smpltpu_torch.energy.reproj import Camera, skeleton_joints_cam  # noqa: E402
from smpltpu_torch.models.smpl import SMPLModel  # noqa: E402
from smpltpu_torch.ops.lbs import joint_affines, lbs_torch, prepare_lbs_operands  # noqa: E402
from smpltpu_torch.render.zbuffer import face_setup, rasterize_torch  # noqa: E402
from smpltpu_torch.solve import MultiFrameConfig, OnlineConfig, build_multi_fitter  # noqa: E402
from smpltpu_torch.solve.online import build_online_step  # noqa: E402
from smpltpu_torch.utils.writeback import params_to_pose  # noqa: E402

F64 = torch.float64
W, H = 72, 128


@pytest.fixture(scope="module")
def world():
    model = gen.make_model("cpu", 4242, n_verts=300, n_faces=596)
    m = SMPLModel(*(model[k].double() for k in ("v_template", "shapedirs", "J_regressor",
                                                "weights", "joint_shape_reg", "posedirs")),
                  model["faces"].numpy(), model["parents"].numpy())
    cam_r = ref.camera(W, H)
    cam_p = Camera(*(torch.tensor(v, dtype=F64) for v in cam_r))
    spec = make_skeleton_spec(m, ref.R0, with_shape=True)
    gt = gen.motion("cpu", 77, 40).double()
    kp = gen.keypoints(model, cam_r, gt.float(), 78).double()
    return {"model": model, "m": m, "cam_r": cam_r, "cam_p": cam_p, "spec": spec,
            "body": ref.make_body(model, ref.F64), "gt": gt, "kp": kp,
            "r0": torch.as_tensor(ref.R0, dtype=F64)}


def test_skeleton(world):
    shape = torch.linspace(-0.5, 0.5, 10, dtype=F64)
    got = ref.skeleton_joints(world["body"], world["gt"], shape, world["r0"])
    want = skeleton_joints_cam(world["gt"], shape, world["spec"])
    assert torch.allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_multi_cost(world, fused):
    kp = world["kp"][None, :20]
    x = world["gt"][None, :20] + 0.01
    shape = torch.full((1, 10), 0.1, dtype=F64)
    valid = torch.ones((1, 20), dtype=F64)
    valid[0, -3:] = 0.0
    kp = kp * torch.cat([torch.ones(17), torch.ones(17)]).new_ones(1)
    kp[0, -3:, :, 3] = 0.0
    r0 = world["r0"].expand(1, 20, 3, 3)
    cfg = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
                           max_iters=0, linear="pcg", fused_cost=fused)
    fit = build_multi_fitter(world["spec"], world["cam_p"], cfg, 10, device="cpu", dtype=F64)
    want = fit(x, shape, kp, r0, valid).cost
    got = ref.multi_cost(world["body"], world["cam_r"], ref.MultiCfg(5.0, 25.0, 3.0),
                         x, shape, kp, r0, valid)
    assert torch.allclose(got, want, rtol=1e-12)


def test_multi_solver_agrees(world):
    """Five dogleg trips with 20 CG steps from the blind start: the
    reference's solver and the program's fitter part by rounding only."""
    n = 30
    kp, r0 = world["kp"][None, :n], world["r0"].expand(1, n, 3, 3)
    x0 = ref.init_params(n, "cpu", F64)[None]
    s0 = torch.zeros((1, 10), dtype=F64)
    ok = torch.ones((1, n), dtype=F64)
    cfg = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
                           max_iters=5, linear="pcg", cg_iters=20, fused_cost=True)
    fit = build_multi_fitter(world["spec"], world["cam_p"], cfg, 10, device="cpu", dtype=F64)
    want = fit(x0, s0, kp, r0, ok)
    got = ref.multi_lm(world["body"], world["cam_r"], ref.MultiCfg(5.0, 25.0, 3.0),
                       x0, s0, kp, r0, ok, 5, 20)
    assert torch.allclose(got.params, want.params, atol=1e-7)
    assert torch.allclose(got.cost, want.cost, rtol=1e-9)
    assert int(got.iters[0]) == int(want.iters_run[0])


def test_newton_gap_at_a_converged_fit(world):
    n = 20
    kp, r0 = world["kp"][None, :n], world["r0"].expand(1, n, 3, 3)
    x0 = ref.init_params(n, "cpu", F64)[None]
    s0 = torch.zeros((1, 10), dtype=F64)
    ok = torch.ones((1, n), dtype=F64)
    cfg = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
                           max_iters=100, linear="tridiag")
    st = build_multi_fitter(world["spec"], world["cam_p"], cfg, 10, device="cpu",
                            dtype=F64)(x0, s0, kp, r0, ok)
    c = ref.MultiCfg(5.0, 25.0, 3.0)
    done = ref.multi_newton_gap(world["body"], world["cam_r"], c, st.params, st.shape, kp, r0, ok)
    start = ref.multi_newton_gap(world["body"], world["cam_r"], c, x0, s0, kp, r0, ok)
    # the fit stops once an accepted step removes <= 1e-6 of the cost
    assert float(done) < 1e-4 < 1e-1 < float(start)


@pytest.mark.parametrize("n_frames", [60, 1000])
def test_window_starts_agree(n_frames):
    """The judge's window starts from a video's anchors, against the fused
    run's interpolation and window gather, frames past the end included."""
    from benchmark import judge
    from smpltpu_torch.solve.two_stage import interp_tables, interpolate_anchors
    cfg = {"fit": {"anchor_every": 10, "window": 20, "overlap": 5}}
    lay = judge.Layout.of(cfg, n_frames)
    g = torch.Generator().manual_seed(n_frames)
    anchors = torch.randn((len(lay.anchor_idx), ref.P_DIM), generator=g, dtype=F64)
    x_init = ref.init_params(1, "cpu", F64)[0]
    got = judge.interp_starts(lay, anchors, x_init)
    seg, hi, t = interp_tables(lay.anchor_idx, n_frames)
    poses = interpolate_anchors(anchors, torch.as_tensor(seg), torch.as_tensor(hi),
                                torch.as_tensor(t)[:, None])
    f = lay.starts[:, None] + np.arange(lay.wsize)[None]
    want = torch.where(torch.as_tensor(f < n_frames)[..., None],
                       poses[torch.as_tensor(np.minimum(f, n_frames - 1))], x_init)
    assert got.shape == (len(lay.starts), lay.wsize, ref.P_DIM)
    assert torch.allclose(got, want, atol=1e-14)


def test_online_solver_agrees(world):
    on = OnlineConfig(beta_pose=5.0, lambda_temporal=3.0, max_iters=20)
    step = build_online_step(world["spec"], world["cam_p"], on, 24, device="cpu", dtype=F64)
    prev = world["gt"][10:14] + 0.02
    kp = world["kp"][11:15]
    shape = torch.zeros(10, dtype=F64)
    has = torch.ones(4, dtype=F64)
    want = step(prev, shape, kp, prev, has)
    c = ref.OnlineCfg(5.0, 3.0)
    got = ref.online_lm(world["body"], world["cam_r"], c, prev, shape, kp, prev, has,
                        world["r0"], 20)
    # the reference's Levenberg-Marquardt and the program's exact trust
    # region stop on the same 1e-6 relative decrease; where both stopped
    # before the cap they meet at one stationary point
    both = (got.iters < 20) & (want.iters_run < 20)
    assert int(both.sum()) >= 2
    assert torch.allclose(got.params[both], want.x[both], atol=1e-4)
    cost = ref.online_cost(world["body"], world["cam_r"], c, want.x, shape, kp, prev, has,
                           world["r0"])
    assert torch.allclose(cost, want.cost, rtol=1e-12)
    gap = ref.online_newton_gap(world["body"], world["cam_r"], c, want.x, shape, kp, prev,
                                has, world["r0"])
    assert float(gap[want.iters_run < 20].max()) < 1e-4


def test_render(world):
    """The reference's skinning against FK + LBS of the render, and its
    z-buffer pixel for pixel against the program's plain K3 on the same
    vertices."""
    m = world["m"]
    x = world["gt"][:3]
    shape = torch.linspace(-0.3, 0.3, 10, dtype=F64)
    pose = params_to_pose(x, world["r0"].expand(3, 3, 3), 24)
    g, _ = joint_affines(m, shape.expand(3, 10), pose.rotations, pose.root_pos)
    want = lbs_torch(shape.expand(3, 10), g, prepare_lbs_operands(m)).transpose(1, 2)
    got = ref.smpl_vertices(world["body"], x, shape, world["r0"])
    assert torch.allclose(got, want, atol=1e-12)
    gray, cov = ref.rasterize(want, world["body"].faces, world["cam_r"], H, W)
    g2, c2 = rasterize_torch(face_setup(want, m.faces, *world["cam_r"]), H, W)
    assert torch.equal(gray, g2) and torch.equal(cov, c2) and int(cov.sum()) > 100
    assert ref.box_pixels(want, world["body"].faces, world["cam_r"], H, W) > 0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0000001, 0.0, 1e-30])
    r = ref.tf32_round(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10 and r[4] == 0.0
    assert float(torch.max(torch.abs(r - x) / torch.clamp(x.abs(), min=1e-38))) <= 2 ** -11
    bits = (r.view(torch.int32) & 0x1FFF)
    assert torch.all(bits == 0)
    assert np.isfinite(r.numpy()).all()
