"""The port's twin of the repo root's ``__graft_entry__.py``: the production
window solve as one callable with example inputs, and a dry run of every
multi-device path.

    python -c "from smpltpu_torch import graft_entry as g; fn, a = g.entry(); fn(*a)"
    python -c "from smpltpu_torch import graft_entry as g; g.dryrun_multichip(4)"

``entry`` runs on the card unless given ``device="cpu"``;
``dryrun_multichip`` runs its ranks as threads over gloo on the CPU unless
given ``device="cuda"`` (NCCL, one rank a visible card).
"""

from __future__ import annotations

import numpy as np
import torch

N_WIN, WSIZE = 4, 6


def entry(device=None):
    """(fn, example_args): the production solver step, the stage-2 window
    fit (dogleg trust-region LM, fused cost, the analytic Jacobian, PCG
    through K1 on the card: ``linear="pcg_kernel"``), batched over 4
    windows of 6 frames, then the first fitted frame of each window
    decoded by ``params_to_pose`` and skinned through K2. fn(params0,
    shape0, kp, r0, valid) -> (params (4, 6, 76), cost (4,), shape (4,
    10), verts (4, 1024, 3)). Shapes and iteration counts are the
    reference's (6 LM trips, 16 CG steps); the program is that of the full
    workload."""
    from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
    from smpltpu_torch.energy import make_skeleton_spec
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.models import SMPLModel, make_synthetic_model
    from smpltpu_torch.ops.lbs import joint_affines, lbs, prepare_lbs_operands
    from smpltpu_torch.solve import MultiFrameConfig, build_multi_fitter
    from smpltpu_torch.utils import default_intrinsics
    from smpltpu_torch.utils.writeback import params_to_pose

    dev = torch.device("cuda" if device is None else device)
    f32 = torch.float32
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=1024),
                                device=dev, dtype=f32)
    r0c = torch.as_tensor(np.asarray(init_root_rotation(), np.float32),
                          device=dev)
    spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
    cam = default_intrinsics(480, 270, device=dev, dtype=f32)
    # the bench's stage-2 config at miniature iteration counts
    cfg = MultiFrameConfig(beta_pose=5.0, beta_shape=1e5, lambda_temporal=3.0,
                           max_iters=6, linear="pcg_kernel", cg_iters=16,
                           fused_cost=True)
    fit = build_multi_fitter(spec, cam, cfg, model.num_shapes, device=dev,
                             dtype=f32)
    ops = prepare_lbs_operands(model)

    def window_step(p0, w0, kpb, r0, valid):
        st = fit(p0, w0, kpb, r0, valid)
        # the first fitted frame of each window: the production decode
        # (root = rodrigues(aa) @ R0, every joint row) and skinning (K2)
        pose = params_to_pose(st.params[:, 0], r0c, model.num_joints)
        g_aff, _ = joint_affines(model, st.shape, pose.rotations,
                                 pose.root_pos)
        verts = lbs(st.shape.contiguous(), g_aff.contiguous(), ops)
        return st.params, st.cost, st.shape, verts.transpose(1, 2)

    rng = np.random.default_rng(0)
    kp = np.zeros((N_WIN, WSIZE, N_KP_SLOTS, 4), np.float32)
    kp[..., 0] = USE_SMPL
    kp[..., 1] = 135.0 + 40.0 * rng.normal(size=(N_WIN, WSIZE, N_KP_SLOTS))
    kp[..., 2] = 240.0 + 40.0 * rng.normal(size=(N_WIN, WSIZE, N_KP_SLOTS))
    kp[..., 3] = 1.0
    args = (init_frame_params(device=dev, dtype=f32).repeat(N_WIN, WSIZE, 1),
            torch.zeros((N_WIN, model.num_shapes), device=dev, dtype=f32),
            torch.as_tensor(kp, device=dev),
            r0c.repeat(N_WIN, WSIZE, 1, 1),
            torch.ones((N_WIN, WSIZE), device=dev, dtype=f32))
    return window_step, args


def dryrun_multichip(n_devices: int, device="cpu") -> dict:
    """Every multi-device path over a mesh of ``n_devices`` ranks (on
    CUDA one a visible card, at most), on tiny shapes, two frames a rank
    (four for one rank): the sharded LM (two trips), the one-step GN
    building block, window data parallelism with and without chunks, and
    frame data parallelism with and without chunks. Checks shapes and
    finiteness (raises RuntimeError), prints one line and returns rank
    0's numbers."""
    from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
    from smpltpu_torch.energy import make_skeleton_spec
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.models import SMPLModel, make_synthetic_model
    from smpltpu_torch.parallel import (
        build_sharded_gn_step,
        build_sharded_lm_fitter,
        mesh_size,
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

    n = mesh_size(n_devices, device)
    f32 = torch.float32
    f = 2 * max(n, 2)               # the windows take 3 of the frames
    rng = np.random.default_rng(0)
    kp = np.zeros((f, N_KP_SLOTS, 4), np.float32)
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = 32.0 + 5.0 * rng.normal(size=(f, N_KP_SLOTS, 2))
    kp[:, :, 3] = 1.0
    model_dict = make_synthetic_model(n_verts=64)
    cfg = MultiFrameConfig(beta_pose=2.0, beta_shape=5.0, lambda_temporal=1.0,
                           max_iters=1)

    def rank_main(mesh):
        dev = mesh.device
        model = SMPLModel.from_dict(model_dict, device=dev, dtype=f32)
        spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
        cam = default_intrinsics(64, 64, device=dev, dtype=f32)
        n_s = model.num_shapes
        params = init_frame_params(device=dev, dtype=f32).repeat(f, 1)
        r0 = torch.as_tensor(np.asarray(init_root_rotation(), np.float32),
                             device=dev).repeat(f, 1, 1)
        w = torch.zeros(n_s, device=dev, dtype=f32)
        kp_d = torch.as_tensor(kp, device=dev)

        def check(name, t, shape):
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"dryrun_multichip: {name} is "
                                   f"{tuple(t.shape)}, finite "
                                   f"{bool(torch.isfinite(t).all())}")

        res = build_sharded_lm_fitter(mesh, spec, cam, cfg._replace(max_iters=2),
                                      n_s, cg_iters=16)(params, w, kp_d, r0)
        check("the sharded LM's params", res.params, (f, 76))
        check("its shape", res.shape, (n_s,))
        gn = build_sharded_gn_step(mesh, spec, cam, cfg, n_s, cg_iters=16)(
            params, w, kp_d, r0)
        check("the GN step's params", gn.params, (f, 76))

        wsize, n_win = 3, n          # one window a rank
        fit2 = build_multi_fitter(spec, cam, cfg._replace(max_iters=2), n_s,
                                  device=dev, dtype=f32)
        bp = params[:1].repeat(n_win, wsize, 1)
        bk = kp_d[:wsize][None].repeat(n_win, 1, 1, 1)
        br = r0[:1].repeat(n_win, wsize, 1, 1)
        bv = torch.ones((n_win, wsize), device=dev, dtype=f32)
        bw = torch.zeros((n_win, n_s), device=dev, dtype=f32)
        st2 = sharded_window_fit(mesh, fit2, bp, bw, bk, br, bv)
        st2c = sharded_window_fit(mesh, fit2, bp, bw, bk, br, bv, chunk=1)
        for st in (st2, st2c):
            check("window DP's params", st.params, (n_win, wsize, 76))

        prob = make_single_frame_problem(model, init_root_rotation(), cam,
                                         beta_pose=2.0)
        fit3 = build_fitter(prob, max_iters=2, device=dev, dtype=f32)
        st3 = sharded_frame_fit(mesh, fit3, params, kp_d)
        st3c = sharded_frame_fit(mesh, fit3, params, kp_d, chunk=1)
        for st in (st3, st3c):
            check("frame DP's params", st.x, (f, 76))
        return {"lm_cost": float(res.cost), "cg_residual": float(gn.cg_residual),
                "window_dp_cost": float(st2.cost.sum()),
                "frame_dp_cost": float(st3.cost.sum()),
                "collectives": dict(mesh.calls)}

    out = run_ranks(n, rank_main, device)[0]
    print(f"dryrun_multichip OK: {n} ranks on {device}, {f} frames sharded, "
          f"lm cost {out['lm_cost']:.3e}, cg residual "
          f"{out['cg_residual']:.3e}, window-DP {n} windows cost "
          f"{out['window_dp_cost']:.3e}, frame-DP cost "
          f"{out['frame_dp_cost']:.3e}")
    return out
