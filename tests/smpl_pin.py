"""A pin of SMPL's video path, bit for bit: a fused two-stage fit of the
synthetic SMPL model (300 vertices) on a 45-frame video in float64 and in
float32 on the plain PCG, the analytic keypoint Jacobian, and the render's
FK and skinning (K2's plain version), on one CPU thread.

    python -m tests.smpl_pin --record

writes ``tests/data/smpl_pin.npz``; ``tests/test_torch_smplx.py`` holds
the port to it with ``np.testing.assert_array_equal``. It uses only the
port's SMPL interfaces, so a tree from before the whole-body layout
records the same file.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

PIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "smpl_pin.npz")
N_FRAMES = 45


def _video(spec, cam, dtype):
    """Keypoints (F, 17, 4) of a smooth seeded motion, 1 px noise."""
    from smpltpu_torch.constants import USE_SMPL
    from smpltpu_torch.energy.reproj import project, skeleton_joints_cam

    g = torch.Generator().manual_seed(5)
    base = 0.2 * torch.randn((23, 3), generator=g, dtype=torch.float64)
    f = torch.arange(N_FRAMES, dtype=torch.float64)[:, None, None]
    gt = torch.zeros((N_FRAMES, 76), dtype=torch.float64)
    gt[:, 0] = 1.0
    gt[:, 1:4] = torch.tensor([0.1, 0.05, 0.0], dtype=torch.float64)
    gt[:, 4:7] = torch.tensor([0.1, -0.1, 3.2], dtype=torch.float64)
    gt[:, 7:] = (base * torch.cos(0.1 * f)).reshape(N_FRAMES, 69)
    uv = project(skeleton_joints_cam(gt.to(dtype), torch.zeros(10, dtype=dtype),
                                     spec), cam)
    kp = torch.zeros((N_FRAMES, 17, 4), dtype=dtype)
    kp[..., 0] = torch.as_tensor(USE_SMPL, dtype=dtype)
    kp[..., 1:3] = uv[:, USE_SMPL] + torch.randn((N_FRAMES, 17, 2), generator=g,
                                                  dtype=torch.float64).to(dtype)
    kp[..., 3] = 1.0
    return kp


def compute() -> dict:
    """The pinned arrays, computed by the tree on the path."""
    from smpltpu_torch.constants import init_root_rotation
    from smpltpu_torch.energy import make_skeleton_spec
    from smpltpu_torch.energy.jacobian import keypoint_residuals_and_jacobian
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.models.smpl import SMPLModel
    from smpltpu_torch.models.synthetic import make_synthetic_model
    from smpltpu_torch.ops.lbs import joint_affines, lbs_torch, prepare_lbs_operands
    from smpltpu_torch.solve import MultiFrameConfig, build_fused_two_stage
    from smpltpu_torch.utils.camera import default_intrinsics
    from smpltpu_torch.utils.writeback import params_to_pose

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        d = make_synthetic_model(n_verts=300, seed=0)
        for name, dt in (("f64", torch.float64), ("f32", torch.float32)):
            model = SMPLModel.from_dict(d, device="cpu", dtype=dt)
            cam = default_intrinsics(320, 240, device="cpu", dtype=dt)
            r0 = torch.as_tensor(init_root_rotation(), dtype=dt)
            spec = make_skeleton_spec(model, init_root_rotation(), with_shape=True)
            kp = _video(spec, cam, dt)
            anchors = list(range(0, N_FRAMES, 5))
            starts = list(range(0, N_FRAMES, 15))
            wsize = 20
            cfg1 = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0,
                                    max_iters=12, linear="pcg", cg_iters=30,
                                    fused_cost=True)
            cfg2 = cfg1._replace(beta_shape=1e5, max_iters=8)
            run = build_fused_two_stage(spec, cam, cfg1, cfg2, 10, anchors, starts,
                                        wsize, N_FRAMES, device="cpu", dtype=dt)
            win = np.minimum(np.asarray(starts)[:, None] + np.arange(wsize), N_FRAMES - 1)
            valid = torch.as_tensor(np.asarray(starts)[:, None] + np.arange(wsize)
                                    < N_FRAMES, dtype=dt)
            kpw = kp[torch.as_tensor(win)] * valid[..., None, None]
            kpw[..., 0] = kp[0, :, 0]
            p0 = init_frame_params(device="cpu", dtype=dt)
            st1, st2 = run(p0.expand(len(anchors), -1).clone(), torch.zeros(10, dtype=dt),
                           kp[anchors], r0.expand(len(anchors), 3, 3),
                           kpw, r0.expand(len(starts), wsize, 3, 3), valid)
            out.update({f"{name}_s1_params": st1.params, f"{name}_s1_shape": st1.shape,
                        f"{name}_s1_cost": st1.cost, f"{name}_s2_params": st2.params,
                        f"{name}_s2_cost": st2.cost, f"{name}_s2_iters": st2.iters_run})
            res, jp, jw = keypoint_residuals_and_jacobian(
                st2.params[0], st1.shape, kpw[0], cam, spec, r0)
            out.update({f"{name}_res": res, f"{name}_jp": jp, f"{name}_jw": jw})
            pose = params_to_pose(st2.params[1], r0.expand(wsize, 3, 3), 24)
            shp = st1.shape.expand(wsize, 10).contiguous()
            g_aff, joints = joint_affines(model, shp, pose.rotations, pose.root_pos)
            verts = lbs_torch(shp, g_aff, prepare_lbs_operands(model))
            out.update({f"{name}_joints": joints, f"{name}_verts": verts})
    finally:
        torch.set_num_threads(threads)
    return {k: v.detach().numpy() for k, v in out.items()}


if __name__ == "__main__":
    if sys.argv[1:] != ["--record"]:
        raise SystemExit("usage: python -m tests.smpl_pin --record")
    np.savez(PIN, **compute())
    print(f"wrote {PIN}")
