"""Frozen, seeded copies of the generators the benchmark feeds the program.

* ``make_model``: the synthetic SMPL model of
  ``smpltpu_torch/models/synthetic.py::make_synthetic_model`` (lines
  61-168), made on the device from a
  ``torch.Generator`` in a few large calls instead of numpy's per-vertex
  loops: vertices scattered around the 24 rest joints (0.05 m), each
  joint regressed from the vertices it owns and those shifted so that the
  regressor hits the joint, shape blend shapes (0.02, the first along the
  template), pose blend shapes (0.002), skinning weights 0.8 to the owner
  and 0.2 to its parent, and each vertex triangulated with its nearest
  neighbour and the two of its next six neighbours farthest from that
  edge. The first 24 vertices are owned by joints 0-23, so that no joint
  owns none (the original falls back to vertex j % nV).
* ``motion`` and ``keypoints``: bench.py's synthetic video (bench.py
  lines 85-117, and ``smpltpu_torch/bench.py::workload``, lines 221-263): a smooth motion whose phase folds every 2000 frames, its
  joints projected through the skeleton model and 1 px of Gaussian noise
  on every one of the 17 visible slots; here a motion's pose offsets and
  drift come from a seed of its own, on the device.
* ``video_keypoints``, ``feed_keypoints``: what a run feeds the program.
  The motions are a fixed set, the traffic file's (``motion_seed``,
  ``motions``), so that every ``--seed`` gives the run the same work: the
  seed orders the videos and makes the noise and the model's weights. A
  live feed is one fixed recording (its motion, ``start_phase`` and
  ``data_seed``).

Neither imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference as ref

# the rest joints of models/synthetic.py (metres, pelvis at the origin)
JOINTS_REST = [
    [0.000, 0.000, 0.000], [0.070, -0.090, 0.000], [-0.070, -0.090, 0.000],
    [0.000, 0.110, -0.010], [0.100, -0.480, 0.000], [-0.100, -0.480, 0.000],
    [0.000, 0.250, 0.000], [0.090, -0.870, -0.030], [-0.090, -0.870, -0.030],
    [0.000, 0.310, 0.010], [0.110, -0.930, 0.090], [-0.110, -0.930, 0.090],
    [0.000, 0.530, -0.010], [0.080, 0.450, -0.010], [-0.080, 0.450, -0.010],
    [0.000, 0.610, 0.030], [0.170, 0.470, -0.010], [-0.170, 0.470, -0.010],
    [0.430, 0.460, -0.010], [-0.430, 0.460, -0.010], [0.680, 0.460, -0.010],
    [-0.680, 0.460, -0.010], [0.760, 0.460, -0.010], [-0.760, 0.460, -0.010],
]


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one part of a run (the model, a video, a sample),
    from the run's ``--seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def make_model(device, seed: int, n_verts: int = 6890, n_shapes: int = 10,
               n_faces: int = 13776, n_pose_blend: int = 207) -> dict:
    """The model's arrays as float32 tensors on ``device`` (faces int32,
    parents int64): the keys of an SMPL npz."""
    g = generator(device, seed)
    f32 = dict(device=device, dtype=torch.float32)
    n_j = ref.N_JOINTS
    joints = torch.tensor(JOINTS_REST, **f32)
    parents = torch.as_tensor(ref.PARENTS, device=device)
    owner = torch.randint(0, n_j, (n_verts,), generator=g, device=device)
    owner[:n_j] = torch.arange(n_j, device=device)
    v_t = joints[owner] + 0.05 * torch.randn((n_verts, 3), generator=g, **f32)
    count = torch.zeros(n_j, **f32).index_add_(0, owner, torch.ones(n_verts, **f32))
    j_reg = torch.zeros((n_j, n_verts), **f32)
    j_reg[owner, torch.arange(n_verts, device=device)] = 1.0 / count[owner]
    v_t = v_t + (joints - j_reg @ v_t)[owner]
    shapedirs = 0.02 * torch.randn((n_verts, 3, n_shapes), generator=g, **f32)
    shapedirs[:, :, 0] = 0.05 * v_t
    posedirs = 0.002 * torch.randn((n_verts, 3, n_pose_blend), generator=g, **f32)
    weights = torch.zeros((n_verts, n_j), **f32)
    par = torch.where(parents[owner] >= 0, parents[owner], owner)
    rows = torch.arange(n_verts, device=device)
    weights[rows, owner] = 0.8
    weights[rows, par] += 0.2
    weights = weights / weights.sum(1, keepdim=True)
    return {"v_template": v_t, "shapedirs": shapedirs, "posedirs": posedirs,
            "J_regressor": j_reg, "weights": weights,
            "faces": _faces(v_t, n_faces), "parents": parents,
            "joint_shape_reg": torch.einsum("jv,vxs->jxs", j_reg, shapedirs
                                            ).reshape(3 * n_j, n_shapes)}


def _faces(v, n_faces: int, k: int = 8, block: int = 2048):
    """Each vertex i with its nearest neighbour a and, of its next k - 2
    neighbours, the two (b0, b1) farthest from the line i-a: triangles
    (i, a, b0), (i, b0, b1), vertex by vertex, the first ``n_faces``."""
    n = v.shape[0]
    nn = torch.cat([torch.topk(torch.cdist(v[s:s + block], v), k, largest=False
                               ).indices for s in range(0, n, block)])
    near = nn[:, 1]
    e = v[near] - v
    e = e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-12)
    cand = nn[:, 2:]
    dist = torch.linalg.norm(torch.cross(e[:, None, :].expand(-1, k - 2, -1),
                                         v[cand] - v[:, None, :], dim=-1), dim=-1)
    order = torch.argsort(-dist, dim=1, stable=True)
    best = torch.gather(cand, 1, order[:, :2])
    i = torch.arange(n, device=v.device)
    tris = torch.stack([torch.stack([i, near, best[:, 0]], -1),
                        torch.stack([i, best[:, 0], best[:, 1]], -1)], 1)
    faces = tris.reshape(-1, 3)
    reps = -(-n_faces // faces.shape[0])
    return faces.repeat(reps, 1)[:n_faces].to(torch.int32)


def motion(device, seed: int, n_frames: int, start: int = 0) -> torch.Tensor:
    """bench.py's ground-truth motion (n_frames, 76) float32 from frame
    ``start`` of a stream whose per-joint offsets (0.15 rad) and drift
    (0.003 rad a frame of phase) come from ``seed``: scale 1, root
    angle-axis (2e-3, 1e-3, 0) and translation (0.1 + 1e-3, -0.1, 3.2) per
    frame of phase, the phase folding every 2000 frames."""
    g = generator(device, seed)
    f32 = dict(device=device, dtype=torch.float32)
    base = 0.15 * torch.randn((23, 3), generator=g, **f32)
    drift = 0.003 * torch.randn((23, 3), generator=g, **f32)
    fidx = torch.arange(start, start + n_frames, **f32)
    ph = 1000.0 - torch.abs(torch.remainder(fidx, 2000.0) - 1000.0)
    gt = torch.zeros((n_frames, ref.P_DIM), **f32)
    gt[:, 0] = 1.0
    gt[:, 1] = 2e-3 * ph
    gt[:, 2] = 1e-3 * ph
    gt[:, 4] = 0.1 + 1e-3 * ph
    gt[:, 5] = -0.1
    gt[:, 6] = 3.2
    gt[:, 7:] = (base[None] + ph[:, None, None] * drift[None]).reshape(n_frames, 69)
    return gt


def keypoints(model: dict, cam: ref.Camera, gt: torch.Tensor, seed: int,
              noise_px: float = 1.0) -> torch.Tensor:
    """(F, 17, 4) float32 on gt's device, rows [joint, u, v, 1]: the
    joints of ``gt`` under the zero shape and R0 projected, plus
    ``noise_px`` Gaussian noise from ``seed``."""
    body = ref.make_body(model, ref.F64)
    dev = gt.device
    g = generator(dev, seed)
    r0 = torch.as_tensor(ref.R0, device=dev, dtype=torch.float64)
    zero = torch.zeros(ref.N_SHAPES, device=dev, dtype=torch.float64)
    uv = ref.project(ref.skeleton_joints(body, gt.double(), zero, r0), cam)
    use = torch.as_tensor(ref.USE_SMPL, device=dev)
    n = gt.shape[0]
    kp = torch.zeros((n, len(ref.USE_SMPL), 4), device=dev, dtype=torch.float32)
    kp[..., 0] = use.to(torch.float32)
    kp[..., 1:3] = uv[:, use].float() + noise_px * torch.randn(
        (n, len(ref.USE_SMPL), 2), generator=g, device=dev, dtype=torch.float32)
    kp[..., 3] = 1.0
    return kp


def video_keypoints(model: dict, cam: ref.Camera, traffic: dict, seed: int,
                    k: int, device) -> torch.Tensor:
    """The keypoints (F, 17, 4) of the run's k-th video: motion
    ``order[k % motions]`` of the traffic's fixed set, the order a
    permutation drawn from ``seed``, the noise from (``seed``, k)."""
    n_m = traffic["motions"]
    order = np.random.default_rng(sub_seed(seed, 4)).permutation(n_m)
    m = int(order[k % n_m])
    gt = motion(device, sub_seed(traffic["motion_seed"], m), traffic["frames"])
    return keypoints(model, cam, gt, sub_seed(seed, 2, k), traffic["noise_px"])


def feed_keypoints(model: dict, cam: ref.Camera, traffic: dict, n_frames: int,
                   device) -> torch.Tensor:
    """A live feed's first ``n_frames`` keypoints: the traffic's one motion
    from its ``start_phase``, the noise from its ``data_seed``."""
    gt = motion(device, sub_seed(traffic["motion_seed"], 0), n_frames,
                traffic["start_phase"])
    return keypoints(model, cam, gt, sub_seed(traffic["data_seed"], 2),
                     traffic["noise_px"])
