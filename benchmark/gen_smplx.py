"""Seeded generators of configuration ``multi_smplx``: the SMPL-X stand-in
and the whole-body videos the benchmark feeds the program.

* ``make_model``: ``smpltpu_torch/models/smplx.py::make_synthetic_smplx``
  made on the device from a ``torch.Generator`` (frozen here, as
  ``gen.make_model`` freezes SMPL's): 55 rest joints (SMPL's synthetic
  body, the jaw and the eyes, five fingers a hand along the arm's axis),
  vertices owned 80 / 4 / 16 % by the body's, the face's and the fingers'
  joints (the first 55 one a joint) and scattered 5 cm (body) or 1 cm
  around them, each joint regressed from the vertices it owns, 10 shape
  and 10 expression directions (0.02 m; the first along the template),
  486 pose blend shapes (0.002), weights 0.8 to the owner and 0.2 to its
  parent, faces by ``gen._faces``, each hand's basis a seeded orthonormal
  45 x 45 whose rows are scaled by 0.5 * 0.8^k, its mean 0.05 rad.
* ``motion``: ``gen.motion``'s body on joints 0-21 (the frame vector's
  first 70 numbers), and 24 hand coefficients, each a sum of two
  sinusoids of periods and phases drawn from the motion's seed.
* ``video_keypoints``: the run's k-th video, as ``gen.video_keypoints``
  orders and noises them, 47 slots all visible.

Nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import gen
from benchmark import reference as ref
from benchmark import reference_smplx as refx

FACE_REST = [[0.000, 0.570, 0.050], [0.030, 0.660, 0.090], [-0.030, 0.660, 0.090]]
FINGER_BASE = [[0.090, 0.0, 0.030], [0.095, 0.0, 0.010], [0.080, 0.0, -0.030],
               [0.090, 0.0, -0.010], [0.030, -0.010, 0.040]]
FINGER_STEP = [[0.030, 0.0, 0.0], [0.032, 0.0, 0.0], [0.022, 0.0, 0.0],
               [0.030, 0.0, 0.0], [0.025, 0.0, 0.015]]


def rest_joints() -> np.ndarray:
    """(55, 3) rest joints: gen's body 0-21, the face, then each hand."""
    body = np.asarray(gen.JOINTS_REST[:22])
    hands = []
    for wrist, sign in ((body[20], 1.0), (body[21], -1.0)):
        m = np.array([sign, 1.0, 1.0])
        for base, step in zip(FINGER_BASE, FINGER_STEP):
            for k in range(3):
                hands.append(wrist + m * (np.asarray(base) + k * np.asarray(step)))
    return np.concatenate([body, np.asarray(FACE_REST), np.asarray(hands)])


def make_model(device, seed: int, n_verts: int = 10475, n_faces: int = 20908,
               n_betas: int = 10, n_expression: int = 10, n_pose_blend: int = 486,
               **_) -> dict:
    """The model's arrays as float32 tensors on ``device`` (faces int32,
    parents int64): the keys of an SMPL npz, and ``hand_components`` (2,
    45, 45), ``hand_mean`` (2, 45)."""
    g = gen.generator(device, seed)
    f32 = dict(device=device, dtype=torch.float32)
    n_j = refx.N_JOINTS
    joints = torch.tensor(rest_joints(), **f32)
    parents = torch.as_tensor(refx.PARENTS, device=device)
    rest = n_verts - n_j
    group = torch.multinomial(torch.tensor([0.80, 0.04, 0.16], **f32), rest,
                              replacement=True, generator=g)
    lo = torch.tensor([0, 22, 25], device=device)[group]
    width = torch.tensor([22, 3, 30], device=device)[group]
    pick = torch.floor(torch.rand(rest, generator=g, **f32) * width).long()
    owner = torch.cat([torch.arange(n_j, device=device), lo + pick])
    spread = torch.where(owner >= 22, 0.01, 0.05).to(torch.float32)[:, None]
    v_t = joints[owner] + spread * torch.randn((n_verts, 3), generator=g, **f32)
    count = torch.zeros(n_j, **f32).index_add_(0, owner, torch.ones(n_verts, **f32))
    j_reg = torch.zeros((n_j, n_verts), **f32)
    j_reg[owner, torch.arange(n_verts, device=device)] = 1.0 / count[owner]
    v_t = v_t + (joints - j_reg @ v_t)[owner]
    n_s = n_betas + n_expression
    shapedirs = 0.02 * torch.randn((n_verts, 3, n_s), generator=g, **f32)
    shapedirs[:, :, 0] = 0.05 * v_t
    posedirs = 0.002 * torch.randn((n_verts, 3, n_pose_blend), generator=g, **f32)
    weights = torch.zeros((n_verts, n_j), **f32)
    par = torch.where(parents[owner] >= 0, parents[owner], owner)
    rows = torch.arange(n_verts, device=device)
    weights[rows, owner] = 0.8
    weights[rows, par] += 0.2
    weights = weights / weights.sum(1, keepdim=True)
    std = 0.5 * 0.8 ** torch.arange(45, **f32)
    comps, means = [], []
    for _ in range(2):
        q, _ = torch.linalg.qr(torch.randn((45, 45), generator=g, **f32))
        comps.append(std[:, None] * q.T)
        means.append(0.05 * torch.randn(45, generator=g, **f32))
    return {"v_template": v_t, "shapedirs": shapedirs, "posedirs": posedirs,
            "J_regressor": j_reg, "weights": weights,
            "faces": gen._faces(v_t, n_faces), "parents": parents,
            "joint_shape_reg": torch.einsum("jv,vxs->jxs", j_reg, shapedirs
                                            ).reshape(3 * n_j, n_s),
            "hand_components": torch.stack(comps), "hand_mean": torch.stack(means)}


def motion(device, seed: int, n_frames: int, hands: dict) -> torch.Tensor:
    """(n_frames, 94) float32: ``gen.motion``'s body on joints 0-21, and
    each hand coefficient a1 sin(2 pi f / T1 + p1) + a2 sin(2 pi f / T2 +
    p2), T from ``hands["period_s"]`` at ``hands["fps"]``, each a up to
    half of ``hands["amplitude"]``, from a sub-seed of ``seed``."""
    f32 = dict(device=device, dtype=torch.float32)
    gt = torch.zeros((n_frames, refx.P_DIM), **f32)
    gt[:, :refx.B1] = gen.motion(device, seed, n_frames)[:, :refx.B1]
    g = gen.generator(device, gen.sub_seed(seed, 1))
    n_c = 2 * hands["coeffs_per_hand"]          # (term, coefficient) below
    lo, hi = (hands["fps"] * s for s in hands["period_s"])
    period = lo + (hi - lo) * torch.rand((2, n_c), generator=g, **f32)
    phase = 2.0 * math.pi * torch.rand((2, n_c), generator=g, **f32)
    amp = 0.5 * hands["amplitude"] * torch.rand((2, n_c), generator=g, **f32)
    fidx = torch.arange(n_frames, **f32)[:, None, None]
    waves = amp * torch.sin(2.0 * math.pi * fidx / period + phase)
    gt[:, refx.B1:] = waves.sum(1)
    return gt


def keypoints(model: dict, cam: ref.Camera, gt: torch.Tensor, seed: int,
              noise_px: float = 1.0) -> torch.Tensor:
    """(F, 47, 4) float32 rows [joint, u, v, 1]: the joints of ``gt``
    under the zero shape and R0 projected, plus ``noise_px`` of noise."""
    body = refx.make_body(model, ref.F64)
    dev = gt.device
    g = gen.generator(dev, seed)
    r0 = torch.as_tensor(ref.R0, device=dev, dtype=torch.float64)
    zero = torch.zeros(refx.N_BETAS, device=dev, dtype=torch.float64)
    n = gt.shape[0]
    use = torch.as_tensor(refx.USE_SMPLX, device=dev)
    kp = torch.zeros((n, len(refx.USE_SMPLX), 4), device=dev, dtype=torch.float32)
    kp[..., 0] = use.to(torch.float32)
    for s in range(0, n, 2000):
        uv = ref.project(refx.skeleton_joints(body, gt[s:s + 2000].double(), zero, r0),
                         cam)
        kp[s:s + 2000, :, 1:3] = uv[:, use].float()
    kp[..., 1:3] += noise_px * torch.randn((n, len(refx.USE_SMPLX), 2), generator=g,
                                           device=dev, dtype=torch.float32)
    kp[..., 3] = 1.0
    return kp


def video_keypoints(model: dict, cam: ref.Camera, traffic: dict, seed: int,
                    k: int, device) -> torch.Tensor:
    """The run's k-th video (F, 47, 4): motion ``order[k % motions]`` of
    the traffic's fixed set, the order from ``seed``, the noise from
    (``seed``, k)."""
    n_m = traffic["motions"]
    order = np.random.default_rng(gen.sub_seed(seed, 4)).permutation(n_m)
    m = int(order[k % n_m])
    gt = motion(device, gen.sub_seed(traffic["motion_seed"], m), traffic["frames"],
                traffic["hands"])
    return keypoints(model, cam, gt, gen.sub_seed(seed, 2, k), traffic["noise_px"])
