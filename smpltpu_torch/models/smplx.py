"""SMPL-X (Pavlakos et al., "Expressive Body Capture", CVPR 2019): the
whole-body model's topology and a seeded stand-in at its published sizes.

SMPL-X has 55 joints: SMPL's body joints 0-21, then the jaw (22), the two
eyes (23, 24), and 15 finger joints a hand (left 25-39, right 40-54, each
hand index 1-3, middle 1-3, pinky 1-3, ring 1-3, thumb 1-3). Its skinning
takes the 10 shape and 10 expression coefficients as one 20-column basis
(``smplx/body_models.py::SMPLX``: ``shape_components = cat([betas,
expression])``), and each hand's 45 joint angles come from a PCA space,
``mean + coeffs @ components`` (MANO, Romero et al. 2017; 12 components
a hand in SMPLify-X's ``cfg_files/fit_smplx.yaml``).

The real arrays are licensed and not in the repository;
:func:`make_synthetic_smplx` makes a deterministic stand-in with the same
structure (``models/registry.py``: ``synthetic_smplx``), and
``io/smpl_npz.py`` reads a real ``SMPLX_*.npz`` under its own key names.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

SMPLX_NUM_JOINTS = 55
SMPLX_NUM_VERTS = 10475
SMPLX_NUM_FACES = 20908
SMPLX_NUM_BETAS = 10
SMPLX_NUM_EXPRESSION = 10
SMPLX_NUM_POSE_BLEND = 9 * (SMPLX_NUM_JOINTS - 1)     # 486
SMPLX_BODY_JOINTS = 22         # joints 0-21, SMPL's body
SMPLX_HAND_JOINTS = 15         # a hand's finger joints
SMPLX_LEFT_HAND = 25           # the first joint of each hand
SMPLX_RIGHT_HAND = 40
SMPLX_HAND_COMPONENTS = 12     # PCA components a hand the fit solves for

SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37,
     38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int32)

# The MediaPipe Hands landmark of each of a hand's 15 SMPL-X joints, in
# SMPL-X's order: index 1-3 <-> 5-7, middle <-> 9-11, pinky <-> 17-19,
# ring <-> 13-15, thumb <-> 1-3. The fingertips (MediaPipe 4, 8, 12, 16,
# 20) are SMPL-X vertices, not joints, and are not observed.
MP_HAND_MAP = np.array([5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3],
                       dtype=np.int32)

# The whole-body keypoint slots: the 17 body slots of SMPL's layout
# (constants.USE_SMPL, the pelvis twice), then the left hand's 15 joints
# and the right hand's: 47 slots, 94 residual rows.
USE_SMPLX = np.concatenate([
    np.array([1, 2, 4, 5, 7, 8, 10, 11, 15, 16, 17, 18, 19, 20, 21, 0, 0]),
    np.arange(SMPLX_LEFT_HAND, SMPLX_LEFT_HAND + SMPLX_HAND_JOINTS),
    np.arange(SMPLX_RIGHT_HAND, SMPLX_RIGHT_HAND + SMPLX_HAND_JOINTS),
]).astype(np.int32)
N_KP_SLOTS_SMPLX = len(USE_SMPLX)


class HandPCA(NamedTuple):
    """The hands' pose space of a whole-body model, as the fits use it: a
    hand's 15 joint angle-axes (45 numbers, joint-major) are
    ``mean[h] + coeffs @ components[h]``, h = 0 the left hand, 1 the
    right."""

    components: Any    # (2, C, 45) tensor: each hand's first C components
    mean: Any          # (2, 45) tensor

    @property
    def n_comps(self) -> int:
        return int(self.components.shape[1])


# Rest joints (metres, T-pose, pelvis at the origin): SMPL's synthetic body
# joints (models/synthetic.py) for 0-21, then the jaw, the eyes and each
# hand's fingers along the arm's axis, spread across the palm.
_BODY_REST = np.array([
    [0.000, 0.000, 0.000], [0.070, -0.090, 0.000], [-0.070, -0.090, 0.000],
    [0.000, 0.110, -0.010], [0.100, -0.480, 0.000], [-0.100, -0.480, 0.000],
    [0.000, 0.250, 0.000], [0.090, -0.870, -0.030], [-0.090, -0.870, -0.030],
    [0.000, 0.310, 0.010], [0.110, -0.930, 0.090], [-0.110, -0.930, 0.090],
    [0.000, 0.530, -0.010], [0.080, 0.450, -0.010], [-0.080, 0.450, -0.010],
    [0.000, 0.610, 0.030], [0.170, 0.470, -0.010], [-0.170, 0.470, -0.010],
    [0.430, 0.460, -0.010], [-0.430, 0.460, -0.010], [0.680, 0.460, -0.010],
    [-0.680, 0.460, -0.010],
])
_FACE_REST = np.array([[0.000, 0.570, 0.050], [0.030, 0.660, 0.090],
                       [-0.030, 0.660, 0.090]])
# a finger's first joint from the wrist, and its step to the next joint
# (left hand; the right mirrors x): index, middle, pinky, ring, thumb
_FINGER_BASE = np.array([[0.090, 0.0, 0.030], [0.095, 0.0, 0.010],
                         [0.080, 0.0, -0.030], [0.090, 0.0, -0.010],
                         [0.030, -0.010, 0.040]])
_FINGER_STEP = np.array([[0.030, 0.0, 0.0], [0.032, 0.0, 0.0],
                         [0.022, 0.0, 0.0], [0.030, 0.0, 0.0],
                         [0.025, 0.0, 0.015]])


def smplx_rest_joints() -> np.ndarray:
    """(55, 3) rest joints of the stand-in model."""
    hands = []
    for wrist, sign in ((_BODY_REST[20], 1.0), (_BODY_REST[21], -1.0)):
        m = np.array([sign, 1.0, 1.0])
        for base, step in zip(_FINGER_BASE, _FINGER_STEP):
            for k in range(3):
                hands.append(wrist + m * (base + k * step))
    return np.concatenate([_BODY_REST, _FACE_REST, np.array(hands)])


def _owners(rng, n_verts: int) -> np.ndarray:
    """Each vertex's owning joint: every joint owns one of the first 55;
    of the rest 80 % go to the body's 22 joints, 4 % to the face's 3 and
    16 % to the 30 finger joints."""
    n_j = SMPLX_NUM_JOINTS
    if n_verts < n_j:
        raise ValueError(f"SMPL-X needs at least {n_j} vertices, got {n_verts}")
    rest = n_verts - n_j
    group = rng.choice(3, size=rest, p=[0.80, 0.04, 0.16])
    lo = np.array([0, SMPLX_BODY_JOINTS, SMPLX_LEFT_HAND])
    width = np.array([SMPLX_BODY_JOINTS, 3, 2 * SMPLX_HAND_JOINTS])
    owner = lo[group] + np.floor(rng.random(rest) * width[group]).astype(np.int64)
    return np.concatenate([np.arange(n_j), owner])


def _faces(v: np.ndarray, n_faces: int) -> np.ndarray:
    """Each vertex with its nearest neighbour and, of its next six, the two
    farthest from that edge (models/synthetic.py's rule, vectorized): two
    triangles a vertex, the first ``n_faces``."""
    from scipy.spatial import cKDTree
    n = v.shape[0]
    k = min(8, n)
    _, nn = cKDTree(v).query(v, k=k)
    near = nn[:, 1]
    e = v[near] - v
    e = e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-12)
    cand = nn[:, 2:k]
    dist = np.linalg.norm(np.cross(e[:, None, :], v[cand] - v[:, None, :]), axis=-1)
    best = np.take_along_axis(cand, np.argsort(-dist, axis=1, kind="stable")[:, :2], 1)
    i = np.arange(n)
    tris = np.stack([np.stack([i, near, best[:, 0]], -1),
                     np.stack([i, best[:, 0], best[:, 1]], -1)], 1).reshape(-1, 3)
    reps = -(-n_faces // tris.shape[0])
    return np.tile(tris, (reps, 1))[:n_faces].astype(np.int32)


def make_synthetic_smplx(n_verts: int = SMPLX_NUM_VERTS,
                         n_faces: int = SMPLX_NUM_FACES,
                         n_betas: int = SMPLX_NUM_BETAS,
                         n_expression: int = SMPLX_NUM_EXPRESSION,
                         with_posedirs: bool = True, seed: int = 0,
                         dtype=np.float64) -> dict:
    """A deterministic SMPL-X stand-in: the keys of
    :func:`smpltpu_torch.io.load_smpl_npz` and, for the whole-body model,
    ``hand_components`` (2, 45, 45) (left, right), ``hand_mean`` (2, 45)
    and ``num_betas``. Vertices scattered around the rest joints (5 cm
    around the body's, 1 cm around the face's and fingers'), each joint
    regressed from the vertices it owns, the template shifted so the
    regressor hits the joint; 10 shape directions (the first along the
    template) and 10 expression directions, both 0.02 m random fields, as
    one 20-column ``shapedirs``; 486 pose blend shapes (0.002); weights
    0.8 to the owner, 0.2 to its parent; each hand's basis a seeded
    orthonormal 45 x 45 whose rows are scaled by standard deviations
    0.5 * 0.8^k, its mean 0.05 rad random."""
    rng = np.random.default_rng(seed)
    n_j = SMPLX_NUM_JOINTS
    parents = SMPLX_PARENTS.copy()
    joints = smplx_rest_joints()
    owner = _owners(rng, n_verts)
    small = owner >= SMPLX_BODY_JOINTS
    spread = np.where(small, 0.01, 0.05)[:, None]
    v_template = joints[owner] + spread * rng.normal(size=(n_verts, 3))
    count = np.bincount(owner, minlength=n_j).astype(np.float64)
    j_reg = np.zeros((n_j, n_verts))
    j_reg[owner, np.arange(n_verts)] = 1.0 / count[owner]
    v_template += (joints - j_reg @ v_template)[owner]

    n_s = n_betas + n_expression
    shapedirs = 0.02 * rng.normal(size=(n_verts, 3, n_s))
    shapedirs[:, :, 0] = 0.05 * v_template
    posedirs = None
    if with_posedirs:
        posedirs = 0.002 * rng.normal(size=(n_verts, 3, 9 * (n_j - 1)))
    weights = np.zeros((n_verts, n_j))
    par = np.where(parents[owner] >= 0, parents[owner], owner)
    weights[np.arange(n_verts), owner] = 0.8
    weights[np.arange(n_verts), par] += 0.2
    weights /= weights.sum(axis=1, keepdims=True)

    std = 0.5 * 0.8 ** np.arange(3 * SMPLX_HAND_JOINTS)
    comps, means = [], []
    for _ in range(2):
        q, _ = np.linalg.qr(rng.normal(size=(45, 45)))
        comps.append(std[:, None] * q.T)
        means.append(0.05 * rng.normal(size=45))
    faces = _faces(v_template, n_faces)
    jsr = np.einsum("jv,vxs->jxs", j_reg, shapedirs).reshape(3 * n_j, n_s)
    return {
        "v_template": v_template.astype(dtype),
        "shapedirs": shapedirs.astype(dtype),
        "posedirs": None if posedirs is None else posedirs.astype(dtype),
        "J_regressor": j_reg.astype(dtype),
        "weights": weights.astype(dtype),
        "faces": faces,
        "parents": parents,
        "joint_shape_reg": jsr.astype(dtype),
        "hand_components": np.stack(comps).astype(dtype),
        "hand_mean": np.stack(means).astype(dtype),
        "num_betas": n_betas,
    }
