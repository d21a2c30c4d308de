"""Synthetic SMPL-compatible model generator.

The reference repo's real SMPL npz assets are git-LFS pointer stubs
(assets/raw/basicModel_*_lbs_10_207_0_v1.0.0.npz are 133-byte pointers,
see SURVEY.md section 2.3), so the test suite and benchmarks need a
deterministic synthetic stand-in with the same structure: 24-joint SMPL
kintree, template vertices, shape blendshapes, joint regressor, LBS
weights, triangle faces. Shapes default to the real SMPL dims but are
scalable down for fast unit tests.

This is a verbatim copy of ``make_synthetic_model`` and
``make_synthetic_gmm`` from ``smpltpu/models/synthetic.py`` (numpy only):
importing the reference module runs ``smpltpu/models/__init__.py``, which
imports JAX. The copies are pinned array-for-array against the reference
by ``tests/test_torch_import.py``.
"""

from __future__ import annotations

import numpy as np

from smpltpu_torch.constants import (
    SMPL_NUM_FACES,
    SMPL_NUM_JOINTS,
    SMPL_NUM_SHAPES,
    SMPL_NUM_VERTS,
    SMPL_PARENTS,
)

# Canonical rest-pose joint locations (meters, T-pose-ish, pelvis near
# origin). Hand-authored to be anatomically plausible so that projected
# keypoints and fitted poses behave like the real model.
_JOINTS_REST = np.array([
    [0.000, 0.000, 0.000],    # 0 pelvis
    [0.070, -0.090, 0.000],   # 1 L hip
    [-0.070, -0.090, 0.000],  # 2 R hip
    [0.000, 0.110, -0.010],   # 3 spine1
    [0.100, -0.480, 0.000],   # 4 L knee
    [-0.100, -0.480, 0.000],  # 5 R knee
    [0.000, 0.250, 0.000],    # 6 spine2 (chest)
    [0.090, -0.870, -0.030],  # 7 L ankle
    [-0.090, -0.870, -0.030], # 8 R ankle
    [0.000, 0.310, 0.010],    # 9 spine3
    [0.110, -0.930, 0.090],   # 10 L foot
    [-0.110, -0.930, 0.090],  # 11 R foot
    [0.000, 0.530, -0.010],   # 12 neck
    [0.080, 0.450, -0.010],   # 13 L collar
    [-0.080, 0.450, -0.010],  # 14 R collar
    [0.000, 0.610, 0.030],    # 15 head
    [0.170, 0.470, -0.010],   # 16 L shoulder
    [-0.170, 0.470, -0.010],  # 17 R shoulder
    [0.430, 0.460, -0.010],   # 18 L elbow
    [-0.430, 0.460, -0.010],  # 19 R elbow
    [0.680, 0.460, -0.010],   # 20 L wrist
    [-0.680, 0.460, -0.010],  # 21 R wrist
    [0.760, 0.460, -0.010],   # 22 L hand
    [-0.760, 0.460, -0.010],  # 23 R hand
])


def make_synthetic_model(
    n_verts: int = SMPL_NUM_VERTS,
    n_shapes: int = SMPL_NUM_SHAPES,
    with_posedirs: bool = True,
    seed: int = 0,
    dtype=np.float64,
) -> dict:
    """Build a deterministic synthetic model dict with the same keys as
    :func:`smpltpu.io.load_smpl_npz`."""
    rng = np.random.default_rng(seed)
    n_j = SMPL_NUM_JOINTS
    parents = SMPL_PARENTS.copy()
    joints = _JOINTS_REST

    # Vertices: scatter around the bones so LBS and rendering look sane.
    owner = rng.integers(0, n_j, size=n_verts)
    v_template = joints[owner] + rng.normal(scale=0.05, size=(n_verts, 3))

    # Joint regressor: each joint regressed from the verts owned by it, with
    # a correction so J_regressor @ v_template == joints exactly.
    j_reg = np.zeros((n_j, n_verts))
    for j in range(n_j):
        idx = np.where(owner == j)[0]
        if len(idx) == 0:  # guarantee at least one vert per joint
            idx = np.array([j % n_verts])
        j_reg[j, idx] = 1.0 / len(idx)
    # correction: add a rank-3 tweak via one extra vertex weight per joint is
    # messy; instead just shift the owned verts so their mean hits the joint.
    for j in range(n_j):
        idx = np.where(j_reg[j] > 0)[0]
        err = joints[j] - j_reg[j] @ v_template
        v_template[idx] += err  # uniform shift keeps the mean exact

    # Shape blendshapes: random displacement fields; the first shape axis is
    # a global "size" direction for realism.
    shapedirs = 0.02 * rng.normal(size=(n_verts, 3, n_shapes))
    shapedirs[:, :, 0] = 0.05 * v_template

    posedirs = None
    if with_posedirs:
        n_p = 9 * (n_j - 1)
        posedirs = 0.002 * rng.normal(size=(n_verts, 3, n_p))

    # LBS weights: soft assignment to the 2 nearest bones (owner + parent).
    weights = np.zeros((n_verts, n_j))
    for v in range(n_verts):
        j = owner[v]
        p = parents[j] if parents[j] >= 0 else j
        weights[v, j] = 0.8
        weights[v, p] += 0.2
    weights /= weights.sum(axis=1, keepdims=True)

    # Faces: each vertex triangulated with its nearest neighbors so the
    # mesh has LOCAL connectivity like a real SMPL surface (round 1 used
    # random vertex triples, whose body-spanning sliver triangles are a
    # pathological and unrepresentative rasterizer workload — every face
    # as large as the whole body).
    n_faces = min(SMPL_NUM_FACES, max(4, 2 * n_verts - 4))
    try:
        from scipy.spatial import cKDTree
        k = min(8, n_verts)
        _, nn = cKDTree(v_template).query(v_template, k=k)
        nn = np.atleast_2d(nn)
        # each vertex's unit edge to its nearest neighbour, then the cross
        # products with every other candidate in one call: elementwise,
        # the same arithmetic as one np.cross a pair, in a fraction of the
        # time (a second a model of 6890 vertices)
        near = nn[:, 1].astype(int) if k >= 2 else np.arange(n_verts)
        e = np.empty((n_verts, 3))
        for i in range(n_verts):
            d = v_template[near[i]] - v_template[i]
            e[i] = d / (np.linalg.norm(d) + 1e-12)
        cand = nn[:, 2:k].astype(int)
        crs = np.cross(e[:, None, :], v_template[cand] - v_template[:, None, :])
        tris = []
        for i in range(n_verts):
            a = int(near[i])
            # among the remaining neighbors pick the two giving the
            # FATTEST triangles (largest distance from the i-a line):
            # pure nearest-neighbor triples of random points are
            # degenerate slivers, which no rasterizer covers stably
            dist = [np.linalg.norm(c) for c in crs[i]]
            best = [int(cand[i, c]) for c in sorted(range(len(dist)),
                                                    key=lambda c: -dist[c])]
            if best:
                tris.append((i, a, best[0]))
            if len(best) > 1:
                tris.append((i, best[0], best[1]))
        faces = np.asarray(tris, np.int32)[:n_faces]
    except Exception:  # scipy absent: fall back to index-local triples
        idx = np.arange(n_faces)
        faces = np.stack([idx % n_verts, (idx + 1) % n_verts,
                          (idx + 2) % n_verts], axis=1).astype(np.int32)
    if faces.shape[0] < n_faces:  # pad by repeating (harmless for tests)
        reps = -(-n_faces // max(faces.shape[0], 1))
        faces = np.tile(faces, (reps, 1))[:n_faces]

    joint_shape_reg = np.einsum("jv,vxs->jxs", j_reg, shapedirs).reshape(3 * n_j, n_shapes)

    return {
        "v_template": v_template.astype(dtype),
        "shapedirs": shapedirs.astype(dtype),
        "posedirs": None if posedirs is None else posedirs.astype(dtype),
        "J_regressor": j_reg.astype(dtype),
        "weights": weights.astype(dtype),
        "faces": faces,
        "parents": parents,
        "joint_shape_reg": joint_shape_reg.astype(dtype),
    }



def make_synthetic_gmm(n_comps: int = 8, dim: int = 69, seed: int = 0, dtype=np.float64) -> dict:
    """Deterministic synthetic GMM pose prior with the same keys as
    :func:`smpltpu_torch.io.load_pose_prior_txt` (8 comps x 69 dims by
    default, matching data/avatar-model/pose_prior.txt's header)."""
    rng = np.random.default_rng(seed)
    weights = rng.dirichlet(np.ones(n_comps))
    means = 0.3 * rng.normal(size=(n_comps, dim))
    covs = np.zeros((n_comps, dim, dim))
    for k in range(n_comps):
        a = rng.normal(size=(dim, dim)) * 0.05
        covs[k] = a @ a.T + 0.05 * np.eye(dim)
    prec = np.array([np.linalg.inv(c) for c in covs])
    prec_cho = np.array([np.linalg.cholesky(p) for p in prec])
    _, logdet = np.linalg.slogdet(covs)
    return {
        "weights": weights.astype(dtype),
        "means": means.astype(dtype),
        "covs": covs.astype(dtype),
        "prec_cho": prec_cho.astype(dtype),
        "logdet_cov": logdet.astype(dtype),
    }
