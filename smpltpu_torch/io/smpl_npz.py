"""SMPL model npz loading: a copy of ``smpltpu/io/smpl_npz.py``, which the
port may not import (its package imports JAX); pinned against it by
``tests/test_torch_cli.py``.

Replaces the reference's ``ark::AvatarModel(path)`` npz reader (usage:
src/main_single_frame.cpp:183, include/Sim3BA.h:360-364) with a plain
numpy loader producing the arrays consumed by
:meth:`smpltpu_torch.models.smpl.SMPLModel.from_dict`.

An SMPL-X npz (Pavlakos et al. 2019; ``SMPLX_NEUTRAL.npz`` and its
kin) is read under its own key names: ``hands_componentsl``/``r``,
``hands_meanl``/``r``, a 55-joint ``kintree_table`` and a ``shapedirs``
that holds the shape directions and then the expression directions
(``smplx/body_models.py::SMPLX``: 300 + 100 columns in the v1.1 files,
10 + 10 in the older ones), of which the port keeps 10 of each.

Also provides the kintree root-fix from the reference's asset-prep tool
(scripts/npz_fixer.py:9-14): raw SMPL npz files store the root joint's
parent as itself/garbage; we rewrite it to -1.
"""

from __future__ import annotations

import numpy as np


def fix_kintree(kintree_table: np.ndarray) -> np.ndarray:
    """Rewrite kintree so the root's parent is -1.

    Parity: scripts/npz_fixer.py:9-14 — wherever parent[i] == child[i],
    set parent to -1. Additionally handles the common raw-SMPL encoding
    where the root parent is a huge unsigned sentinel (2**32 - 1).
    """
    kt = np.asarray(kintree_table).astype(np.int64).copy()
    parent, child = kt[0], kt[1]
    root_mask = (parent == child) | (parent < 0) | (parent >= kt.shape[1])
    kt[0, root_mask] = -1
    return kt


def _dense(a):
    """Densify scipy-sparse-ish objects stored in npz pickles."""
    if hasattr(a, "toarray"):
        return np.asarray(a.toarray())
    arr = np.asarray(a)
    if arr.dtype == object:  # 0-d object array wrapping a sparse matrix
        inner = arr.item()
        if hasattr(inner, "toarray"):
            return np.asarray(inner.toarray())
        return np.asarray(inner)
    return arr


def _smplx_extras(raw, shapedirs: np.ndarray, dtype):
    """The SMPL-X npz's extra arrays and the skinning basis it implies:
    (shapedirs (nV, 3, 20), {hand_components, hand_mean, num_betas})."""
    from smpltpu_torch.models.smplx import SMPLX_NUM_BETAS, SMPLX_NUM_EXPRESSION
    n_cols = shapedirs.shape[-1]
    expr0 = 300 if n_cols >= 400 else SMPLX_NUM_BETAS
    if n_cols < expr0 + SMPLX_NUM_EXPRESSION:
        raise ValueError(f"SMPL-X shapedirs has {n_cols} columns: no "
                         f"{SMPLX_NUM_EXPRESSION} expression directions "
                         f"after the shape ones at {expr0}")
    shapedirs = np.concatenate(
        [shapedirs[..., :SMPLX_NUM_BETAS],
         shapedirs[..., expr0:expr0 + SMPLX_NUM_EXPRESSION]], axis=-1)
    comps = np.stack([_dense(raw["hands_componentsl"]),
                      _dense(raw["hands_componentsr"])]).astype(dtype)
    mean = np.stack([_dense(raw["hands_meanl"]),
                     _dense(raw["hands_meanr"])]).astype(dtype)
    return shapedirs, {"hand_components": comps, "hand_mean": mean,
                       "num_betas": SMPLX_NUM_BETAS}


def load_smpl_npz(path: str, dtype=np.float64) -> dict:
    """Load a SMPL model npz into a dict of plain numpy arrays.

    Returns keys:
      v_template   (nV, 3)      rest-pose template vertices
      shapedirs    (nV, 3, nS)  shape blendshapes
      posedirs     (nV, 3, nP)  pose blendshapes, or None if absent
      J_regressor  (nJ, nV)     joint regressor
      weights      (nV, nJ)     LBS weights
      faces        (nF, 3) int  triangle indices
      parents      (nJ,) int    parent table (root fixed to -1)
      joint_shape_reg (3*nJ, nS)  per-joint shape displacement regressor,
                    the reduced regressor the reference calls
                    ``model.jointShapeReg`` (include/Sim3BA.h:417) —
                    computed here as J_regressor @ shapedirs.

    An SMPL-X file (it has ``hands_componentsl``) adds
    ``hand_components`` (2, 45, 45), ``hand_mean`` (2, 45) and
    ``num_betas`` (10); its ``shapedirs`` come back as the 10 shape and
    the 10 expression directions, (nV, 3, 20).
    """
    raw = np.load(path, allow_pickle=True)
    v_template = _dense(raw["v_template"]).astype(dtype)
    shapedirs = _dense(raw["shapedirs"]).astype(dtype)
    extras = {}
    if "hands_componentsl" in raw.files:
        shapedirs, extras = _smplx_extras(raw, shapedirs, dtype)
    j_reg = _dense(raw["J_regressor"]).astype(dtype)
    weights = _dense(raw["weights"]).astype(dtype)
    faces = _dense(raw["f"]).astype(np.int32)
    kintree = fix_kintree(_dense(raw["kintree_table"]))
    parents = kintree[0].astype(np.int32)
    posedirs = None
    if "posedirs" in raw.files:
        posedirs = _dense(raw["posedirs"]).astype(dtype)
        # stored either (nV, 3, nP) or (nP, nV*3); normalize to (nV, 3, nP)
        if posedirs.ndim == 2:
            n_v = v_template.shape[0]
            posedirs = posedirs.reshape(-1, n_v, 3).transpose(1, 2, 0)

    n_j = j_reg.shape[0]
    n_s = shapedirs.shape[-1]
    # jointShapeReg: how each shape coefficient displaces each joint in the
    # rest pose — (nJ,3,nS) flattened to (3*nJ, nS) in joint-major order,
    # matching the reference's (3*jid + axis, c) indexing
    # (include/Sim3BA.h:152-154).
    joint_shape_reg = np.einsum("jv,vxs->jxs", j_reg, shapedirs).reshape(3 * n_j, n_s)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": j_reg,
        "weights": weights,
        "faces": faces,
        "parents": parents,
        "joint_shape_reg": joint_shape_reg.astype(dtype),
        **extras,
    }


def save_smpl_npz(path: str, model: dict) -> None:
    """Write a model dict back to a SMPL-layout npz (round-trip of
    :func:`load_smpl_npz`; used by the synthetic-model test fixture); a
    whole-body model's hands under SMPL-X's key names."""
    n_j = len(model["parents"])
    kintree = np.zeros((2, n_j), dtype=np.int64)
    kintree[0] = model["parents"]
    kintree[1] = np.arange(n_j)
    out = {
        "v_template": model["v_template"],
        "shapedirs": model["shapedirs"],
        "J_regressor": model["J_regressor"],
        "weights": model["weights"],
        "f": model["faces"],
        "kintree_table": kintree,
    }
    if model.get("posedirs") is not None:
        out["posedirs"] = model["posedirs"]
    if model.get("hand_components") is not None:
        for h, side in enumerate("lr"):
            out[f"hands_components{side}"] = model["hand_components"][h]
            out[f"hands_mean{side}"] = model["hand_mean"][h]
    np.savez(path, **out)
