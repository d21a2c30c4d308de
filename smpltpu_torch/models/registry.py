"""Model registry: resolve a model NAME to a loaded SMPL model dict. A copy
of ``smpltpu/models/registry.py`` that loads through the port's ``io`` and
``models/synthetic.py``; pinned against it by ``tests/test_torch_cli.py``.

The reference hard-codes one npz path per run and ships only git-LFS
pointer stubs for the real SMPL assets (assets/raw/*.npz,
.MISSING_LARGE_BLOBS). This registry gives users the conveniences the
reference lacks (ROADMAP features row):

    resolve_model("female")          # finds basicModel_f_*.npz on the path
    resolve_model("neutral")
    resolve_model("/path/to/any.npz")
    resolve_model("synthetic")       # deterministic test fixture
    resolve_model("synthetic:300")   # reduced vertex count

Search path for named models, in order:
  1. $SMPLTPU_MODEL_DIR
  2. ./assets/raw and ./assets
  3. the repository's own assets/raw and assets
(git-LFS pointer stubs are detected and rejected with a clear message).
The original's last fallback, a fixed mount of the C++ reference's
checkout, is not carried over.

Real model files are distributed by the SMPL project under their own
license — download ``basicModel_{f,m}_lbs_10_207_0_v1.0.0`` /
``basicmodel_neutral_...`` from https://smpl.is.tue.mpg.de, convert the
pkl to npz if needed, and drop them in one of the directories above
(scripts/npz_fixer.py is NOT required: the loader fixes the kintree root
on load, io/smpl_npz.py).
"""

from __future__ import annotations

import os
from typing import Optional

MODEL_PATTERNS = {
    "female": ("basicModel_f", "basicmodel_f"),
    "male": ("basicModel_m", "basicmodel_m"),
    "neutral": ("basicModel_neutral", "basicmodel_neutral"),
}

_LFS_MAGIC = b"version https://git-lfs"


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def model_search_dirs() -> list:
    dirs = []
    env = os.environ.get("SMPLTPU_MODEL_DIR")
    if env:
        dirs.append(env)
    dirs += [os.path.join(os.getcwd(), "assets", "raw"),
             os.path.join(os.getcwd(), "assets"),
             # the repo's own assets dir, cwd-independent (self-contained
             # checkout)
             os.path.join(_REPO_ROOT, "assets", "raw"),
             os.path.join(_REPO_ROOT, "assets")]
    seen, out = set(), []
    for d in dirs:
        if d not in seen and os.path.isdir(d):
            seen.add(d)
            out.append(d)
    return out


def _is_lfs_stub(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(_LFS_MAGIC)) == _LFS_MAGIC
    except OSError:
        return False


def find_model_file(name: str) -> Optional[str]:
    """Locate a named model's npz on the search path; None if absent."""
    pats = MODEL_PATTERNS.get(name)
    if pats is None:
        return None
    for d in model_search_dirs():
        for f in sorted(os.listdir(d)):
            if f.endswith(".npz") and f.startswith(pats):
                p = os.path.join(d, f)
                if not _is_lfs_stub(p):
                    return p
    return None


def model_npz_in_dir(d: str) -> str:
    """Pick the model npz inside a model DIRECTORY: model.npz by the
    avatar-model convention, else the directory's single regular .npz
    file. Raises ValueError when neither holds."""
    cand = os.path.join(d, "model.npz")
    if os.path.isfile(cand):
        return cand
    npzs = sorted(f for f in os.listdir(d)
                  if f.endswith(".npz") and os.path.isfile(os.path.join(d, f)))
    if len(npzs) != 1:
        raise ValueError(
            f"model directory {d} must contain model.npz or exactly one "
            f".npz (found {npzs or 'none'})")
    return os.path.join(d, npzs[0])


def resolve_model(spec: str, dtype=None) -> dict:
    """Resolve a model spec to a loaded model dict (smpltpu_torch.io layout).

    spec: a path to an npz, a registry name ('female'|'male'|'neutral'),
    or 'synthetic[:n_verts]'."""
    import numpy as np

    from smpltpu_torch.io import load_smpl_npz
    from smpltpu_torch.models.synthetic import make_synthetic_model

    dtype = np.float64 if dtype is None else dtype
    # exact-match magic names only: 'synthetic_avatar/' must mean the
    # DIRECTORY of that name, not the built-in synthetic model
    if spec == "synthetic" or spec.startswith("synthetic:"):
        n_verts = 6890
        if ":" in spec:
            n_verts = int(spec.split(":", 1)[1])
        return make_synthetic_model(n_verts=n_verts)
    if os.path.isdir(spec) and spec not in MODEL_PATTERNS:
        # reference parity: the CLIs take the avatar-model DIRECTORY and
        # ark::AvatarModel loads model.npz from it (reference README.md
        # usage `../data/avatar-model/`; pose_prior.txt is picked up from
        # the same directory by load_dataset). A directory named exactly
        # 'female'/'male'/'neutral' does NOT shadow the registry name —
        # those keep their pre-existing search-path resolution.
        spec = model_npz_in_dir(spec)
    if os.path.isfile(spec):
        if _is_lfs_stub(spec):
            raise ValueError(
                f"{spec} is a git-LFS pointer stub, not a real model npz — "
                "fetch the real SMPL asset (see smpltpu_torch.models.registry)")
        return load_smpl_npz(spec, dtype=dtype)
    path = find_model_file(spec)
    if path is not None:
        return load_smpl_npz(path, dtype=dtype)
    raise ValueError(
        f"cannot resolve model '{spec}': not a file, and no "
        f"{MODEL_PATTERNS.get(spec, ('matching',))[0]}*.npz found in "
        f"{model_search_dirs() or '[no search dirs exist]'} — download the "
        "SMPL assets from https://smpl.is.tue.mpg.de and set "
        "$SMPLTPU_MODEL_DIR, or use 'synthetic'")
