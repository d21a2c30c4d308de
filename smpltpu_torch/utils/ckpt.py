"""Checkpoints of the multi CLI's ``--resume`` (port of
``smpltpu/utils/ckpt.py``, its ``npz`` backend).

One numpy archive per checkpoint, written atomically (a temporary file,
then ``os.replace``), so a crash mid-save cannot destroy the previous one.
The reference's second backend, ``orbax``, is a JAX library: here it is
refused with a message (ROADMAP.md, "Do not port"). An archive written by
either package is read by the other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

ORBAX_REFUSED = ("the orbax checkpoint backend is a JAX library and is not "
                 "ported (ROADMAP.md, 'Do not port'); use --ckpt-backend npz")


def _npz_path(path_base: str) -> str:
    return path_base + ".npz"


def _check_backend(backend: str, allowed) -> None:
    if backend == "orbax":
        raise ValueError(ORBAX_REFUSED)
    if backend not in allowed:
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def save_checkpoint(path_base: str, tree: Dict[str, np.ndarray],
                    backend: str = "npz") -> str:
    """Persist a flat dict of numpy arrays; returns the artifact path."""
    _check_backend(backend, ("npz",))
    path = _npz_path(path_base)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **tree)
    os.replace(tmp, path)  # atomic on POSIX: never a torn checkpoint
    return path


def load_checkpoint(path_base: str,
                    backend: str = "auto") -> Optional[Dict[str, np.ndarray]]:
    """Restore the dict saved by save_checkpoint; None if nothing exists.
    ``"auto"`` and ``"npz"`` read the npz archive alike."""
    _check_backend(backend, ("auto", "npz"))
    npath = _npz_path(path_base)
    if not os.path.isfile(npath):
        return None
    with np.load(npath) as z:
        return dict(z)
