"""MediaPipe keypoint JSON loading and the MP->SMPL joint mapping: a copy of
``smpltpu/io/keypoints.py`` that reads the port's constants, with the
port's own C++ parallel parser (``smpltpu_torch/native``) beside the
Python one. Pinned against the original by ``tests/test_torch_cli.py``
and ``tests/test_torch_native.py``.

Replaces the reference's ``load_mp_json`` (robust version: include/Utils.h:61-99;
a divergent duplicate lives at src/main_single_frame.cpp:69-102). Input files
are per-frame JSON lists of 33 landmark dicts {x, y, z, visibility} in
normalized image coordinates (produced by
data/scripts/extract_keypoints_mediapipe.py:34-52); an empty list means no
person was detected in the frame.

Dense layout: instead of a ragged list of (jid, u, v) observations, the
loader can emit a dense, static-shape per-frame array with N_KP_SLOTS rows
(one per entry of the reference's 17-slot USE_SMPL iteration, pelvis slot
duplicated — see smpltpu_torch/constants.py) and a validity column, so a whole
video batches into one (F, 17, 3) tensor.

The whole-body layout (SMPL-X, ``layout="smplx"``) has 47 slots: the 17
body slots, then each hand's 15 finger joints (``models/smplx.py``:
``USE_SMPLX``, ``MP_HAND_MAP``). Its frame files are objects
``{"pose": [33 landmarks], "left_hand": [21], "right_hand": [21]}`` (a
MediaPipe Holistic frame; an empty hand list leaves that hand's slots
invisible); a file in the 33-landmark list format gives its body slots
and invisible hands.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from smpltpu_torch.constants import MP_MAP, N_KP_SLOTS, USE_SMPL, VISIBILITY_THRESHOLD


def list_sorted(directory: str, exts: Sequence[str]) -> List[str]:
    """Sorted regular files in `directory` with one of `exts` (lowercased).

    Parity: include/Utils.h:33-41 (lexicographic sort of paths).
    """
    exts = {e.lower() for e in exts}
    out = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and os.path.splitext(name)[1].lower() in exts:
            out.append(path)
    return sorted(out)


def _coord(lm, key):
    """Return (ok, value) for a numeric landmark field (Utils.h:51-58)."""
    if isinstance(lm, dict) and key in lm and isinstance(lm[key], (int, float)) \
            and not isinstance(lm[key], bool):
        return True, float(lm[key])
    return False, 0.0


def _number(lm, key, default):
    ok, v = _coord(lm, key)
    return v if ok else default


def _midpoint(landmarks, a: int, b: int, default_vis: float):
    """Midpoint of two landmarks; vis = min of the two visibilities.

    Parity: include/Utils.h:67-77. `default_vis` is 1.0 in the robust loader
    (Utils.h:74-75) but 0.0 in main_single_frame.cpp:78 — the caller picks.
    """
    if a >= len(landmarks) or b >= len(landmarks):
        return False, 0.0, 0.0, 0.0
    oka_x, xa = _coord(landmarks[a], "x")
    oka_y, ya = _coord(landmarks[a], "y")
    okb_x, xb = _coord(landmarks[b], "x")
    okb_y, yb = _coord(landmarks[b], "y")
    if not (oka_x and oka_y and okb_x and okb_y):
        return False, 0.0, 0.0, 0.0
    x = 0.5 * (xa + xb)
    y = 0.5 * (ya + yb)
    vis = min(_number(landmarks[a], "visibility", default_vis),
              _number(landmarks[b], "visibility", default_vis))
    return True, x, y, vis


def load_mp_json(
    path: str,
    width: int,
    height: int,
    midpoint_default_vis: float = 1.0,
) -> List[Tuple[int, float, float]]:
    """Load one MediaPipe JSON into a list of (smpl_jid, u_px, v_px).

    Semantics parity with include/Utils.h:61-99:
      * SMPL joint 0 (pelvis) synthesized as midpoint of MP hips 23/24;
        SMPL joint 6 (chest) as midpoint of MP shoulders 11/12 (computed but
        never emitted, since 6 is not in the USE_SMPL slot list);
      * other joints looked up through MP_MAP;
      * observations with visibility < 0.5 dropped;
      * normalized coords scaled to pixels by (width, height);
      * the trailing duplicated pelvis slot (USE_SMPL quirk) emits the pelvis
        observation twice, exactly like the reference's 17-iteration loop.

    Set midpoint_default_vis=0.0 to reproduce the divergent duplicate loader
    in src/main_single_frame.cpp:74-78 instead.
    """
    try:
        with open(path) as f:
            landmarks = json.load(f)
    except (OSError, ValueError):
        # unreadable or corrupt file -> treat as "no detection" (the
        # reference skips empty-keypoint frames; we degrade the same way)
        return []
    return _body_observations(landmarks, width, height, midpoint_default_vis)


def _body_observations(landmarks, width: int, height: int,
                       midpoint_default_vis: float
                       ) -> List[Tuple[int, float, float]]:
    """:func:`load_mp_json` on a frame's parsed landmark list."""
    if not isinstance(landmarks, list):
        return []

    have_pel, pel_x, pel_y, pel_vis = _midpoint(landmarks, 23, 24, midpoint_default_vis)
    have_ch, ch_x, ch_y, ch_vis = _midpoint(landmarks, 11, 12, midpoint_default_vis)

    out: List[Tuple[int, float, float]] = []
    for sid in USE_SMPL.tolist():
        if sid == 0:
            ok, x, y, vis = have_pel, pel_x, pel_y, pel_vis
        elif sid == 6:
            ok, x, y, vis = have_ch, ch_x, ch_y, ch_vis
        else:
            mp = int(MP_MAP[sid])
            if mp < 0 or mp >= len(landmarks):
                ok, x, y, vis = False, 0.0, 0.0, 0.0
            else:
                ok_x, x = _coord(landmarks[mp], "x")
                ok_y, y = _coord(landmarks[mp], "y")
                ok = ok_x and ok_y
                vis = _number(landmarks[mp], "visibility", 1.0)
        if not ok or vis < VISIBILITY_THRESHOLD:
            continue
        out.append((sid, x * width, y * height))
    return out


def keypoints_to_dense(kps: List[Tuple[int, float, float]]) -> np.ndarray:
    """Pack a ragged keypoint list into the dense (N_KP_SLOTS, 4) layout
    [jid, u, v, valid], slot order = the USE_SMPL iteration order.

    Duplicate pelvis observations fill the two pelvis slots in order.
    """
    dense = np.zeros((N_KP_SLOTS, 4), dtype=np.float64)
    dense[:, 0] = USE_SMPL
    used = [False] * N_KP_SLOTS
    for jid, u, v in kps:
        for s in range(N_KP_SLOTS):
            if not used[s] and int(USE_SMPL[s]) == jid:
                dense[s] = (jid, u, v, 1.0)
                used[s] = True
                break
    return dense


def load_holistic_json(path: str, width: int, height: int,
                       midpoint_default_vis: float = 1.0) -> np.ndarray:
    """One frame file in the whole-body layout: (47, 4) rows [jid, u, v,
    valid], the body's 17 slots as :func:`load_mp_json` reads them, then
    the left hand's 15 and the right hand's. A hand landmark is observed
    where it has numeric x and y and a visibility (1.0 where absent, as
    MediaPipe Hands gives none) of at least VISIBILITY_THRESHOLD. A list
    file is the body alone; an unreadable file, no detection."""
    from smpltpu_torch.models.smplx import MP_HAND_MAP, USE_SMPLX
    try:
        with open(path) as f:
            frame = json.load(f)
    except (OSError, ValueError):
        frame = []
    body = frame.get("pose", []) if isinstance(frame, dict) else frame
    dense = np.zeros((len(USE_SMPLX), 4), dtype=np.float64)
    dense[:, 0] = USE_SMPLX
    dense[:N_KP_SLOTS] = keypoints_to_dense(_body_observations(
        body, width, height, midpoint_default_vis))
    if not isinstance(frame, dict):
        return dense
    for h, key in enumerate(("left_hand", "right_hand")):
        lms = frame.get(key)
        if not isinstance(lms, list):
            continue
        for k, mp in enumerate(MP_HAND_MAP.tolist()):
            if mp >= len(lms):
                continue
            ok_x, x = _coord(lms[mp], "x")
            ok_y, y = _coord(lms[mp], "y")
            if (ok_x and ok_y and _number(lms[mp], "visibility", 1.0)
                    >= VISIBILITY_THRESHOLD):
                s = N_KP_SLOTS + h * len(MP_HAND_MAP) + k
                dense[s, 1:] = (x * width, y * height, 1.0)
    return dense


def load_keypoint_dir(
    directory: str,
    width: int,
    height: int,
    midpoint_default_vis: float = 1.0,
    backend: str = "auto",
    layout: str = "smpl",
) -> Tuple[np.ndarray, List[str]]:
    """Load every .json in `directory` (sorted) into one (F, N_KP_SLOTS, 4)
    dense batch. Frames with no detection get an all-invalid row block,
    keeping batch shapes static (graceful-skip parity: the reference skips
    empty frames at src/main_single_frame.cpp:200-203; we mask them).

    backend: "python" or "native" (the C++ parser of
    ``smpltpu_torch.native``, a thread per core) forces one parser; both
    give the same batch bit for bit. "auto" is "native". Unlike the
    reference's "auto", which falls back to Python without a word, a
    library that does not build raises here, with the compiler's output
    and the advice to pass ``backend="python"``.

    ``layout="smplx"``: the whole-body layout (F, 47, 4)
    (:func:`load_holistic_json`). The native parser reads SMPL's layout
    only, so there "auto" is "python" and "native" raises."""
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"backend must be auto|python|native, got {backend!r}")
    if layout not in ("smpl", "smplx"):
        raise ValueError(f"layout must be smpl|smplx, got {layout!r}")
    paths = list_sorted(directory, [".json"])
    if layout == "smplx":
        if backend == "native":
            raise ValueError("the native keypoint parser reads SMPL's 17-slot "
                             "layout only; the whole-body layout needs "
                             "backend='python' (or 'auto')")
        frames = [load_holistic_json(p, width, height, midpoint_default_vis)
                  for p in paths]
        from smpltpu_torch.models.smplx import N_KP_SLOTS_SMPLX
        return (np.stack(frames) if frames
                else np.zeros((0, N_KP_SLOTS_SMPLX, 4))), paths
    if backend != "python":
        from smpltpu_torch import native
        return native.load_keypoint_dir_native(
            paths, width, height, midpoint_default_vis), paths
    frames = [
        keypoints_to_dense(load_mp_json(p, width, height, midpoint_default_vis))
        for p in paths
    ]
    if frames:
        batch = np.stack(frames)
    else:
        batch = np.zeros((0, N_KP_SLOTS, 4), dtype=np.float64)
    return batch, paths
