"""Camera intrinsics heuristic (port of ``smpltpu/utils/camera.py``):
f = 0.9 * max(W, H), fx = fy = f, principal point at the image center."""

from __future__ import annotations

import torch

from smpltpu_torch.constants import FOCAL_FACTOR
from smpltpu_torch.energy.reproj import Camera


def default_intrinsics(width: int, height: int, *, device, dtype) -> Camera:
    f = FOCAL_FACTOR * max(width, height)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return Camera(fx=t(f), fy=t(f), cx=t(0.5 * width), cy=t(0.5 * height))
