"""First-order temporal smoothness (port of ``smpltpu/energy/temporal.py``):
every packed frame dim is coupled to its neighbour frame except scale."""

from __future__ import annotations

import torch

from smpltpu_torch.energy.params import frame_param_layout


def temporal_mask(n_joints: int, *, device, dtype,
                  n_hand_comps: int = 0) -> torch.Tensor:
    """(P,) mask of dims coupled by temporal smoothness: everything except
    scale (index 0), a whole-body layout's hand coefficients included."""
    m = torch.ones(frame_param_layout(n_joints, n_hand_comps)["total"],
                   dtype=dtype, device=device)
    m[0] = 0.0
    return m


def temporal_residuals(params: torch.Tensor, lam, n_joints: int) -> torch.Tensor:
    """params (F, P) -> ((F-1) * P,) masked differences lam*(p_f - p_{f+1})."""
    mask = temporal_mask(n_joints, device=params.device, dtype=params.dtype)
    return (lam * ((params[:-1] - params[1:]) * mask)).reshape(-1)
