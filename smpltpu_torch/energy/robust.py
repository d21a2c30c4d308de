"""Robust loss helper (port of ``smpltpu/energy/robust.py``).

The solvers linearize the Huber-corrected residual c = sqrt(rho(s)/s) r
(``solve/lm.py::huber_correct_weight``); this module keeps the IRLS weight
sqrt(rho'(s)) of the reference formulation, as the reference does.

Huber: rho(s) = s                        for s <= delta^2
       rho(s) = 2*delta*sqrt(s) - delta^2  otherwise
=> rho'(s) = min(1, delta / sqrt(s)).
"""

from __future__ import annotations

import torch


def huber_block_weights(res_blocks: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt(rho'(s)) per residual block: res_blocks (..., B, R) -> (..., B)."""
    s = torch.sum(res_blocks * res_blocks, dim=-1)
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-24))
    return torch.sqrt(torch.clamp(delta / sqrt_s, max=1.0))
