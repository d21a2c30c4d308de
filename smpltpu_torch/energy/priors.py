"""L2 pose and shape priors (port of the L2 parts of
``smpltpu/energy/priors.py``; the multi-frame fit always uses the L2 pose
prior). The GMM pose prior belongs to the single-frame path, not yet
ported (ROADMAP.md)."""

from __future__ import annotations

import torch


def l2_pose_prior_residual(joint_aa_flat: torch.Tensor,
                           beta) -> torch.Tensor:
    """r = beta * x over the stacked non-root angle-axes."""
    return beta * joint_aa_flat


def shape_prior_residual(shape: torch.Tensor, beta) -> torch.Tensor:
    """L2 shape prior r = betaShape * w."""
    return beta * shape
