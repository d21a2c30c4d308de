"""Pose and shape priors (port of ``smpltpu/energy/priors.py``).

The GMM pose prior follows the reference's contract (its module docstring
derives it): with x the stacked non-root angle-axes,

  component:  k* = argmin_k [ 0.5*||L_k^T (x - mu_k)||^2 + c_k ],
              c_k = -log(weight_k) + 0.5*logdet(cov_k), min-shifted
  residual:   r = beta * [ L_{k*}^T (x - mu_{k*}) ;  sqrt(2 c_{k*}) ]

The assignment is hard and is picked again at every evaluation; on a tie
``torch.argmin`` takes the first index, as ``jnp.argmin`` does. Holding
k* fixed, the Jacobian is ``beta * L_{k*}^T`` over a zero last row: the
reference gets it from ``jax.jacfwd`` through the piecewise-constant
argmin, here it is written out (:func:`gmm_pose_prior_residual_and_jacobian`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GMMPrior(NamedTuple):
    means: torch.Tensor      # (K, D)
    prec_cho: torch.Tensor   # (K, D, D), lower L with Precision = L @ L.T
    const: torch.Tensor      # (K,) c_k, min-shifted
    beta: torch.Tensor       # () weight (betaPose)

    @classmethod
    def from_dict(cls, d: dict, beta: float, *, device, dtype) -> "GMMPrior":
        """From the dict of ``io/gmm.py::load_pose_prior_txt``."""
        c = (-np.log(np.asarray(d["weights"], np.float64))
             + 0.5 * np.asarray(d["logdet_cov"], np.float64))
        c = c - np.min(c)

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)
        return cls(means=t(d["means"]), prec_cho=t(d["prec_cho"]),
                   const=t(c), beta=t(beta))

    @classmethod
    def from_jax(cls, prior, *, device, dtype) -> "GMMPrior":
        """Carry a reference ``smpltpu.energy.GMMPrior`` over, field by field
        through ``np.asarray`` (its constant is already min-shifted)."""
        return cls(*(torch.as_tensor(np.array(a), device=device).to(dtype)
                     for a in prior))


def _assignment(x: torch.Tensor, prior: GMMPrior):
    """Whitened residuals of every component (..., K, D) and the hard
    assignment k* (...)."""
    diff = x[..., None, :] - prior.means                          # (..., K, D)
    white = torch.einsum("kdr,...kd->...kr", prior.prec_cho, diff)
    nll = 0.5 * torch.sum(white * white, dim=-1) + prior.const
    return white, torch.argmin(nll, dim=-1)


def gmm_pose_prior_residual(joint_aa_flat: torch.Tensor,
                            prior: GMMPrior) -> torch.Tensor:
    """(..., D+1) whitened GMM residual over the stacked non-root
    angle-axes (..., D), D = 69 for SMPL."""
    return gmm_pose_prior_residual_and_jacobian(joint_aa_flat, prior,
                                                want_jacobian=False)[0]


def gmm_pose_prior_residual_and_jacobian(joint_aa_flat: torch.Tensor,
                                         prior: GMMPrior,
                                         want_jacobian: bool = True):
    """(residual (..., D+1), Jacobian (..., D+1, D) or None): the rows of
    :func:`gmm_pose_prior_residual` and their derivative at fixed k*,
    ``beta * L_{k*}^T`` with a zero last row."""
    white, k = _assignment(joint_aa_flat, prior)
    w_k = torch.take_along_dim(white, k[..., None, None], dim=-2)[..., 0, :]
    const_row = torch.sqrt(2.0 * prior.const[k] + 1e-20)
    res = prior.beta * torch.cat([w_k, const_row[..., None]], dim=-1)
    if not want_jacobian:
        return res, None
    jac = prior.beta * prior.prec_cho[k].transpose(-1, -2)        # (..., D, D)
    return res, torch.cat([jac, torch.zeros_like(jac[..., :1, :])], dim=-2)


def l2_pose_prior_residual(joint_aa_flat: torch.Tensor,
                           beta) -> torch.Tensor:
    """r = beta * x over the stacked non-root angle-axes."""
    return beta * joint_aa_flat


def shape_prior_residual(shape: torch.Tensor, beta) -> torch.Tensor:
    """L2 shape prior r = betaShape * w."""
    return beta * shape
