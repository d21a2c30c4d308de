"""Huber loss pieces of the LM engine (port of ``smpltpu/solve/lm.py``
:127-142), plus the closed-form derivative of the correction weight that
the reference takes with ``jax.jvp``."""

from __future__ import annotations

import torch


def _huber_rho(s: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber rho(s) on squared block norms s."""
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-24))
    return torch.where(s <= delta * delta, s, 2.0 * delta * sqrt_s - delta * delta)


def huber_correct_weight(s: torch.Tensor, delta: float) -> torch.Tensor:
    """Row weight w(s) = sqrt(rho(s)/s), so that ||w r||^2 == rho(||r||^2)
    exactly; applied inside the linearization so the Jacobian carries the
    loss curvature."""
    d2 = delta * delta
    s_safe = torch.clamp(s, min=1e-24)
    sqrt_s = torch.sqrt(s_safe)
    w_out = torch.sqrt(torch.clamp(2.0 * delta * sqrt_s - d2, min=1e-24) / s_safe)
    return torch.where(s <= d2, torch.ones_like(s), w_out)


def huber_correct_weight_and_slope(s: torch.Tensor, delta: float):
    """(w(s), dw/ds) in closed form.

    The slope is the derivative through the same guards as
    :func:`huber_correct_weight` (a clamp passes the tangent only where it
    is inactive), written in the quotient form
    ``(u'/v - (u/v)(v'/v)) / (2 sqrt(u/v))`` with ``v = s_safe``: no ``v^2``
    appears, so it stays finite in float32 on masked rows (s = 0), where a
    reverse-mode gradient divides by ``s_safe^2 = 1e-48`` and gives NaN.
    dw/ds = 0 for s <= delta^2 (the constant branch)."""
    d2 = delta * delta
    s_safe = torch.clamp(s, min=1e-24)
    sqrt_s = torch.sqrt(s_safe)
    a = 2.0 * delta * sqrt_s - d2
    u = torch.clamp(a, min=1e-24)
    ratio = u / s_safe
    w_out = torch.sqrt(ratio)
    ds_safe = (s > 1e-24).to(s.dtype)
    du = (a > 1e-24).to(s.dtype) * delta * ds_safe / sqrt_s
    dratio = du / s_safe - ratio * (ds_safe / s_safe)
    slope = dratio / (2.0 * w_out)
    const = s <= d2
    return (torch.where(const, torch.ones_like(s), w_out),
            torch.where(const, torch.zeros_like(s), slope))
