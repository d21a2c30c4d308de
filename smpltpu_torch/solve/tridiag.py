"""Block-tridiagonal SPD solve by block Cholesky elimination (port of
``smpltpu/solve/tridiag.py::block_tridiag_solve``).

The pose-pose block of the multi-frame normal equations is
block-tridiagonal: the temporal term couples only consecutive frames. Its
off-diagonal blocks are scaled diagonals E_f = c_f * diag(m) (m masks the
scale dim out, c_f carries -lambda^2 times the pair's validity), so the
forward elimination and the back substitution are one loop over frames of
(P, P) Cholesky factorizations and triangular solves, batched over any
leading axes (the windows of a stage-2 batch).

As in the reference, the factors are upper (S = U^T U) and S_prev^{-1} is
formed by solving against the identity, so float64 agrees with it to
rounding. Two differences of the platform are handled here:

  * ``torch.linalg.cholesky`` reads its ``info`` on the host (a device
    sync per factorization on CUDA); ``cholesky_ex(check_errors=False)``
    does not, so the solve never waits for the device;
  * for a block that is not positive definite ``cholesky_ex`` returns a
    finite partial factor, where the reference's ``cho_factor`` returns
    NaN. Such a factor is set to NaN here, so the solution is NaN and the
    LM step that needed it is rejected, as in the reference.

The reference's cyclic-reduction variant (``block_tridiag_solve_cr``) is
not ported (ROADMAP.md, "Do not port").
"""

from __future__ import annotations

import torch


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor U (a = U^T U) of each (P, P) block; NaN where
    the block is not positive definite."""
    u, info = torch.linalg.cholesky_ex(a, upper=True, check_errors=False)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(u, float("nan")), u)


def _solve(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(U^T U)^{-1} b by two triangular solves."""
    y = torch.linalg.solve_triangular(u.transpose(-1, -2), b, upper=False)
    return torch.linalg.solve_triangular(u, y, upper=True)


def block_tridiag_solve(diag_blocks: torch.Tensor, off_scale: torch.Tensor,
                        off_mask: torch.Tensor,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs for the block-tridiagonal SPD T with diagonal blocks
    ``diag_blocks`` (..., F, P, P) and off-diagonal blocks
    E_f = off_scale[..., f] * diag(off_mask): off_scale (..., F-1),
    off_mask (P,), rhs (..., F, P, R). Returns (..., F, P, R)."""
    p = diag_blocks.shape[-1]
    n_f = diag_blocks.shape[-3]
    mm = off_mask[:, None] * off_mask[None, :]                   # (P, P)
    m_col = off_mask[:, None]                                    # (P, 1)
    eye = torch.eye(p, dtype=diag_blocks.dtype, device=diag_blocks.device)

    # forward: S_f = D_f - c^2 diag(m) S_{f-1}^{-1} diag(m),
    #          z_f = r_f - c diag(m) S_{f-1}^{-1} z_{f-1}
    facs = [_chol(diag_blocks[..., 0, :, :])]
    zs = [rhs[..., 0, :, :]]
    for f in range(1, n_f):
        c = off_scale[..., f - 1, None, None]
        s_inv = _solve(facs[-1], eye)
        s_f = diag_blocks[..., f, :, :] - (c * c) * (s_inv * mm)
        zs.append(rhs[..., f, :, :] - c * m_col * _solve(facs[-1], zs[-1]))
        facs.append(_chol(s_f))

    # back: x_{F-1} = S^{-1} z_{F-1}; x_f = S_f^{-1} (z_f - E_f x_{f+1})
    xs = [_solve(facs[-1], zs[-1])]
    for f in range(n_f - 2, -1, -1):
        c = off_scale[..., f, None, None]
        xs.append(_solve(facs[f], zs[f] - c * m_col * xs[-1]))
    return torch.stack(xs[::-1], dim=-3)
