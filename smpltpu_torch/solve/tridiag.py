"""Block-tridiagonal SPD solves (port of ``smpltpu/solve/tridiag.py``):
block Cholesky elimination (``block_tridiag_solve``, the Thomas order) and
block cyclic reduction (``block_tridiag_solve_cr``).

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

``block_tridiag_solve_cr`` solves the same system in ceil(log2 F) levels
of batched factorizations instead of ~2F sequential ones; see its
docstring.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf


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


def _shift_in(x: torch.Tensor, front: bool, n: int) -> torch.Tensor:
    """The first ``n`` blocks along the frame axis (-3) of ``x`` with one
    zero block put in front (``front``) or at the end: the reference's
    clipped neighbour gathers, whose out-of-range picks meet a zero
    coupler, as exact zeros."""
    pad = (0, 0, 0, 0, 1, 0) if front else (0, 0, 0, 0, 0, 1)
    return tnf.pad(x, pad)[..., :n, :, :]


def block_tridiag_solve_cr(diag_blocks: torch.Tensor, off_scale: torch.Tensor,
                           off_mask: torch.Tensor,
                           rhs: torch.Tensor) -> torch.Tensor:
    """The system of :func:`block_tridiag_solve` (same arguments, same
    result), solved by block cyclic reduction (port of the reference's
    ``block_tridiag_solve_cr``).

    Row i reads E_{i-1}^T x_{i-1} + D_i x_i + E_i x_{i+1} = b_i, with
    E_i = c_i diag(m) at the start (densified to (P, P)). Each level
    factors every odd block with one batched Cholesky, solves it against
    the stacked [E_{i-1}^T | E_i | b_i], folds the odds into the evens
    (new couplers -E_j D_{j+1}^{-1} E_{j+1}), recurses on the evens and
    back-substitutes the odds: ceil(log2 F) levels of a fixed number of
    batched launches each, where the elimination runs ~2F small
    factorizations one after another.

    Odds and evens are strided views, the neighbours that fall off either
    end are zero blocks (the reference clips its gathers and relies on the
    coupler there being zero), and the two halves are interleaved by a
    stack and a reshape: no index tensor, no scatter. The recursion depth
    is fixed by F on the host, so every shape is static, and nothing reads
    the device."""
    p = diag_blocks.shape[-1]
    e0 = off_scale[..., None, None] * torch.diag(off_mask)        # (..., F-1, P, P)
    return _cr_level(diag_blocks, e0, rhs, p)


def _cr_level(d: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
              p: int) -> torch.Tensor:
    n = d.shape[-3]
    if n == 1:
        return _solve(_chol(d), b)
    n_o, n_e = n // 2, (n + 1) // 2
    e_l = _shift_in(e, True, n)                 # e_l[i] = E_{i-1}, E_{-1} = 0
    e_r = _shift_in(e, False, n)                # e_r[i] = E_i, E_{n-1} = 0
    stack = torch.cat([e_l[..., 1::2, :, :].transpose(-1, -2),
                       e_r[..., 1::2, :, :], b[..., 1::2, :, :]], dim=-1)
    sol = _solve(_chol(d[..., 1::2, :, :]), stack)  # (..., n_o, P, 2P+R)
    gl, gr, gb = sol[..., :p], sol[..., p:2 * p], sol[..., 2 * p:]

    # even j = 2k: its odd neighbours are k-1 (below) and k (above)
    el_t = e_l[..., 0::2, :, :].transpose(-1, -2)   # E_{j-1}^T
    er = e_r[..., 0::2, :, :]                       # E_j
    gr_below, gb_below = (_shift_in(x, True, n_e) for x in (gr, gb))
    gl_above, gb_above = (_shift_in(x, False, n_e) for x in (gl, gb))
    d_new = d[..., 0::2, :, :] - el_t @ gr_below - er @ gl_above
    b_new = b[..., 0::2, :, :] - el_t @ gb_below - er @ gb_above
    # coupler between evens j and j+2: -E_j D_{j+1}^{-1} E_{j+1}
    e_new = -(er[..., :n_e - 1, :, :] @ gr[..., :n_e - 1, :, :])
    x_even = _cr_level(d_new, e_new, b_new, p)

    # odd i = 2k+1: x_i = GB_i - GL_i x_{i-1} - GR_i x_{i+1}
    x_odd = (gb - gl @ x_even[..., :n_o, :, :]
             - gr @ _shift_in(x_even[..., 1:, :, :], False, n_o))
    if n_o < n_e:
        x_odd = _shift_in(x_odd, False, n_e)
    x = torch.stack([x_even, x_odd], dim=-3)    # (..., n_e, 2, P, R)
    return x.flatten(-4, -3)[..., :n, :, :]
