"""K1: the arrowhead Jacobi-PCG solve of the multi-frame LM step.

Every LM iteration of both fit stages solves, per window, the SPD system

    [ T  B ] [dp]   [-g_p]        T = block-tridiag(D_f, E_f)  (F, P, P)
    [ Bᵀ C ] [dw] = [-g_w]        B = per-frame shape coupling (F, P, nS)

by ``iters`` steps of Jacobi-preconditioned CG from 0 (truncated-CG,
Steihaug semantics; no warm start). ``arrow_pcg`` runs them all in one
launch of the CUDA kernel ``csrc/arrow_pcg.cu`` for a CUDA tensor, which
replaces the TPU kernel ``smpltpu/ops/cg.py::arrow_pcg_pallas``; in eager
PyTorch the plain loop below costs about 25 launches per CG step. The
source note in the ``.cu`` file says what bounds the kernel on the card.

``arrow_pcg_torch`` is the plain version: the XLA loop of
``smpltpu/solve/multi_frame.py`` (arrow_pcg, :366-438) batched over a
leading window axis W, in any dtype. The wrapper takes it only for CPU
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

from smpltpu_torch import _build
from smpltpu_torch.ops import LAUNCHES


def window_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-window inner product: sum over every axis but the first."""
    return torch.sum(a * b, dim=tuple(range(1, a.dim())))


def arrow_matvec(d_blocks, off_scale, tmask, b_pw, c_reg, v_p, v_w):
    """Apply the arrowhead matrix [T B; Bᵀ C] to (v_p (W, F, P), v_w (W, nS))."""
    u = torch.einsum("wfab,wfb->wfa", d_blocks, v_p)
    e = off_scale[..., None] * tmask
    u = u + tnf.pad(e * v_p[:, 1:], (0, 0, 0, 1))
    u = u + tnf.pad(e * v_p[:, :-1], (0, 0, 1, 0))
    u = u + torch.einsum("wfps,ws->wfp", b_pw, v_w)
    u_w = (torch.einsum("wfps,wfp->ws", b_pw, v_p)
           + torch.einsum("wst,wt->ws", c_reg, v_w))
    return u, u_w


def arrow_pcg_torch(d_blocks, off_scale, tmask, b_pw, c_reg, g_p, g_w,
                    iters: int, rtol: float = 0.0):
    """Plain batched Jacobi-PCG. d_blocks (W, F, P, P), off_scale (W, F-1),
    tmask (P,), b_pw (W, F, P, nS), c_reg (W, nS, nS), g_p (W, F, P),
    g_w (W, nS) -> (dp (W, F, P), dw (W, nS)).

    ``rtol > 0`` stops a window once ||r||^2 <= rtol^2 ||r0||^2 (cap
    ``iters``); the others go on, as under ``jax.vmap`` of the reference
    loop, where a finished window keeps its iterate."""
    def matvec(v_p, v_w):
        return arrow_matvec(d_blocks, off_scale, tmask, b_pw, c_reg, v_p, v_w)

    dinv = 1.0 / torch.clamp(torch.diagonal(d_blocks, dim1=-2, dim2=-1),
                             min=1e-20)
    cinv = 1.0 / torch.clamp(torch.diagonal(c_reg, dim1=-2, dim2=-1),
                             min=1e-20)
    x_p, x_w = torch.zeros_like(g_p), torch.zeros_like(g_w)
    r_p, r_w = -g_p, -g_w
    d_p, d_w = dinv * r_p, cinv * r_w
    rho = window_dot(r_p, d_p) + window_dot(r_w, d_w)
    if rtol > 0.0:
        rr = window_dot(r_p, r_p) + window_dot(r_w, r_w)
        tol2 = (rtol * rtol) * rr
    for _ in range(iters):
        q_p, q_w = matvec(d_p, d_w)
        alpha = rho / torch.clamp(window_dot(d_p, q_p) + window_dot(d_w, q_w),
                                  min=1e-30)
        a_p, a_w = alpha[:, None, None], alpha[:, None]
        new_x_p, new_x_w = x_p + a_p * d_p, x_w + a_w * d_w
        new_r_p, new_r_w = r_p - a_p * q_p, r_w - a_w * q_w
        z_p, z_w = dinv * new_r_p, cinv * new_r_w
        rho_n = window_dot(new_r_p, z_p) + window_dot(new_r_w, z_w)
        beta = rho_n / torch.clamp(rho, min=1e-30)
        new_d_p = z_p + beta[:, None, None] * d_p
        new_d_w = z_w + beta[:, None] * d_w
        if rtol > 0.0:
            live = rr > tol2
            lp, lw = live[:, None, None], live[:, None]
            x_p, x_w = torch.where(lp, new_x_p, x_p), torch.where(lw, new_x_w, x_w)
            r_p, r_w = torch.where(lp, new_r_p, r_p), torch.where(lw, new_r_w, r_w)
            d_p, d_w = torch.where(lp, new_d_p, d_p), torch.where(lw, new_d_w, d_w)
            rho = torch.where(live, rho_n, rho)
            rr = window_dot(r_p, r_p) + window_dot(r_w, r_w)
        else:
            x_p, x_w, r_p, r_w = new_x_p, new_x_w, new_r_p, new_r_w
            d_p, d_w, rho = new_d_p, new_d_w, rho_n
    return x_p, x_w


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"arrow_pcg: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"arrow_pcg: {name} must be contiguous")


def arrow_pcg(d_blocks, off_scale, tmask, b_pw, c_reg, g_p, g_w,
              iters: int, rtol: float = 0.0):
    """K1 on a CUDA tensor (float32, contiguous; shapes as in
    :func:`arrow_pcg_torch`), the plain version on a CPU tensor. Counts its
    kernel launches in ``LAUNCHES["arrow_pcg"]``."""
    dev = g_p.device
    if dev.type == "cpu":
        return arrow_pcg_torch(d_blocks, off_scale, tmask, b_pw, c_reg,
                               g_p, g_w, iters, rtol)
    if dev.type != "cuda":
        raise ValueError(f"arrow_pcg: no kernel for device {dev}")
    w, f, p = g_p.shape
    n_s = g_w.shape[-1]
    f32 = torch.float32
    for name, t, shape in (("d_blocks", d_blocks, (w, f, p, p)),
                           ("off_scale", off_scale, (w, f - 1)),
                           ("tmask", tmask, (p,)),
                           ("b_pw", b_pw, (w, f, p, n_s)),
                           ("c_reg", c_reg, (w, n_s, n_s)),
                           ("g_p", g_p, (w, f, p)),
                           ("g_w", g_w, (w, n_s))):
        _check(name, t, shape, f32, dev)
    lib = _build.load()
    dp = torch.empty_like(g_p)
    dw = torch.empty_like(g_w)
    n_scratch = lib.smpltpu_arrow_pcg_scratch_floats(w, f, p)
    scratch = torch.empty(max(n_scratch, 1), dtype=f32, device=dev)
    err = lib.smpltpu_arrow_pcg_f32(
        d_blocks.data_ptr(), off_scale.data_ptr(), tmask.data_ptr(),
        b_pw.data_ptr(), c_reg.data_ptr(), g_p.data_ptr(), g_w.data_ptr(),
        dp.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
        w, f, p, n_s, int(iters), float(rtol) * float(rtol),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"arrow_pcg: kernel launch failed with CUDA error {err}")
    LAUNCHES["arrow_pcg"] += 1
    return dp, dw

