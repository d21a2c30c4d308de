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

The kernel spreads each window over a thread-block cluster. How (cluster
size, frames per CTA, how many of them sit in shared memory, the shared
bytes and the scratch) is decided here, by the plain function
``k1_plan``, from device limits read once; the C code only launches it.

``arrow_pcg_torch`` is the plain version: the XLA loop of
``smpltpu/solve/multi_frame.py`` (arrow_pcg, :366-438) batched over a
leading window axis W, in any dtype. The wrapper takes it only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
                    iters: int, rtol: float = 0.0, prec=None):
    """Plain batched PCG. d_blocks (W, F, P, P), off_scale (W, F-1),
    tmask (P,), b_pw (W, F, P, nS), c_reg (W, nS, nS), g_p (W, F, P),
    g_w (W, nS) -> (dp (W, F, P), dw (W, nS)).

    The preconditioner is Jacobi (the diagonals of D and C), or with
    ``prec = (pinv_pp (W, F, P, P), pinv_w (W, nS, nS))`` those blocks
    applied as matrices (``linear="pcg_block"`` of the multi-frame fit).
    ``rtol > 0`` stops a window once ||r||^2 <= rtol^2 ||r0||^2 (cap
    ``iters``); the others go on, as under ``jax.vmap`` of the reference
    loop, where a finished window keeps its iterate."""
    def matvec(v_p, v_w):
        return arrow_matvec(d_blocks, off_scale, tmask, b_pw, c_reg, v_p, v_w)

    if prec is None:
        dinv = 1.0 / torch.clamp(torch.diagonal(d_blocks, dim1=-2, dim2=-1),
                                 min=1e-20)
        cinv = 1.0 / torch.clamp(torch.diagonal(c_reg, dim1=-2, dim2=-1),
                                 min=1e-20)

        def precond(r_p, r_w):
            return dinv * r_p, cinv * r_w
    else:
        pinv_pp, pinv_w = prec

        def precond(r_p, r_w):
            return ((pinv_pp @ r_p[..., None])[..., 0],
                    (pinv_w @ r_w[..., None])[..., 0])
    x_p, x_w = torch.zeros_like(g_p), torch.zeros_like(g_w)
    r_p, r_w = -g_p, -g_w
    d_p, d_w = precond(r_p, r_w)
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
        z_p, z_w = precond(new_r_p, new_r_w)
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


# the kernel's shared-memory layout (csrc/arrow_pcg.cu): a header of
# kHeader floats, kVecs vectors of vec_len floats, then the resident frames'
# D (P x P) and B (P x nS) blocks
K1_HEADER_FLOATS = 1280
K1_VECS = 6
K1_MAX_SHAPES = 16
K1_MAX_CLUSTER = 16
K1_MAX_P = 128           # the halo buffers' size
K1_THREADS = 544         # threads per CTA, one row of D each


class K1Plan(NamedTuple):
    """One launch of K1: ``cluster`` CTAs per window, rank r owning the
    frames of ``k1_frame_ranges(F, cluster)[r]`` (at most
    ``frames_per_cta``), the first ``resident_frames`` of them with D and B
    in shared memory; each vector of a CTA ``vec_len`` floats, in shared
    memory or, if not ``vec_in_smem``, in ``scratch_floats`` of global
    scratch; ``smem_bytes`` of dynamic shared memory per CTA."""
    cluster: int
    frames_per_cta: int
    resident_frames: int
    vec_len: int
    vec_in_smem: bool
    smem_bytes: int
    scratch_floats: int


def k1_frame_ranges(n_frames: int, cluster: int) -> list:
    """[f0, f1) of each rank: the kernel's split r*F//c .. (r+1)*F//c."""
    return [(r * n_frames // cluster, (r + 1) * n_frames // cluster)
            for r in range(cluster)]


def _k1_layout(n_win, n_frames, p, n_s, smem_per_block, cluster) -> K1Plan:
    """The plan for a given cluster size: as many of a CTA's frames
    resident as fit beside the header and the vectors."""
    fpc = -(-n_frames // cluster)
    vec_len = -(-fpc * p // 4) * 4
    vec_bytes = 4 * K1_VECS * vec_len
    avail = smem_per_block - 4 * K1_HEADER_FLOATS
    if avail < 0:
        raise ValueError(f"k1_plan: {smem_per_block} B of shared memory per "
                         f"block is less than the kernel's header")
    vec_in_smem = vec_bytes <= avail
    if vec_in_smem:
        avail -= vec_bytes
    frame_bytes = 4 * p * (p + n_s)
    n_res = min(fpc, avail // frame_bytes)
    smem = (4 * K1_HEADER_FLOATS + (vec_bytes if vec_in_smem else 0)
            + n_res * frame_bytes)
    scratch = 0 if vec_in_smem else n_win * cluster * K1_VECS * vec_len
    return K1Plan(cluster, fpc, n_res, vec_len, vec_in_smem, smem, scratch)


@functools.lru_cache(maxsize=None)
def k1_plan(n_win: int, n_frames: int, p: int, n_s: int, smem_per_block: int,
            max_cluster: int, cluster: int | None = None) -> K1Plan:
    """K1's launch plan for W = ``n_win`` windows of F = ``n_frames``
    frames, on a device with ``smem_per_block`` bytes of opt-in shared
    memory per block and clusters of up to ``max_cluster`` CTAs; cached
    per argument tuple, so a launch pays for it once per shape.
    ``cluster`` forces the cluster size (to measure layouts); otherwise it
    is the smallest whose CTAs hold all their frames in shared memory and
    their rows in one pass of the block's K1_THREADS threads, else the
    largest the device allows (PERF.md, K1 layouts: every frame resident
    in one pass beats one wave with frames streamed from L2, and a larger
    cluster only adds CTAs to the exchanges)."""
    if not 1 <= n_s <= K1_MAX_SHAPES:
        raise ValueError(f"k1_plan: nS must be 1..{K1_MAX_SHAPES}, got {n_s}")
    if n_win < 1 or n_frames < 1 or not 1 <= p <= K1_MAX_P:
        raise ValueError(f"k1_plan: W={n_win} F={n_frames} P={p}: need W, F "
                         f">= 1 and 1 <= P <= {K1_MAX_P}")
    top = min(max_cluster, n_frames, K1_MAX_CLUSTER)
    if top < 1:
        raise ValueError(f"k1_plan: no cluster size fits (max {max_cluster})")
    if cluster is not None:
        if not 1 <= cluster <= top:
            raise ValueError(f"k1_plan: cluster {cluster} not in 1..{top}")
        return _k1_layout(n_win, n_frames, p, n_s, smem_per_block, cluster)
    for c in range(1, top):
        plan = _k1_layout(n_win, n_frames, p, n_s, smem_per_block, c)
        if (plan.resident_frames == plan.frames_per_cta
                and plan.frames_per_cta * p <= K1_THREADS):
            return plan
    return _k1_layout(n_win, n_frames, p, n_s, smem_per_block, top)


_LIMITS: dict = {}


def device_limits(device: torch.device) -> dict:
    """The device's opt-in shared memory per block and largest schedulable
    cluster at that shared memory, read once per device (the call also
    sets the kernel's attributes)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _LIMITS:
        lib = _build.load()
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(idx):
            err = lib.smpltpu_arrow_pcg_limits(out)
        if err != 0:
            raise RuntimeError(f"arrow_pcg: reading the device limits failed "
                               f"with CUDA error {err}")
        _LIMITS[idx] = {"smem_per_block": out[0], "max_cluster": out[1]}
    return _LIMITS[idx]


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
    plan = k1_plan(w, f, p, g_w.shape[-1], **device_limits(dev))
    return arrow_pcg_planned(plan, d_blocks, off_scale, tmask, b_pw, c_reg,
                             g_p, g_w, iters, rtol)


def arrow_pcg_planned(plan: K1Plan, d_blocks, off_scale, tmask, b_pw, c_reg,
                      g_p, g_w, iters: int, rtol: float = 0.0):
    """Launch K1 with a given plan (CUDA tensors only). Besides
    ``LAUNCHES["arrow_pcg"]`` it counts the launch under
    ``"arrow_pcg@{W}x{F}"``, so a run can tell the fit's two stages apart."""
    dev = g_p.device
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
    scratch = (torch.empty(plan.scratch_floats, dtype=f32, device=dev)
               if plan.scratch_floats else None)
    aligned = d_blocks.data_ptr() % 16 == 0
    err = lib.smpltpu_arrow_pcg_f32(
        d_blocks.data_ptr(), off_scale.data_ptr(), tmask.data_ptr(),
        b_pw.data_ptr(), c_reg.data_ptr(), g_p.data_ptr(), g_w.data_ptr(),
        dp.data_ptr(), dw.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        w, f, p, n_s, int(iters), float(rtol) * float(rtol),
        plan.cluster, plan.resident_frames, plan.vec_len,
        int(plan.vec_in_smem), int(aligned), plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"arrow_pcg: kernel launch failed with CUDA error "
                           f"{err} for W={w} F={f} P={p} nS={n_s}, {plan}")
    LAUNCHES["arrow_pcg"] += 1
    LAUNCHES[f"arrow_pcg@{w}x{f}"] += 1
    return dp, dw
