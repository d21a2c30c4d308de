"""Sharded solvers over the frames mesh (port of
``smpltpu/parallel/sharded.py``).

Three paths, as in the reference:

1. ``sharded_window_fit``: window data parallelism. Each rank solves its
   block of the window batch with the batched multi-frame fitter (K1 under
   ``linear="pcg_kernel"`` on the card); windows are independent once the
   shape is locked, so nothing is exchanged until the gather.
   ``sharded_frame_fit`` does the same for the single-frame batch.
2. ``build_sharded_gn_step``: one damped Gauss-Newton step of the
   shared-shape multi-frame problem with the frames sharded.
3. ``build_sharded_lm_fitter``: the whole trust-region LM with the frames
   sharded.

In 2 and 3 each rank assembles its frames' normal equations alone; the
shape Schur pieces, the cost and every dot product are summed over the
ranks with ``all_reduce`` (the reference's ``psum``), and the temporal
stencil's rows across a shard boundary come from the neighbour ranks
(``exchange``, the reference's ``ppermute``) inside a block-Jacobi PCG
on the full SPD system [T B; B^T C]. The ring is cyclic: the last global
frame's pair weight is 0, which cancels the wrap-around term, so one rank
(whose halo is its own edge row) and many ranks solve the same system.

Control state (radius, cost, rho, the convergence flag) is computed only
from all-reduced values, so every rank holds the same bits and takes the
same branch without a broadcast. The loops read nothing back to the host:
the LM runs ``max_iters`` trips with converged state frozen (the
reference's ``lax.scan``) and the CG's tolerance exit runs ``cg_iters``
trips frozen once the all-reduced residual is below it (its
``while_loop``, whose exit every shard takes on the same trip).

Every function takes the global arrays on every rank (the reference's
callers place them with ``shard_frames``) and returns the global result
on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smpltpu_torch.energy.reproj import (
    Camera,
    SkeletonSpec,
    keypoint_residuals,
    require_smpl_spec,
    spec_layout,
)
from smpltpu_torch.energy.temporal import temporal_mask
from smpltpu_torch.parallel.mesh import FramesMesh
from smpltpu_torch.solve.lm import LMResult, _huber_rho
from smpltpu_torch.solve.multi_frame import (
    MultiFrameConfig,
    MultiFrameResult,
    build_chunked_window_fit,
    corrected_frame_assembly,
    project_scale,
    start_state,
    trust_region_trip,
)
from smpltpu_torch.solve.single_frame import fit_in_chunks


def _gathered(mesh: FramesMesh, cls, result):
    return cls(*(mesh.all_gather(t) for t in result))


# ---------------------------------------------------------------------
# path 1: data parallelism over windows and over frames
# ---------------------------------------------------------------------
def sharded_window_fit(mesh: FramesMesh, fitter, params0, shape0, kp, r0,
                       frame_valid, chunk: int = 0) -> MultiFrameResult:
    """Each rank fits its block of the windows with ``fitter`` (a
    ``build_multi_fitter`` result); inputs have a leading window axis
    divisible by the mesh size. ``chunk > 0`` fits the block in chunks of
    that many windows, each with its own convergence exit
    (``build_chunked_window_fit``); per-window results are those of the
    whole batch."""
    args = [mesh.shard(torch.as_tensor(a))
            for a in (params0, shape0, kp, r0, frame_valid)]
    fit = fitter if chunk <= 0 else build_chunked_window_fit(fitter, chunk)
    return _gathered(mesh, MultiFrameResult, fit(*args))


def sharded_frame_fit(mesh: FramesMesh, fitter, x0, kp,
                      chunk: int = 0) -> LMResult:
    """Each rank fits its block of the single-frame batch with ``fitter``
    (an unchunked ``build_fitter`` result); per-frame problems are
    independent, so nothing is exchanged until the gather. The leading
    axis must be divisible by the mesh size. ``chunk > 0`` fits the block
    in chunks, padded by repeating its last frame."""
    lx, lk = mesh.shard(torch.as_tensor(x0)), mesh.shard(torch.as_tensor(kp))
    return _gathered(mesh, LMResult, fit_in_chunks(fitter, chunk, lx, lk))


# ---------------------------------------------------------------------
# paths 2 and 3: frames sharded, shared shape, halo-exchange PCG
# ---------------------------------------------------------------------
class GNStepResult(NamedTuple):
    params: torch.Tensor       # (F, P) updated
    shape: torch.Tensor        # (nS,) updated (replicated)
    cg_residual: torch.Tensor  # () final CG residual norm


class _Sharded:
    """The pieces both sharded solvers share, on one rank: the local
    assembly with its priors and temporal stencil, the halo rows, the
    all-reduced dot product and the system's matvec."""

    def __init__(self, mesh, spec, cam, cfg, n_shapes, dtype):
        require_smpl_spec(spec, "the sharded solvers")
        n_joints = len(spec.parents)
        lay = spec_layout(spec)
        dev = mesh.device
        self.mesh, self.spec, self.cam, self.cfg = mesh, spec, cam, cfg
        self.dtype = dtype
        p_dim = lay["total"]
        self.aa = slice(*lay["joint_aa"])
        self.bp2 = float(cfg.beta_pose) * float(cfg.beta_pose)
        self.bs2 = float(cfg.beta_shape) * float(cfg.beta_shape)
        self.tmask = temporal_mask(n_joints, device=dev, dtype=dtype)
        psel = torch.zeros(p_dim, dtype=dtype, device=dev)
        psel[self.aa] = 1.0
        self.psel, self.psel_diag = psel, torch.diag(psel)
        self.tmask_diag = torch.diag(self.tmask)
        self.eye_s = torch.eye(n_shapes, dtype=dtype, device=dev)
        keep = torch.ones(p_dim, dtype=dtype, device=dev)  # freeze mask
        keep[0] = 0.0
        self.keep, self.keep2 = keep, keep[:, None] * keep[None, :]
        self.scale_diag = torch.diag(1.0 - keep)

    def to(self, a):
        return torch.as_tensor(a).to(device=self.mesh.device, dtype=self.dtype)

    def local_pair_weights(self, frame_valid):
        """(lam2, lam2_prev) of this rank's frames: lam^2 times the pair
        weight of frame f with global frame f+1 (0 on the last global
        frame), and of frame f-1 with f (cyclically: the first global
        frame's is the last's, 0)."""
        pair = torch.cat([frame_valid[:-1] * frame_valid[1:],
                          frame_valid.new_zeros(1)])
        lam2 = (float(self.cfg.lambda_temporal) * pair) ** 2
        mesh = self.mesh
        return mesh.shard(lam2), mesh.shard(torch.roll(lam2, 1))

    def halo_next(self, x):
        """The next rank's first row (global frame after this block)."""
        return self.mesh.exchange(x[0], -1)

    def halo_prev(self, x):
        """The previous rank's last row (global frame before this block)."""
        return self.mesh.exchange(x[-1], 1)

    def neighbours(self, x):
        return (torch.cat([x[1:], self.halo_next(x)[None]]),
                torch.cat([self.halo_prev(x)[None], x[:-1]]))

    def pdots(self, *pairs):
        """<a, b> over the whole system for each (a_p, a_w, b_p, b_w), the
        pose parts summed over the ranks in one all_reduce."""
        local = torch.stack([torch.sum(a_p * b_p) for a_p, _, b_p, _ in pairs])
        local = self.mesh.all_reduce(local)
        return [local[i] + a_w @ b_w for i, (_, a_w, _, b_w) in enumerate(pairs)]

    def pdot(self, a_p, a_w, b_p, b_w):
        return self.pdots((a_p, a_w, b_p, b_w))[0]

    def matvec(self, blocks_p, blocks_w, b_pw, lam2, lam2_prev, v_p, v_w,
               with_dot=False):
        """(u_p, u_w) = A v; with_dot: also <v, A v>, its pose part summed
        in the same all_reduce as B^T v."""
        u = torch.einsum("fab,fb->fa", blocks_p, v_p)
        v_next, v_prev = self.neighbours(v_p)
        u = u - lam2[:, None] * self.tmask * v_next
        u = u - lam2_prev[:, None] * self.tmask * v_prev
        u = u + torch.einsum("fps,s->fp", b_pw, v_w)
        part = torch.einsum("fps,fp->s", b_pw, v_p)
        if not with_dot:
            return u, self.mesh.all_reduce(part) + blocks_w @ v_w
        red = self.mesh.all_reduce(torch.cat([part, torch.sum(v_p * u)[None]]))
        u_w = red[:-1] + blocks_w @ v_w
        return u, u_w, red[-1] + v_w @ u_w

    def assembly(self, params, w, kp, r0, lam2, lam2_prev):
        """(h_pp, b_pw, c_ww, g_p, g_w): this rank's pose blocks, coupling
        and gradient with the pose prior and the temporal stencil's
        diagonal, and the shape block and gradient summed over the ranks,
        with its prior; the scale gauge fixed under ``freeze_scale``."""
        cfg, f_loc = self.cfg, params.shape[0]
        h_pp, b_pw, h_ww, g_p, g_w_loc = corrected_frame_assembly(
            params, w.expand(f_loc, -1), kp, r0, self.cam, self.spec,
            cfg.huber_delta, cfg.jacobian)
        h_pp = h_pp + self.bp2 * self.psel_diag
        g_p = g_p + self.bp2 * self.psel * params
        h_pp = h_pp + (lam2 + lam2_prev)[:, None, None] * self.tmask_diag
        p_next, p_prev = self.neighbours(params)
        g_p = g_p + lam2[:, None] * self.tmask * (params - p_next)
        g_p = g_p - lam2_prev[:, None] * self.tmask * (p_prev - params)
        c_ww = self.mesh.all_reduce(torch.sum(h_ww, dim=0)) + self.bs2 * self.eye_s
        g_w = self.mesh.all_reduce(torch.sum(g_w_loc, dim=0)) + self.bs2 * w
        if cfg.freeze_scale:
            h_pp = h_pp * self.keep2 + self.scale_diag
            b_pw = b_pw * self.keep[:, None]
            g_p = g_p * self.keep
        return h_pp, b_pw, c_ww, g_p, g_w

    def pcg(self, h_damped, c_damped, b_pw, lam2, lam2_prev, g_p, g_w,
            iters, rtol=0.0):
        """Block-Jacobi PCG on the damped system from 0 -> (x_p, x_w, r_p,
        r_w): ``iters`` trips, or with ``rtol > 0`` frozen from the trip
        where the all-reduced residual falls to rtol^2 ||r_0||^2."""
        # inv_ex: no host read of the LU's info (a device sync)
        pre_p = torch.linalg.inv_ex(h_damped, check_errors=False)[0]
        pre_w = torch.linalg.inv_ex(c_damped, check_errors=False)[0]

        def precond(r_p, r_w):
            return torch.einsum("fab,fb->fa", pre_p, r_p), pre_w @ r_w

        r_p, r_w = -g_p, -g_w
        z_p, z_w = precond(r_p, r_w)
        c = (torch.zeros_like(g_p), torch.zeros_like(g_w), r_p, r_w, z_p,
             z_w, self.pdot(r_p, r_w, z_p, z_w))

        def body(c):
            """One CG step: two halo exchanges and two all_reduces (<d, A
            d> rides with B^T d; ||r||^2, for the tolerance exit, with
            <r, z>); returns the new carry and ||r||^2 (None for rtol 0)."""
            x_p, x_w, r_p, r_w, d_p, d_w, rho = c
            q_p, q_w, dq = self.matvec(h_damped, c_damped, b_pw, lam2,
                                       lam2_prev, d_p, d_w, with_dot=True)
            alpha = rho / torch.clamp(dq, min=1e-30)
            x_p, x_w = x_p + alpha * d_p, x_w + alpha * d_w
            r_p, r_w = r_p - alpha * q_p, r_w - alpha * q_w
            z_p, z_w = precond(r_p, r_w)
            if rtol > 0.0:
                rho_new, rr = self.pdots((r_p, r_w, z_p, z_w),
                                         (r_p, r_w, r_p, r_w))
            else:
                rho_new, rr = self.pdot(r_p, r_w, z_p, z_w), None
            beta = rho_new / torch.clamp(rho, min=1e-30)
            return (x_p, x_w, r_p, r_w, z_p + beta * d_p, z_w + beta * d_w,
                    rho_new), rr

        if rtol > 0.0:
            rr = self.pdot(r_p, r_w, r_p, r_w)
            tol2 = (rtol * rtol) * rr
            for _ in range(iters):
                active = rr > tol2
                new, rr_new = body(c)
                rr = torch.where(active, rr_new, rr)
                c = tuple(torch.where(active, n, o) for n, o in zip(new, c))
        else:
            for _ in range(iters):
                c = body(c)[0]
        return c[:4]


def build_sharded_gn_step(mesh: FramesMesh, spec: SkeletonSpec, cam: Camera,
                          cfg: MultiFrameConfig, n_shapes: int,
                          cg_iters: int = 64, damping: float = 1e-3,
                          dtype=torch.float32):
    """Return step(params (F, P), shape (nS,), kp (F, K, 4), r0 (F, 3, 3))
    -> GNStepResult: ONE damped GN step with the frames sharded, solving
        [T + lam diag, B; B^T, C + lam diag] d = -g
    by ``cg_iters`` trips of block-Jacobi PCG, T's temporal blocks coupled
    across the shard boundaries through the halo rows. F must be divisible
    by the mesh size."""
    sh = _Sharded(mesh, spec, cam, cfg, n_shapes, dtype)

    def step(params, w, kp, r0):
        params, w, kp, r0 = sh.to(params), sh.to(w), sh.to(kp), sh.to(r0)
        valid = torch.ones(params.shape[0], dtype=dtype, device=mesh.device)
        lam2, lam2_prev = sh.local_pair_weights(valid)
        p_loc = mesh.shard(params)
        h_pp, b_pw, c_ww, g_p, g_w = sh.assembly(
            p_loc, w, mesh.shard(kp), mesh.shard(r0), lam2, lam2_prev)
        dscale = torch.clamp(torch.diagonal(h_pp, dim1=-2, dim2=-1), 1e-6, 1e32)
        h_damped = h_pp + damping * torch.diag_embed(dscale)
        c_damped = c_ww + damping * torch.diag(
            torch.clamp(torch.diagonal(c_ww), 1e-6, 1e32))
        x_p, x_w, r_p, r_w = sh.pcg(h_damped, c_damped, b_pw, lam2,
                                    lam2_prev, g_p, g_w, cg_iters)
        res_norm = torch.sqrt(sh.pdot(r_p, r_w, r_p, r_w))
        new_p = project_scale(p_loc + x_p, p_loc, cfg.freeze_scale)
        return GNStepResult(mesh.all_gather(new_p), w + x_w, res_norm)

    return step


def sharded_gn_step(mesh, spec, cam, cfg, params, w, kp, r0, **kw):
    """One-shot ``build_sharded_gn_step``."""
    step = build_sharded_gn_step(mesh, spec, cam, cfg, int(w.shape[0]), **kw)
    return step(params, w, kp, r0)


def build_sharded_lm_fitter(mesh: FramesMesh, spec: SkeletonSpec,
                            cam: Camera, cfg: MultiFrameConfig, n_shapes: int,
                            cg_iters: int | None = None, dtype=torch.float32):
    """The multi-rank counterpart of ``build_multi_fitter``: the whole
    trust-region LM of the shared-shape multi-frame problem with the frames
    sharded. Each trip: the local assembly, the shape pieces all-reduced,
    then ``solve/multi_frame.py::trust_region_trip`` on 0-dim control
    fields, its solve block-Jacobi PCG on the damped system with the halo
    rows, its inner products and trial cost all-reduced.

    Returns fit(params0 (F, P), shape0 (nS,), kp (F, K, 4), r0 (F, 3, 3),
    frame_valid (F,) | None) -> MultiFrameResult with unbatched fields. F
    must be divisible by the mesh size: pad with frame_valid = 0 rows and
    masked keypoints (the dogleg radius scales with the valid count).

    The linear solve is always this PCG: an exact block-tridiagonal
    elimination is sequential across the shards, so ``cfg.linear`` does
    not apply; ``cfg.cg_iters`` is used unless ``cg_iters`` is given, and
    ``cfg.cg_rtol > 0`` adds the tolerance exit."""
    if cg_iters is None:
        cg_iters = cfg.cg_iters
    sh = _Sharded(mesh, spec, cam, cfg, n_shapes, dtype)

    def fit(params0, shape0, kp, r0, frame_valid=None):
        params0, w0, kp, r0 = (sh.to(params0), sh.to(shape0), sh.to(kp),
                               sh.to(r0))
        f_dim = params0.shape[0]
        if f_dim % mesh.size:
            raise ValueError(f"frame count {f_dim} not divisible by mesh "
                             f"size {mesh.size}; pad with frame_valid=0 rows")
        frame_valid = (torch.ones(f_dim, dtype=dtype, device=mesh.device)
                       if frame_valid is None else sh.to(frame_valid))
        lam2, lam2_prev = sh.local_pair_weights(frame_valid)
        kp, r0 = mesh.shard(kp), mesh.shard(r0)

        def cost_fn(params, w):
            r = keypoint_residuals(params, w.expand(params.shape[0], -1), kp,
                                   cam, spec, r0)
            s = torch.sum(r.unflatten(-1, (-1, 2)) ** 2, dim=-1)
            c_kp = torch.sum(_huber_rho(s, cfg.huber_delta))
            c_pose = sh.bp2 * torch.sum(params[:, sh.aa] ** 2)
            p_next = torch.cat([params[1:], sh.halo_next(params)[None]])
            diff = (params - p_next) * sh.tmask
            c_temp = torch.sum(lam2[:, None] * diff * diff)
            total = mesh.all_reduce((c_kp + c_pose + c_temp).reshape(1))[0]
            return 0.5 * (total + sh.bs2 * torch.sum(w * w))

        def step(state):
            h_pp, b_pw, c_ww, g_p, g_w = sh.assembly(
                state.params, state.shape, kp, r0, lam2, lam2_prev)

            def solve(d_blocks, c_reg, g_p, g_w):
                return sh.pcg(d_blocks, c_reg, b_pw, lam2, lam2_prev, g_p,
                              g_w, cg_iters, cfg.cg_rtol)[:2]

            def hmul(v_p, v_w):
                return sh.matvec(h_pp, c_ww, b_pw, lam2, lam2_prev, v_p, v_w)

            return trust_region_trip(
                cfg, state, h_pp, c_ww, g_p, g_w, solve=solve, hmul=hmul,
                dot=sh.pdot, trial=lambda p, w: (cost_fn(p, w), None))[0]

        params = mesh.shard(params0)
        state = start_state(cfg, params, w0, cost_fn(params, w0), frame_valid)
        costs = []
        for _ in range(cfg.max_iters):
            state = step(state)
            costs.append(state.cost)
        hist = (torch.stack(costs) if costs
                else state.cost.new_zeros((0,)))
        return MultiFrameResult(mesh.all_gather(state.params), *state[1:],
                                cost_history=hist)

    return fit
