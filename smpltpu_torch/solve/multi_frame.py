"""Multi-frame bundle adjustment: shared shape + per-frame pose + temporal
smoothness (port of ``smpltpu/solve/multi_frame.py``).

Same objective, step and stopping rules as the reference module (its
docstring gives the problem structure and the freeze-scale gauge fix); what
changes is the batching. The fitter is written for a leading window axis
W, which takes the place of ``jax.vmap`` (a single solve is W = 1), and
the convergence-exit ``lax.while_loop`` becomes a masked Python loop:

  * every window steps on every trip; a converged window keeps its state
    through the ``do_move`` / ``converged`` selects of the step, so its
    trajectory does not depend on how many trips its batch runs;
  * ``iters_run`` counts the trips a window was still unconverged;
  * the loop ends when every window has converged or at ``max_iters``.
    ``converged.all()`` is read on the host once per trip (one device sync
    per LM iteration).

The arrowhead GN system of each step goes to one of the reference's five
solvers, ``cfg.linear``:

  * ``"tridiag"`` (the default) and ``"cr"``: the exact solve, the pose
    blocks' block-tridiagonal system by :mod:`smpltpu_torch.solve.tridiag`
    (``tridiag``: elimination in the Thomas order, ~2F sequential
    factorizations; ``cr``: cyclic reduction, ceil(log2 F) levels of
    batched ones) and the shape Schur complement on top;
  * ``"pcg"``: the plain PyTorch PCG loop, any dtype and device;
  * ``"pcg_kernel"``: K1, the CUDA kernel of :mod:`smpltpu_torch.ops.cg`,
    for float32 CUDA tensors (the plain loop on the CPU);
  * ``"pcg_block"``: the plain loop with a block-diagonal preconditioner,
    the (P, P) blocks of the fit's first linearization and its nS x nS
    shape block inverted once per fit (K1 stays Jacobi-only).

The trip itself, :func:`trust_region_trip`, is shared with the
frame-sharded fitter of :mod:`smpltpu_torch.parallel.sharded`.

The PCG options run the same recursion. ``cfg.jacobian`` picks how the
normal equations are assembled (:func:`corrected_frame_assembly`): the
closed-form Jacobian (``"analytic"``, the default) or forward-mode
differentiation of the corrected residuals (``"jvp"``).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as tnf

from smpltpu_torch.constants import HUBER_DELTA, SCALE_MAX, SCALE_MIN
from smpltpu_torch.energy.jacobian import keypoint_residuals_and_jacobian
from smpltpu_torch.energy.params import hand_comps
from smpltpu_torch.energy.reproj import (
    Camera,
    SkeletonSpec,
    keypoint_residuals,
    spec_layout,
)
from smpltpu_torch.energy.temporal import temporal_mask
from smpltpu_torch.ops import cg as cg_ops
from smpltpu_torch.ops.cg import window_dot
from smpltpu_torch.solve.lm import (
    _huber_rho,
    huber_correct_weight,
    huber_correct_weight_and_slope,
)
from smpltpu_torch.solve.tridiag import block_tridiag_solve, block_tridiag_solve_cr
from smpltpu_torch.utils.obs import span

# forward-mode AD levels are process-wide in torch, not per thread: ranks
# run as threads (parallel/mesh.py::run_ranks) take turns in the jvp pushes
_FORWARD_AD = threading.Lock()
LINEAR_SOLVERS = ("tridiag", "cr", "pcg", "pcg_block", "pcg_kernel")
JACOBIANS = ("analytic", "jvp")


class MultiFrameConfig(NamedTuple):
    """The reference's config: its fields, in its order, with its defaults,
    so ``MultiFrameConfig(**jax_cfg._asdict())`` builds the same config.
    ``cg_unroll`` is accepted and changes nothing: in the reference it is
    the unroll factor of XLA's fixed-trip CG loop, whose iterate it leaves
    as it is; the port's CG loops are not compiled."""

    beta_pose: float
    beta_shape: float
    lambda_temporal: float
    max_iters: int
    freeze_scale: bool = True
    huber_delta: float = HUBER_DELTA
    init_radius: float = 1e4
    min_rel_decrease: float = 1e-3
    ftol: float = 1e-6
    diag_min: float = 1e-6
    diag_max: float = 1e32
    diag_eps: float = 1e-8
    dogleg: bool = True
    dogleg_init_radius: float = 1.0
    linear: str = "tridiag"
    cg_iters: int = 64
    cg_unroll: int = 1
    cg_rtol: float = 0.0
    fused_cost: bool = False
    jacobian: str = "analytic"


class MultiFrameState(NamedTuple):
    """The LM's state; in the frame-sharded fitter the control fields
    (radius to iters_run) are 0-dim and params is the rank's frames."""

    params: torch.Tensor            # (W, F, P)
    shape: torch.Tensor             # (W, nS)
    radius: torch.Tensor            # (W,)
    decrease_factor: torch.Tensor   # (W,)
    cost: torch.Tensor              # (W,)
    converged: torch.Tensor         # (W,) bool
    n_accepted: torch.Tensor        # (W,) int32
    iters_run: torch.Tensor         # (W,) int32


class MultiFrameResult(NamedTuple):
    """MultiFrameState plus the per-iteration cost trace."""

    params: torch.Tensor
    shape: torch.Tensor
    radius: torch.Tensor
    decrease_factor: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    n_accepted: torch.Tensor
    iters_run: torch.Tensor
    cost_history: torch.Tensor      # (W, max_iters)


def _per_window(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(W,) -> broadcastable against ``like`` (W, ...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _all_converged(state: MultiFrameState) -> bool:
    """The host's read of ``converged`` once a trip: it waits for the
    device to finish what the host has enqueued."""
    with span("multi_frame.wait"):
        return bool(state.converged.all())


def _normal_pieces(jp, jw, r):
    """(J_p^T J_p, J_p^T J_w, J_w^T J_w, J_p^T r, J_w^T r), batched."""
    jp_t, jw_t = jp.transpose(-1, -2), jw.transpose(-1, -2)
    return (jp_t @ jp, jp_t @ jw, jw_t @ jw,
            (jp_t @ r[..., None])[..., 0], (jw_t @ r[..., None])[..., 0])


def corrected_frame_assembly(p_f, w, kp_f, r0_f, cam: Camera,
                             spec: SkeletonSpec, huber_delta: float,
                             jacobian: str = "analytic",
                             with_cost: bool = False):
    """Normal-equation pieces of the Huber-CORRECTED keypoint residuals
    c = sqrt(rho(s)/s) r of every frame, batched over leading axes:
    p_f (..., P), w (..., nS) broadcasting against p_f's leading axes,
    kp_f (..., K, 4), r0_f (..., 3, 3). Returns (J_p^T J_p, J_p^T J_w,
    J_w^T J_w, J_p^T c, J_w^T c[, ||c||^2]).

    ``jacobian="analytic"``: the closed-form Jacobian, corrected per 2-row
    block by the rank-1 rule J_c = hw J + 2 hw'(s) b (b^T J), with hw' in
    closed form (solve/lm.py::huber_correct_weight_and_slope).
    ``"jvp"``: forward mode through c itself, one tangent per parameter
    (P + nS of them, all pushed at once by ``torch.func.vmap`` over
    ``torch.func.jvp``; the primal runs once), as the reference's
    ``jax.linearize`` and its batched pushes. A frame's residuals depend
    on its own p and on w only, so the pushed tangent e_k, broadcast over
    the frames, gives every frame's column k at once. At a masked row
    (s = 0) the weight's constant branch gives a zero tangent."""
    if jacobian not in JACOBIANS:
        raise ValueError(f"unknown jacobian {jacobian!r} (analytic | jvp)")
    if jacobian == "jvp":
        return _jvp_assembly(p_f, w, kp_f, r0_f, cam, spec, huber_delta,
                             with_cost)
    r_raw, jp_raw, jw_raw = keypoint_residuals_and_jacobian(
        p_f, w, kp_f, cam, spec, r0_f)
    blocks = r_raw.unflatten(-1, (-1, 2))                         # (..., K, 2)
    s = torch.sum(blocks * blocks, dim=-1)                        # (..., K)
    hw, hwp = huber_correct_weight_and_slope(s, huber_delta)
    jp_b = jp_raw.unflatten(-2, (-1, 2))                          # (..., K, 2, P)
    jw_b = jw_raw.unflatten(-2, (-1, 2))
    btj_p = torch.einsum("...kc,...kcp->...kp", blocks, jp_b)
    btj_w = torch.einsum("...kc,...kcs->...ks", blocks, jw_b)
    hw3, hwp3 = hw[..., None, None], 2.0 * hwp[..., None, None]
    jp = (hw3 * jp_b + hwp3 * blocks[..., None]
          * btj_p[..., None, :]).flatten(-3, -2)                  # (..., 2K, P)
    jw = (hw3 * jw_b + hwp3 * blocks[..., None]
          * btj_w[..., None, :]).flatten(-3, -2)                  # (..., 2K, nS)
    r = (blocks * hw[..., None]).flatten(-2)                      # (..., 2K)
    out = _normal_pieces(jp, jw, r)
    if with_cost:
        # ||c||^2 == rho(s) by construction: the Huber keypoint cost
        out = out + (torch.sum(hw * hw * s, dim=-1),)
    return out


def _jvp_assembly(p_f, w, kp_f, r0_f, cam, spec, huber_delta, with_cost):
    """``corrected_frame_assembly(..., jacobian="jvp")``."""
    n_p, n_s = p_f.shape[-1], w.shape[-1]

    def corrected(q, v):
        r = keypoint_residuals(q, v, kp_f, cam, spec, r0_f)
        blocks = r.unflatten(-1, (-1, 2))
        hw = huber_correct_weight(torch.sum(blocks * blocks, dim=-1),
                                  huber_delta)
        return (blocks * hw[..., None]).flatten(-2)

    # a primal that is an expanded view (the sharded assembly's w) cannot
    # carry a tangent
    p_f, w = p_f.contiguous(), w.contiguous()

    def push(e):
        return torch.func.jvp(corrected, (p_f, w),
                              (e[:n_p].expand(p_f.shape),
                               e[n_p:].expand(w.shape)))

    eye = torch.eye(n_p + n_s, dtype=p_f.dtype, device=p_f.device)
    with _FORWARD_AD:
        r, cols = torch.func.vmap(push)(eye)      # (P + nS, ..., 2K) each
    r = r[0]                                      # the primal, unbatched
    jac = cols.movedim(0, -1)                     # (..., 2K, P + nS)
    out = _normal_pieces(jac[..., :n_p], jac[..., n_p:], r)
    if with_cost:
        out = out + (torch.sum(r * r, dim=-1),)
    return out


def arrow_tridiag(d_blocks, off_scale, tmask, b_pw, c_reg, g_p, g_w,
                  linear: str = "tridiag"):
    """Exact solve of the arrowhead system [T B; B^T C] (dp, dw) = -(g_p,
    g_w) of each window (the reference's ``arrow_tridiag``), in K1's
    argument layout: d_blocks (W, F, P, P), off_scale (W, F-1), tmask (P,),
    b_pw (W, F, P, nS), c_reg (W, nS, nS), g_p (W, F, P), g_w (W, nS).
    T y = g_p and T Y = B in one block-tridiagonal solve (``linear``
    "tridiag": elimination; "cr": cyclic reduction), then the nS x nS
    Schur complement. Nothing in it waits for the device."""
    rhs = torch.cat([g_p[..., None], b_pw], dim=-1)
    solver = block_tridiag_solve_cr if linear == "cr" else block_tridiag_solve
    sol = solver(d_blocks, off_scale, tmask, rhs)
    y, cap_y = sol[..., 0], sol[..., 1:]
    schur = c_reg - torch.einsum("wfps,wfpt->wst", b_pw, cap_y)
    rhs_w = -g_w + torch.einsum("wfps,wfp->ws", b_pw, y)
    # solve_ex: no host read of the LU's info (a device sync)
    dw = torch.linalg.solve_ex(schur, rhs_w, check_errors=False)[0]
    return -y - torch.einsum("wfps,ws->wfp", cap_y, dw), dw


def _window_pair_dot(a_p, a_w, b_p, b_w):
    """Per-window <(a_p, a_w), (b_p, b_w)>."""
    return window_dot(a_p, b_p) + window_dot(a_w, b_w)


def project_scale(params_new, params, freeze_scale: bool):
    """The scale column after a step: ``params``'s under freeze_scale,
    else ``params_new``'s clamped to its bounds (a backstop)."""
    s = (params[..., :1] if freeze_scale
         else torch.clamp(params_new[..., :1], SCALE_MIN, SCALE_MAX))
    return torch.cat([s, params_new[..., 1:]], -1)


def start_state(cfg: MultiFrameConfig, params, shape, cost,
                frame_valid) -> MultiFrameState:
    """The LM's state before its first trip, control fields of
    ``frame_valid``'s leading shape ((W,), or () for the sharded fitter's
    one problem). The dogleg radius scales with the VALID frame count, so
    padded and unpadded solves of the same real frames follow one
    trajectory."""
    lead, dev = frame_valid.shape[:-1], cost.device
    if cfg.dogleg:
        n_valid = torch.clamp(torch.sum(frame_valid, dim=-1), min=1.0)
        radius = cfg.dogleg_init_radius * torch.sqrt(n_valid)
    else:
        radius = torch.full(lead, cfg.init_radius, dtype=cost.dtype,
                            device=dev)
    zeros_i = torch.zeros(lead, dtype=torch.int32, device=dev)
    return MultiFrameState(
        params=params, shape=shape, radius=radius,
        decrease_factor=torch.full(lead, 2.0, dtype=cost.dtype, device=dev),
        cost=cost, converged=torch.zeros(lead, dtype=torch.bool, device=dev),
        n_accepted=zeros_i, iters_run=zeros_i)


def trust_region_trip(cfg: MultiFrameConfig, state: MultiFrameState,
                      h_pp, c_ww, g_p, g_w, *, solve, hmul, dot, trial,
                      asm=None):
    """One trust-region iteration of the multi-frame LM from the assembly
    at ``state.params`` (pose blocks h_pp, shape block c_ww, gradient g_p,
    g_w), for ``build_multi_fitter`` (control fields (W,)) and the
    frame-sharded ``build_sharded_lm_fitter`` (0-dim, every reduction
    all-reduced, so every rank takes the same branch). What they do
    differently comes in as callables: ``solve(d_blocks, c_reg, g_p, g_w)
    -> (dp, dw)`` on the diagonally damped system, ``hmul(v_p, v_w)`` the
    undamped Hessian's product, ``dot(a_p, a_w, b_p, b_w)`` one inner
    product a problem, ``trial(params, w) -> (cost, assembly or None)``.
    Returns (new state, the trial's assembly where the step moved and
    ``asm``'s elsewhere, or None)."""
    params, w = state.params, state.shape
    diag_p = torch.clamp(torch.diagonal(h_pp, dim1=-2, dim2=-1),
                         cfg.diag_min, cfg.diag_max)
    diag_w = torch.clamp(torch.diagonal(c_ww, dim1=-2, dim2=-1),
                         cfg.diag_min, cfg.diag_max)
    radius = state.radius

    if cfg.dogleg:
        # Gauss-Newton point (lightly regularized) + Cauchy point,
        # dogleg-interpolated to the trust boundary
        d_blocks = h_pp + torch.diag_embed(1e-9 * diag_p + cfg.diag_eps)
        c_reg = c_ww + torch.diag_embed(1e-9 * diag_w + cfg.diag_eps)
        dp_gn, dw_gn = solve(d_blocks, c_reg, g_p, g_w)
        n_gn = torch.sqrt(dot(dp_gn, dw_gn, dp_gn, dw_gn))

        hg_p, hg_w = hmul(g_p, g_w)
        gg = dot(g_p, g_w, g_p, g_w)
        ghg = torch.clamp(dot(g_p, g_w, hg_p, hg_w), min=1e-30)
        alpha = gg / ghg
        sd_p = -_per_window(alpha, g_p) * g_p
        sd_w = -_per_window(alpha, g_w) * g_w
        n_sd = torch.sqrt(alpha * alpha * gg)

        # case C tau: ||sd + tau (gn - sd)||^2 = radius^2
        df_p, df_w = dp_gn - sd_p, dw_gn - sd_w
        a = torch.clamp(dot(df_p, df_w, df_p, df_w), min=1e-30)
        b = 2.0 * dot(sd_p, sd_w, df_p, df_w)
        c = n_sd * n_sd - radius * radius
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        tau = torch.clamp((-b + torch.sqrt(disc)) / (2.0 * a), 0.0, 1.0)

        use_gn = n_gn <= radius
        use_sd = ~use_gn & (n_sd >= radius)
        sd_scale = radius / torch.clamp(n_sd, min=1e-30)

        def pick(gn, sd, df):
            return torch.where(
                _per_window(use_gn, gn), gn,
                torch.where(_per_window(use_sd, sd),
                            _per_window(sd_scale, sd) * sd,
                            sd + _per_window(tau, df) * df))
        dp = pick(dp_gn, sd_p, df_p)
        dw = pick(dw_gn, sd_w, df_w)
        boundary = ~use_gn
    else:
        # ceres-style LM damping on every diagonal
        d_blocks = h_pp + torch.diag_embed(
            diag_p / _per_window(radius, diag_p) + cfg.diag_eps)
        c_reg = c_ww + torch.diag_embed(diag_w / _per_window(radius, diag_w)
                                        + cfg.diag_eps)
        dp, dw = solve(d_blocks, c_reg, g_p, g_w)

    params_new = project_scale(params + dp, params, cfg.freeze_scale)
    dp = params_new - params  # actual step after projection
    w_new = w + dw
    cost_new, asm_new = trial(params_new, w_new)

    # model decrease from the undamped quadratic
    hd, hd_w = hmul(dp, dw)
    gd = dot(g_p, g_w, dp, dw)
    dhd = dot(hd, hd_w, dp, dw)
    model_decrease = -gd - 0.5 * dhd
    rho = (state.cost - cost_new) / torch.clamp(model_decrease, min=1e-30)
    valid = torch.isfinite(cost_new) & (model_decrease > 0)

    if cfg.dogleg:
        accept = valid & (state.cost - cost_new > 0)
        step_norm = torch.sqrt(dot(dp, dw, dp, dw))
        new_radius = torch.where(
            rho < 0.25, 0.25 * step_norm,
            torch.where((rho > 0.75) & boundary, 2.0 * radius, radius))
        new_radius = torch.clamp(new_radius, 1e-12, 1e10)
        decrease_factor = state.decrease_factor
    else:
        accept = valid & (rho > cfg.min_rel_decrease)
        grow = radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                    min=1.0 / 3.0)
        shrink = radius / state.decrease_factor
        new_radius = torch.clamp(torch.where(accept, grow, shrink),
                                 1e-32, 1e16)
        decrease_factor = torch.where(
            accept, torch.full_like(radius, 2.0),
            state.decrease_factor * 2.0)

    f_conv = torch.abs(state.cost - cost_new) <= cfg.ftol * state.cost
    converged = state.converged | (accept & f_conv)
    if cfg.dogleg:
        # accept-any-decrease rejects every trial AT an optimum: also
        # converge when the radius collapses to parameter tolerance
        x_norm = torch.sqrt(dot(params, w, params, w))
        converged = converged | (new_radius <= 1e-8 * (x_norm + 1e-8))
    do_move = accept & ~state.converged
    frozen = state.converged

    new_state = MultiFrameState(
        params=torch.where(_per_window(do_move, params), params_new, params),
        shape=torch.where(_per_window(do_move, w), w_new, w),
        radius=torch.where(frozen, radius, new_radius),
        decrease_factor=torch.where(frozen, state.decrease_factor,
                                    decrease_factor),
        cost=torch.where(do_move, cost_new, state.cost),
        converged=converged,
        n_accepted=state.n_accepted + do_move.to(torch.int32),
        iters_run=state.iters_run + (~frozen).to(torch.int32),
    )
    if asm_new is not None:
        asm_new = tuple(torch.where(_per_window(do_move, old), new, old)
                        for old, new in zip(asm, asm_new))
    return new_state, asm_new


def build_multi_fitter(spec: SkeletonSpec, cam: Camera, cfg: MultiFrameConfig,
                       n_shapes: int, *, device, dtype):
    """Return fit(params0 (W, F, P), shape0 (W, nS) or (nS,), kp
    (W, F, K, 4), r0 (W, F, 3, 3), frame_valid (W, F) or None) ->
    MultiFrameResult with a leading window axis. Unbatched inputs
    (params0 (F, P), kp (F, K, 4), ...) solve one window and return
    unbatched fields, like the reference's fitter.

    frame_valid masks padding frames: their keypoints must already be
    masked; here it also cuts the temporal coupling across the padding."""
    if cfg.linear not in LINEAR_SOLVERS:
        raise ValueError(f"unknown linear solver {cfg.linear!r} "
                         "(tridiag | cr | pcg | pcg_block | pcg_kernel)")
    if cfg.jacobian not in JACOBIANS:
        raise ValueError(f"unknown jacobian {cfg.jacobian!r} (analytic | jvp)")

    n_joints = len(spec.parents)
    lay = spec_layout(spec)
    p_dim = lay["total"]
    aa0, aa1 = lay["joint_aa"]

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)
    bp2 = scalar(cfg.beta_pose) * scalar(cfg.beta_pose)
    bs2 = scalar(cfg.beta_shape) * scalar(cfg.beta_shape)
    lam = scalar(cfg.lambda_temporal)
    tmask = temporal_mask(n_joints, device=device, dtype=dtype,
                          n_hand_comps=hand_comps(spec.hands))    # (P,)
    tm2_diag = torch.diag(tmask * tmask)
    psel = torch.zeros(p_dim, dtype=dtype, device=device)
    psel[aa0:aa1] = 1.0
    bp2_diag = bp2 * torch.diag(psel)
    eye_s = torch.eye(n_shapes, dtype=dtype, device=device)
    keep = torch.ones(p_dim, dtype=dtype, device=device)          # freeze mask
    keep[0] = 0.0
    keep2 = keep[:, None] * keep[None, :]
    scale_diag = torch.diag(1.0 - keep)

    def prior_and_temporal_cost(params, w, pair_w):
        c_pose = bp2 * torch.sum(params[..., aa0:aa1] ** 2, dim=(-2, -1))
        c_shape = bs2 * torch.sum(w * w, dim=-1)
        diff = (params[:, :-1] - params[:, 1:]) * tmask
        c_temp = torch.sum((lam * pair_w)[..., None] ** 2 * diff * diff,
                           dim=(-2, -1))
        return c_pose + c_shape + c_temp

    def cost_fn(params, w, kp, r0, pair_w):
        r = keypoint_residuals(params, w[:, None, :], kp, cam, spec, r0)
        s = torch.sum(r.unflatten(-1, (-1, 2)) ** 2, dim=-1)
        c_kp = torch.sum(_huber_rho(s, cfg.huber_delta), dim=(-2, -1))
        return 0.5 * (c_kp + prior_and_temporal_cost(params, w, pair_w))

    def normal_eq(params, w, kp, r0, pair_w, with_cost=False):
        """Gradient and Hessian pieces of the weighted problem, per window;
        with_cost=True also returns the objective at (params, w), the
        keypoint part read off the corrected residuals."""
        pieces = corrected_frame_assembly(params, w[:, None, :], kp, r0, cam,
                                          spec, cfg.huber_delta, cfg.jacobian,
                                          with_cost)
        h_pp, b_pw, h_ww, g_p, g_w = pieces[:5]
        cost = None
        if with_cost:
            cost = 0.5 * (torch.sum(pieces[5], dim=-1)
                          + prior_and_temporal_cost(params, w, pair_w))

        # pose prior (linear)
        h_pp = h_pp + bp2_diag
        g_p = g_p + (bp2 * psel) * params
        # temporal (linear): stencil on the block-tridiagonal
        lam_pair = (lam * pair_w) ** 2                            # (W, F-1)
        deg = tnf.pad(lam_pair, (0, 1)) + tnf.pad(lam_pair, (1, 0))
        h_pp = h_pp + deg[..., None, None] * tm2_diag
        off_scale = -lam_pair                                     # E_f scale
        lam_diff = lam_pair[..., None] * ((params[:, :-1] - params[:, 1:])
                                          * (tmask * tmask))
        g_p = (g_p + tnf.pad(lam_diff, (0, 0, 0, 1))
               + tnf.pad(-lam_diff, (0, 0, 1, 0)))
        # shape prior
        c_ww = torch.sum(h_ww, dim=1) + bs2 * eye_s
        g_w_tot = torch.sum(g_w, dim=1) + bs2 * w
        if cfg.freeze_scale:
            h_pp = h_pp * keep2 + scale_diag
            b_pw = b_pw * keep[:, None]
            g_p = g_p * keep
        asm = (h_pp, off_scale, b_pw, c_ww, g_p, g_w_tot)
        return (asm, cost) if with_cost else asm

    def block_preconditioner(asm):
        """pcg_block's preconditioner from the assembly at the fit's start:
        the inverses of the (P, P) pose blocks and of the shape block,
        lightly regularized as the dogleg's Gauss-Newton system is."""
        h_pp, _, _, c_ww, _, _ = asm
        dg_p = torch.clamp(torch.diagonal(h_pp, dim1=-2, dim2=-1),
                           cfg.diag_min, cfg.diag_max)
        dg_w = torch.clamp(torch.diagonal(c_ww, dim1=-2, dim2=-1),
                           cfg.diag_min, cfg.diag_max)
        # inv_ex: no host read of the LU's info (a device sync)
        return (torch.linalg.inv_ex(h_pp + torch.diag_embed(
                    1e-9 * dg_p + cfg.diag_eps), check_errors=False)[0],
                torch.linalg.inv_ex(c_ww + torch.diag_embed(
                    1e-9 * dg_w + cfg.diag_eps), check_errors=False)[0])

    def step(state, kp, r0, pair_w, asm, prec):
        """One trip from the assembly ``asm`` at state.params (``prec``:
        pcg_block's preconditioner, else None) -> (new state, assembly at
        the new state or None)."""
        h_pp, off_scale, b_pw, c_ww, g_p, g_w = asm

        def solve(d_blocks, c_reg, g_p, g_w):
            args = (d_blocks, off_scale, tmask, b_pw, c_reg, g_p, g_w)
            if cfg.linear in ("tridiag", "cr"):
                return arrow_tridiag(*args, linear=cfg.linear)
            if cfg.linear in ("pcg", "pcg_block"):
                return cg_ops.arrow_pcg_torch(*args, iters=cfg.cg_iters,
                                              rtol=cfg.cg_rtol, prec=prec)
            # looked up on each call, so a caller may wrap the kernel entry
            return cg_ops.arrow_pcg(*(a.contiguous() for a in args),
                                    iters=cfg.cg_iters, rtol=cfg.cg_rtol)

        def hmul(v_p, v_w):
            return cg_ops.arrow_matvec(h_pp, off_scale, tmask, b_pw, c_ww,
                                       v_p, v_w)

        def trial(params, w):
            if cfg.fused_cost:
                asm_new, cost = normal_eq(params, w, kp, r0, pair_w,
                                          with_cost=True)
                return cost, asm_new
            return cost_fn(params, w, kp, r0, pair_w), None

        return trust_region_trip(cfg, state, h_pp, c_ww, g_p, g_w,
                                 solve=solve, hmul=hmul, dot=_window_pair_dot,
                                 trial=trial, asm=asm)

    def fit(params0, shape0, kp, r0, frame_valid=None):
        with span("multi_frame.fit"):
            return _fit(params0, shape0, kp, r0, frame_valid)

    def _fit(params0, shape0, kp, r0, frame_valid):
        unbatched = params0.dim() == 2
        if unbatched:
            params0, kp, r0 = params0[None], kp[None], r0[None]
            if frame_valid is not None:
                frame_valid = frame_valid[None]

        def to(t):
            return torch.as_tensor(t).to(device=device, dtype=dtype)
        params0, shape0, kp, r0 = to(params0), to(shape0), to(kp), to(r0)
        n_win, f_dim = params0.shape[:2]
        shape0 = shape0.expand(n_win, shape0.shape[-1]).contiguous()
        frame_valid = (torch.ones((n_win, f_dim), dtype=dtype, device=device)
                       if frame_valid is None else to(frame_valid))
        pair_w = frame_valid[:, :-1] * frame_valid[:, 1:]
        asm = None
        if cfg.fused_cost:
            asm, cost0 = normal_eq(params0, shape0, kp, r0, pair_w,
                                   with_cost=True)
        else:
            cost0 = cost_fn(params0, shape0, kp, r0, pair_w)
        prec = None
        if cfg.linear == "pcg_block":
            prec = block_preconditioner(
                asm if asm is not None
                else normal_eq(params0, shape0, kp, r0, pair_w))
        state = start_state(cfg, params0, shape0, cost0, frame_valid)
        # post-exit slots hold the final cost, so loss curves stay flat
        hist = cost0[:, None].repeat(1, cfg.max_iters)
        it = 0
        while it < cfg.max_iters and not _all_converged(state):
            with span("multi_frame.trip"):
                if not cfg.fused_cost:
                    asm = normal_eq(state.params, state.shape, kp, r0, pair_w)
                state, asm = step(state, kp, r0, pair_w, asm, prec)
                hist[:, it:] = state.cost[:, None]
            it += 1
        result = MultiFrameResult(*state, cost_history=hist)
        if unbatched:
            result = MultiFrameResult(*(t[0] for t in result))
        return result

    return fit


def build_chunked_window_fit(fitter, chunk_size: int):
    """Solve a batch of windows in chunks of ``chunk_size`` (port of the
    reference's function of the same name): fit(params0 (W, F, P),
    shape0 (W, nS), kp, r0, frame_valid (W, F)) -> MultiFrameResult over
    all W windows, the chunks' results concatenated.

    The batched fitter runs until its slowest window has converged, so a
    wide batch pays that window's trips for all of its windows; each chunk
    here stops on its own. A converged window keeps its state, so its
    trajectory does not depend on how many trips its batch runs, and in
    exact arithmetic per-window results equal those of one batch. Unlike
    the reference under ``jax.vmap``, this also holds with
    ``cfg.cg_rtol > 0``: the port's PCG (plain and K1) stops each window's
    CG on that window's own residual.

    In floating point the batch width moves the summation order, by
    rounding. The exact solves keep it there (``linear="tridiag"``, f64 on
    the card: 3e-11 in params after 60 trips at bench.py's 10 000
    frames). A truncated CG does not: from the same system, in a chunk
    and in the whole batch, its iterates part by 1e-16 after one step and
    by ~4e-3 of their scale after 64 (f64 and f32 alike), and the LM trips
    carry that on, so chunks and one batch end up to ~2 apart in weakly
    seen joint angles and up to 4 % apart in the final cost of windows
    stopped at the trip cap, while the video's residual moves by 4e-6 px
    (``chip_smoke.py``'s ``5 long_10k_batch``)."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")

    def fit(params0, shape0, kp, r0, frame_valid):
        parts = [fitter(params0[s:s + chunk_size], shape0[s:s + chunk_size],
                        kp[s:s + chunk_size], r0[s:s + chunk_size],
                        frame_valid[s:s + chunk_size])
                 for s in range(0, params0.shape[0], chunk_size)]
        return MultiFrameResult(*(torch.cat(f) for f in zip(*parts)))

    return fit


_multi_cache: dict = {}


def fit_multi_frame(spec: SkeletonSpec, cam: Camera, cfg: MultiFrameConfig,
                    params0: torch.Tensor, shape0: torch.Tensor,
                    kp: torch.Tensor, r0: torch.Tensor,
                    frame_valid: Optional[torch.Tensor] = None,
                    ) -> MultiFrameResult:
    """``build_multi_fitter`` with a cache per (problem, config, frame
    count, dtype, device): the fitter of this call's inputs, called on
    them."""
    key = (id(spec), id(cam), cfg, int(params0.shape[-2]), params0.dtype,
           params0.device, int(shape0.shape[-1]))
    if key not in _multi_cache:
        # pin (spec, cam) in the value: id() keys are only unique while the
        # objects are alive, so a recycled id must not hit a stale fitter
        _multi_cache[key] = ((spec, cam), build_multi_fitter(
            spec, cam, cfg, int(shape0.shape[-1]), device=params0.device,
            dtype=params0.dtype))
    return _multi_cache[key][1](params0, shape0, kp, r0, frame_valid)
