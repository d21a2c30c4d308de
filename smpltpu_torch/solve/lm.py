"""Batched Levenberg-Marquardt with an exact trust region (port of
``smpltpu/solve/lm.py``).

Same objective, steps and stopping rules as the reference module, whose
docstring gives the design (Huber-corrected residuals inside the
linearization, the Ceres-style schedule of the damped mode, the exact
More-Sorensen step of the default mode, bounds by projection). What
changes is the batching and where the Jacobian comes from:

  * every tensor carries a leading problem axis N, which takes the place
    of ``jax.vmap``; each problem keeps its own radius and convergence
    flag, and a converged problem keeps its state through the
    ``do_move`` / ``converged`` selects of the step;
  * the convergence-exit ``lax.while_loop`` is a Python loop that reads
    ``converged.all()`` on the host once per trip (its only device sync);
  * the Cholesky-Newton secular loop of ``tr_solver="chol"`` runs a fixed
    ``tr_newton_iters`` trips, each problem freezing its (lam, lo, hi, p,
    interior) once its own loop condition fails: the vmapped
    ``while_loop`` of the reference, with no host read;
  * ``residual_fn`` hands back the Jacobians with the residuals (the
    callers assemble them in closed form: ``solve/single_frame.py``); the
    Huber correction's own derivative is added here by the rank-1 rule of
    ``solve/multi_frame.py::corrected_frame_assembly``.

A factorization that fails (``cholesky_ex`` info != 0) is set to NaN, as
``jnp.linalg.cholesky`` gives it, so the step it yields is rejected.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class LMConfig(NamedTuple):
    """The reference's config under the same names and defaults; the
    reference module says what each one does."""

    max_iters: int
    huber_delta: float = 3.0
    init_radius: float = 1e4
    min_radius: float = 1e-32
    max_radius: float = 1e16
    min_rel_decrease: float = 1e-3
    ftol: float = 1e-6
    gtol: float = 1e-10
    xtol: float = 1e-8
    diag_min: float = 1e-6
    diag_max: float = 1e32
    exact_tr: bool = True
    exact_init_radius: float = 1.0
    tr_solver: str = "chol"           # "chol" | "eigh" | "dogleg"
    tr_newton_iters: int = 4


def _from_numpy(cls, state, device, dtype):
    """Fields of ``state`` (any sequence of arrays in ``cls``'s order, such
    as the reference's NamedTuple) as tensors: floats in ``dtype``, the
    flag as bool, the counters as int32."""
    kinds = {"converged": torch.bool, "n_accepted": torch.int32,
             "iters_run": torch.int32}
    return cls(*(torch.as_tensor(np.array(a), device=device).to(
        kinds.get(name, dtype)) for name, a in zip(cls._fields, state)))


class LMState(NamedTuple):
    x: torch.Tensor                 # (N, P) current parameters
    radius: torch.Tensor            # (N,) trust-region radius
    decrease_factor: torch.Tensor   # (N,) consecutive-rejection shrink factor
    cost: torch.Tensor              # (N,) current robustified cost
    converged: torch.Tensor         # (N,) bool
    n_accepted: torch.Tensor        # (N,) int32
    iters_run: torch.Tensor         # (N,) int32

    @classmethod
    def from_numpy(cls, state, *, device, dtype) -> "LMState":
        return _from_numpy(cls, state, device, dtype)


class LMResult(NamedTuple):
    """LMState plus the per-trip cost trace (loss_curve.txt's source)."""

    x: torch.Tensor
    radius: torch.Tensor
    decrease_factor: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    n_accepted: torch.Tensor
    iters_run: torch.Tensor
    cost_history: torch.Tensor      # (N, max_iters) cost after each trip

    @classmethod
    def from_numpy(cls, state, *, device, dtype) -> "LMResult":
        return _from_numpy(cls, state, device, dtype)


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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower factor of each matrix, NaN where it is not positive definite;
    no host read of the info (a device sync)."""
    ell, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return torch.where((info == 0)[..., None, None], ell,
                       torch.full_like(ell, float("nan")))


def _cho_solve(ell: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(b[..., None], ell)[..., 0]


def chol_tr_step(h, g, radius, newton_iters: int):
    """More-Sorensen step by Cholesky-Newton on the secular equation, for
    each problem of the batch: h (N, P, P) PSD, g (N, P), radius (N,) ->
    (step (N, P), boundary (N,) bool). The reference's ``chol_tr_step``
    (its docstring gives the method); its ``while_loop`` runs here as
    ``newton_iters`` trips, a problem's carry frozen once it is interior.
    The boundary step is the last solved iterate, unclamped (the
    reference says why)."""
    eps = torch.finfo(h.dtype).eps
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    diag_max = torch.clamp(torch.amax(torch.diagonal(h, dim1=-2, dim2=-1),
                                      dim=-1), min=1.0)
    lam_floor = 30.0 * eps * diag_max
    hi = _norm(g) / torch.clamp(radius, min=1e-30) + lam_floor
    lam, lo = lam_floor, lam_floor
    p = torch.zeros_like(g)
    interior = torch.zeros_like(radius, dtype=torch.bool)
    for i in range(newton_iters):
        live = ~interior
        ell = _cholesky(h + lam[..., None, None] * eye)
        p_i = _cho_solve(ell, -g)
        pnorm = _norm(p_i)
        feas = pnorm <= radius
        # feasible at the floor shift == the Gauss-Newton step is interior
        interior_i = (interior | feas) if i == 0 else interior
        lo_i = torch.where(feas, lo, lam)
        hi_i = torch.where(feas, lam, hi)
        q = torch.linalg.solve_triangular(ell, p_i[..., None], upper=False)[..., 0]
        qn2 = torch.clamp(torch.sum(q * q, dim=-1), min=1e-30)
        lam_i = lam + (pnorm * pnorm / qn2) * (pnorm - radius) / radius
        bad = (lam_i <= lo_i) | (lam_i >= hi_i) | ~torch.isfinite(lam_i)
        lam_i = torch.where(bad, torch.sqrt(torch.clamp(lo_i, min=1e-30)
                                            * torch.clamp(hi_i, min=1e-30)),
                            lam_i)
        lam = torch.where(live, lam_i, lam)
        lo = torch.where(live, lo_i, lo)
        hi = torch.where(live, hi_i, hi)
        p = torch.where(live[..., None], p_i, p)
        interior = torch.where(live, interior_i, interior)
    return p, ~interior


def eigh_tr_step(h, g, radius):
    """More-Sorensen step by one eigendecomposition and 48 log-bisections
    of the secular equation (the reference's ``exact_tr_step``, its
    oracle): same arguments and result as :func:`chol_tr_step`."""
    lam_e, q = torch.linalg.eigh(h)
    lam_e = torch.clamp(lam_e, min=0.0)
    gt = _mv(q.transpose(-1, -2), g)

    def norm_of(lam):
        return _norm(gt / (lam_e + lam[..., None]))

    lam_floor = 1e-12 * torch.clamp(lam_e[..., -1], min=1.0)
    n0 = norm_of(lam_floor)
    lo = torch.full_like(radius, 1e-12)
    hi = torch.full_like(radius, 1e12)
    for _ in range(48):
        mid = torch.sqrt(lo * hi)
        too_big = norm_of(mid) > radius
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    boundary = n0 > radius
    lam = torch.where(boundary, torch.sqrt(lo * hi), lam_floor)
    return -_mv(q, gt / (lam_e + lam[..., None])), boundary


def dogleg_tr_step(h, g, radius):
    """Powell dogleg on the floor-shifted system, one factorization
    (inexact on the boundary; the reference offers it for A/B only)."""
    eps = torch.finfo(h.dtype).eps
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    diag_max = torch.clamp(torch.amax(torch.diagonal(h, dim1=-2, dim2=-1),
                                      dim=-1), min=1.0)
    ell = _cholesky(h + (30.0 * eps * diag_max)[..., None, None] * eye)
    p_gn = _cho_solve(ell, -g)
    gn_norm = _norm(p_gn)
    g_norm2 = _dot(g, g)
    ghg = torch.clamp(_dot(g, _mv(h, g)), min=1e-30)
    p_c = -(g_norm2 / ghg)[..., None] * g
    c_norm = _norm(p_c)
    # segment p_c -> p_gn intersected with the sphere |d| = radius
    d = p_gn - p_c
    a = torch.clamp(_dot(d, d), min=1e-30)
    b = 2.0 * _dot(p_c, d)
    c = _dot(p_c, p_c) - radius * radius
    tau = (-b + torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0.0))) / (2 * a)
    p_seg = p_c + torch.clamp(tau, 0.0, 1.0)[..., None] * d
    p_cauchy = -(radius / torch.clamp(torch.sqrt(g_norm2), min=1e-30))[..., None] * g
    step_b = torch.where((c_norm >= radius)[..., None], p_cauchy, p_seg)
    return (torch.where((gn_norm <= radius)[..., None], p_gn, step_b),
            gn_norm > radius)


ResidualFn = Callable[[torch.Tensor, bool], tuple]


def corrected_residual_and_jacobian(residual_fn: ResidualFn, x: torch.Tensor,
                                    delta: float):
    """The Huber-corrected residual c = w(s) r of every robust block, the
    plain rows under them, (N, B*R + M), and its Jacobian (N, B*R + M, P):
    J_c = w J + 2 w'(s) r (r^T J) per block, from the Jacobians that
    ``residual_fn`` returns (the reference linearizes c with ``jax.jvp``)."""
    rb, rp, jb, jp = residual_fn(x, True)
    s = torch.sum(rb * rb, dim=-1)                                 # (N, B)
    w, wp = huber_correct_weight_and_slope(s, delta)
    rtj = torch.einsum("nbr,nbrp->nbp", rb, jb)
    jc = (w[..., None, None] * jb
          + (2.0 * wp)[..., None, None] * rb[..., None] * rtj[..., None, :])
    r = torch.cat([(rb * w[..., None]).flatten(1), rp], dim=-1)
    return r, torch.cat([jc.flatten(1, 2), jp], dim=1)


def lm_program(residual_fn: ResidualFn, cfg: LMConfig,
               lower: Optional[torch.Tensor] = None,
               upper: Optional[torch.Tensor] = None,
               frozen: Optional[torch.Tensor] = None):
    """(init, step) of the LM loop: ``init(x0 (N, P)) -> LMState`` and
    ``step(state) -> LMState``, one trip with no host read.

    ``residual_fn(x (N, P), with_jacobian)`` returns ``(rb (N, B, R),
    rp (N, M), jb (N, B, R, P), jp (N, M, P))``: the residual blocks wrapped
    in Huber (the keypoint 2-row blocks), the plain rows (priors) and, with
    ``with_jacobian``, their Jacobians (else None). lower/upper (P,) bounds
    (+-inf for free dims), frozen (P,) bool: dims held constant."""
    if cfg.tr_solver not in ("chol", "eigh", "dogleg"):
        raise ValueError(f"LMConfig.tr_solver must be 'eigh', 'chol' or "
                         f"'dogleg', got {cfg.tr_solver!r}")
    delta_h = cfg.huber_delta

    def clamp(x):
        if lower is not None:
            x = torch.maximum(x, lower.to(x.dtype))
        if upper is not None:
            x = torch.minimum(x, upper.to(x.dtype))
        return x

    def cost_fn(x):
        rb, rp, _, _ = residual_fn(x, False)
        s = torch.sum(rb * rb, dim=-1)
        return 0.5 * (torch.sum(_huber_rho(s, delta_h), dim=-1)
                      + torch.sum(rp * rp, dim=-1))

    def step(state: LMState) -> LMState:
        x = state.x
        p_dim = x.shape[-1]
        frz = (torch.zeros(p_dim, dtype=torch.bool, device=x.device)
               if frozen is None else frozen.to(x.device))
        free = ~frz
        frz_f = frz.to(x.dtype)
        r, jac = corrected_residual_and_jacobian(residual_fn, x, delta_h)
        # zero out frozen columns so they get no update and no gradient
        jac = jac * free.to(x.dtype)
        jac_t = jac.transpose(-1, -2)
        g = _mv(jac_t, r)
        h = jac_t @ jac
        radius = state.radius
        if cfg.exact_tr:
            # frozen dims pinned with unit curvature and zero gradient so
            # their step component is exactly 0
            g = torch.where(free, g, torch.zeros_like(g))
            h_pin = h + torch.diag(frz_f)
            if cfg.tr_solver == "chol":
                delta, boundary = chol_tr_step(h_pin, g, radius,
                                               cfg.tr_newton_iters)
            elif cfg.tr_solver == "dogleg":
                delta, boundary = dogleg_tr_step(h_pin, g, radius)
            else:
                delta, boundary = eigh_tr_step(h_pin, g, radius)
        else:
            # ceres-style damping: (1/radius) * clip(diag(H))
            diag = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1),
                               cfg.diag_min, cfg.diag_max)
            h_damped = (h + torch.diag_embed(diag / radius[..., None])
                        + torch.diag(frz_f))
            delta = -torch.linalg.solve_ex(h_damped, g, check_errors=False)[0]
            boundary = torch.ones_like(state.converged)
        delta = torch.where(free, delta, torch.zeros_like(delta))

        x_new = clamp(x + delta)
        step_vec = x_new - x          # actual step after projection
        cost_new = cost_fn(x_new)
        # model decrease from the Gauss-Newton quadratic (undamped)
        model_decrease = -_dot(g, step_vec) - 0.5 * _dot(step_vec, _mv(h, step_vec))
        rho = (state.cost - cost_new) / torch.clamp(model_decrease, min=1e-30)
        valid = torch.isfinite(cost_new) & (model_decrease > 0)

        if cfg.exact_tr:
            # scipy-TRF-style: accept any strict decrease; shrink to a
            # quarter of the actual step on poor agreement, double on
            # strong agreement at the boundary
            accept = valid & (state.cost - cost_new > 0)
            step_norm = _norm(step_vec)
            new_radius = torch.where(
                rho < 0.25, 0.25 * step_norm,
                torch.where((rho > 0.75) & boundary, 2.0 * radius, radius))
            new_radius = torch.clamp(new_radius, 1e-12, 1e8)
            decrease_factor = state.decrease_factor
        else:
            accept = valid & (rho > cfg.min_rel_decrease)
            grow = radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                        min=1.0 / 3.0)
            shrink = radius / state.decrease_factor
            new_radius = torch.clamp(torch.where(accept, grow, shrink),
                                     cfg.min_radius, cfg.max_radius)
            decrease_factor = torch.where(
                accept, torch.full_like(radius, 2.0),
                state.decrease_factor * 2.0)

        # convergence tests (on accepted steps, ceres-style)
        x_norm = _norm(x)
        f_conv = torch.abs(state.cost - cost_new) <= cfg.ftol * state.cost
        x_conv = _norm(step_vec) <= cfg.xtol * (x_norm + cfg.xtol)
        g_conv = torch.amax(torch.abs(g), dim=-1) <= cfg.gtol
        converged = state.converged | g_conv | (accept & (f_conv | x_conv))
        if cfg.exact_tr:
            # accept-any-decrease never accepts at an optimum: also
            # converge when the radius has collapsed to parameter tolerance
            converged = converged | (new_radius <= cfg.xtol * (x_norm + cfg.xtol))

        # masked update: converged problems freeze in place
        do_move = accept & ~state.converged
        held = state.converged
        return LMState(
            x=torch.where(do_move[..., None], x_new, x),
            radius=torch.where(held, radius, new_radius),
            decrease_factor=torch.where(held, state.decrease_factor,
                                        decrease_factor),
            cost=torch.where(do_move, cost_new, state.cost),
            converged=converged,
            n_accepted=state.n_accepted + do_move.to(torch.int32),
            iters_run=state.iters_run + (~held).to(torch.int32),
        )

    def init(x0: torch.Tensor) -> LMState:
        x0 = clamp(x0)
        n = x0.shape[0]
        zeros_i = torch.zeros(n, dtype=torch.int32, device=x0.device)
        return LMState(
            x=x0,
            radius=torch.full((n,), cfg.exact_init_radius if cfg.exact_tr
                              else cfg.init_radius, dtype=x0.dtype,
                              device=x0.device),
            decrease_factor=torch.full((n,), 2.0, dtype=x0.dtype,
                                       device=x0.device),
            cost=cost_fn(x0),
            converged=torch.zeros(n, dtype=torch.bool, device=x0.device),
            n_accepted=zeros_i, iters_run=zeros_i)

    return init, step


def lm_solve(residual_fn: ResidualFn, x0: torch.Tensor, cfg: LMConfig,
             lower: Optional[torch.Tensor] = None,
             upper: Optional[torch.Tensor] = None,
             frozen: Optional[torch.Tensor] = None) -> LMResult:
    """Minimize 0.5*(sum_b rho_huber(||r_b||^2) + ||r_plain||^2) for each
    of the N problems of x0 (N, P); arguments as in :func:`lm_program`.

    The loop ends when every problem has converged or after
    ``cfg.max_iters`` trips; the cost history's entries from a trip on
    hold that trip's cost, so a problem's curve stays flat after it
    converges."""
    init, step = lm_program(residual_fn, cfg, lower, upper, frozen)
    state = init(x0)
    hist = state.cost[:, None].repeat(1, cfg.max_iters)
    it = 0
    while it < cfg.max_iters and not bool(state.converged.all()):
        state = step(state)
        hist[:, it:] = state.cost[:, None]
        it += 1
    return LMResult(*state, cost_history=hist)
