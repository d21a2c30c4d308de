"""The benchmark's plain reference: the fit's objective, its solvers and
the render, in plain PyTorch.

It imports torch and numpy only: nothing of the program, nor JAX. It
works from the model's arrays and the keypoints that the benchmark made
(``gen.py``) and re-derives everything the program derives from them
(the skeleton's rest offsets, the window packing, the anchor tables, the
skinning operands). Where it reads the program's outputs, it reads them
only to judge them.

What it computes follows the formulation the configurations state:

* the skeleton model of the reprojection residuals: forward kinematics
  over SMPL's 24-joint tree from the rest joints ``J_regressor @
  v_template`` plus the shape deltas of ``joint_shape_reg``, the chain
  excluding the root's own rotation, R0 applied before the root's
  angle-axis, then the Sim3 scale and translation, joint 0 reporting its
  own shape delta; a pinhole camera;
* the Huber loss on each keypoint's 2-vector (delta 3 px), the pose prior
  ``beta_pose * joint_aa``, the shape prior ``beta_shape * shape``, the
  first-order temporal term ``lambda * (x_f - x_{f+1})`` on every dim but
  the scale, the online tether ``lambda * (x - prev)``; cost = half the
  sum of squares (of ``rho`` for the keypoints);
* SMPL's skinning (Loper et al. 2015) without the pose blend shapes, which
  the render does not apply (its departure from the published model,
  kept here so that the render is judged by what it is meant to draw);
* the z-buffer: gray ``round(220 * clip(n . view, 0, 1))`` of the nearest
  kept face (in front of the camera, facing it) whose three edge
  functions at the pixel's center are > -1e-12, depth quantized against
  each frame's far face, computed in float32 as the configuration's
  renderer does.

``Prec`` says how a computation is carried: float64, float32, or
float32 whose matrix products take their operands rounded to TF32 (the
control of ``judge.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13,
                    14, 16, 17, 18, 19, 20, 21], np.int64)
# the 17 keypoint slots' SMPL joints (the pelvis fills the last two)
USE_SMPL = np.array([1, 2, 4, 5, 7, 8, 10, 11, 15, 16, 17, 18, 19, 20, 21,
                     0, 0], np.int64)
N_JOINTS, N_SHAPES, P_DIM = 24, 10, 76
AA0, AA1 = 7, 76                       # joint angle-axes in the frame vector
HUBER_DELTA = 3.0
FIXED_JOINTS_ONLINE = (10, 11, 22, 23)  # held by the online pose-only fit
INIT_DEPTH = 3.0
FOCAL_FACTOR = 0.9
# R0 = yaw(pi) @ diag(1, -1, 1): facing the camera, image y downward
R0 = np.diag([-1.0, 1.0, -1.0]) @ np.diag([1.0, -1.0, 1.0])
DEPTH_LEVELS = 2 ** 22 - 2
SENTINEL = 0x7FFFFFFF


# ---------------------------------------------------------------- precision

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x with its significand rounded to TF32's 11 bits (10 stored), as a
    tensor core reads a float32 operand; the derivative passes through."""
    xd = x.detach()
    mag = xd.abs().to(torch.float64)
    e = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    scale = torch.exp2(10.0 - e)
    r = (torch.round(xd.to(torch.float64) * scale) / scale).to(xd.dtype)
    return x + torch.where(mag > 0, r - xd, torch.zeros_like(xd))


class Prec:
    """``mode``: "f64", "f32" or "tf32" (float32, matrix-product operands
    rounded to TF32)."""

    def __init__(self, mode: str):
        if mode not in ("f64", "f32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def _r(self, x):
        return tf32_round(x) if self.mode == "tf32" else x

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *(self._r(x) for x in xs))


F64 = Prec("f64")


# -------------------------------------------------------------- the body

class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


def camera(width: int, height: int) -> Camera:
    """The configuration's pinhole: f = 0.9 max(W, H), center at the middle."""
    f = FOCAL_FACTOR * max(width, height)
    return Camera(f, f, 0.5 * width, 0.5 * height)


class Body(NamedTuple):
    """The model's arrays in one precision, and what the skeleton needs."""

    v_template: torch.Tensor       # (nV, 3)
    shapedirs: torch.Tensor        # (nV, 3, nS)
    j_reg: torch.Tensor            # (nJ, nV)
    weights: torch.Tensor          # (nV, nJ)
    jsr: torch.Tensor              # (nJ, 3, nS) joint_shape_reg
    faces: torch.Tensor            # (nF, 3) int64
    base_offsets: torch.Tensor     # (nJ, 3) parent-relative rest offsets
    prec: Prec


def make_body(model: dict, prec: Prec = F64, device=None) -> Body:
    """``model``: the arrays ``gen.make_model`` made (any device, float32)."""
    def t(k):
        return model[k].to(device=device or model[k].device, dtype=prec.dtype)
    vt, jr = t("v_template"), t("J_regressor")
    rest = prec.mm(jr, vt)
    pj = np.where(PARENTS < 0, 0, PARENTS)
    base = rest - rest[pj]
    base = torch.cat([torch.zeros_like(base[:1]), base[1:]])
    return Body(vt, t("shapedirs"), jr, t("weights"),
                t("joint_shape_reg").reshape(N_JOINTS, 3, -1),
                model["faces"].to(device=vt.device, dtype=torch.int64),
                base, prec)


def init_params(n: int, device, dtype) -> torch.Tensor:
    x = torch.zeros((n, P_DIM), device=device, dtype=dtype)
    x[:, 0] = 1.0
    x[:, 6] = INIT_DEPTH
    return x


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def rodrigues(aa, prec: Prec):
    """(..., 3) -> (..., 3, 3), with the Taylor branch near 0."""
    th2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    k = _skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(k.shape)
    return eye + a * k + b * prec.mm(k, k)


def skeleton_joints(body: Body, params, shape, r0):
    """Camera-space joints (..., nJ, 3) of params (..., P), shape (..., nS)
    (broadcast), r0 (..., 3, 3)."""
    pr = body.prec
    delta = pr.einsum("jxs,...s->...jx", body.jsr, shape)          # (..., nJ, 3)
    pj = np.where(PARENTS < 0, 0, PARENTS)
    dpar = torch.cat([torch.zeros_like(delta[..., :1, :]),
                      delta[..., pj[1:], :]], dim=-2)
    offsets = body.base_offsets + (delta - dpar)
    rot = rodrigues(params[..., AA0:AA1].unflatten(-1, (N_JOINTS - 1, 3)), pr)
    batch = torch.broadcast_shapes(rot.shape[:-3], offsets.shape[:-2])
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    g = [eye.expand(batch + (3, 3))]
    x = [rot.new_zeros(batch + (3,))]
    for j in range(1, N_JOINTS):
        p = int(PARENTS[j])
        g.append(pr.mm(g[p], rot[..., j - 1, :, :]))
        x.append(pr.mm(g[p], offsets[..., j, :, None])[..., 0] + x[p])
    x[0] = delta[..., 0, :].expand(batch + (3,))
    joints = torch.stack(x, dim=-2)
    joints = pr.mm(joints, r0.transpose(-1, -2))
    joints = pr.mm(joints, rodrigues(params[..., 1:4], pr).transpose(-1, -2))
    return params[..., 0, None, None] * joints + params[..., None, 4:7]


def project(pts, cam: Camera):
    z = pts[..., 2]
    tiny = torch.where(z < 0, torch.full_like(z, -1e-8), torch.full_like(z, 1e-8))
    z = torch.where(torch.abs(z) < 1e-8, tiny, z)
    return torch.stack([cam.fx * pts[..., 0] / z + cam.cx,
                        cam.fy * pts[..., 1] / z + cam.cy], dim=-1)


def kp_residuals(body: Body, cam: Camera, params, shape, kp, r0):
    """Masked keypoint residuals (..., K, 2); kp (..., K, 4) rows
    [joint, u, v, valid]."""
    joints = skeleton_joints(body, params, shape, r0)
    idx = kp[..., 0].long()[..., None].expand(kp.shape[:-1] + (3,))
    pred = project(torch.gather(joints, -2, idx), cam)
    return (pred - kp[..., 1:3]) * kp[..., 3:4]


def huber_rho(s, delta=HUBER_DELTA):
    root = torch.sqrt(torch.clamp(s, min=1e-24))
    return torch.where(s <= delta * delta, s, 2.0 * delta * root - delta * delta)


def corrected(res):
    """Huber-corrected blocks sqrt(rho(s)/s) r, so that |c|^2 = rho(|r|^2)."""
    s = torch.sum(res * res, dim=-1)
    d2 = HUBER_DELTA * HUBER_DELTA
    s_safe = torch.clamp(s, min=1e-24)
    w = torch.sqrt(torch.clamp(2.0 * HUBER_DELTA * torch.sqrt(s_safe) - d2,
                               min=1e-24) / s_safe)
    return res * torch.where(s <= d2, torch.ones_like(s), w)[..., None]


def tmask(device, dtype):
    m = torch.ones(P_DIM, device=device, dtype=dtype)
    m[0] = 0.0
    return m


# ----------------------------------------------------------- the objectives

class MultiCfg(NamedTuple):
    beta_pose: float
    beta_shape: float
    lambda_t: float


def multi_cost(body, cam, cfg: MultiCfg, params, shape, kp, r0, valid):
    """Cost of each window: params (W, F, P), shape (W, nS), kp (W, F, K,
    4), r0 (W, F, 3, 3), valid (W, F). -> (W,)."""
    res = kp_residuals(body, cam, params, shape[:, None, :], kp, r0)
    c_kp = torch.sum(huber_rho(torch.sum(res * res, -1)), dim=(-2, -1))
    c_pose = cfg.beta_pose ** 2 * torch.sum(params[..., AA0:AA1] ** 2, (-2, -1))
    c_shape = cfg.beta_shape ** 2 * torch.sum(shape * shape, -1)
    pair = (cfg.lambda_t * valid[:, :-1] * valid[:, 1:]) ** 2
    diff = (params[:, :-1] - params[:, 1:]) * tmask(params.device, params.dtype)
    c_t = torch.sum(pair[..., None] * diff * diff, dim=(-2, -1))
    return 0.5 * (c_kp + c_pose + c_shape + c_t)


class OnlineCfg(NamedTuple):
    beta_pose: float
    lambda_t: float


def online_cost(body, cam, cfg: OnlineCfg, x, shape, kp, prev, has_prev, r0):
    """Cost of each frame's online problem: x, prev (N, P), shape (nS,),
    kp (N, K, 4), has_prev (N,), r0 (3, 3). -> (N,)."""
    res = kp_residuals(body, cam, x, shape, kp, r0)
    c_kp = torch.sum(huber_rho(torch.sum(res * res, -1)), dim=-1)
    c_pose = cfg.beta_pose ** 2 * torch.sum(x[:, AA0:AA1] ** 2, -1)
    teth = (cfg.lambda_t * has_prev)[:, None] * tmask(x.device, x.dtype) * (x - prev)
    return 0.5 * (c_kp + c_pose + torch.sum(teth * teth, -1))


def _frame_jacobians(body, cam, params, shape, kp, r0):
    """Per frame, the corrected keypoint residuals c (N, 2K) and their
    Jacobians in the frame's params (N, 2K, P) and in the shape (N, 2K,
    nS), by forward-mode differentiation: params (N, P), shape (N, nS),
    kp (N, K, 4), r0 (N, 3, 3)."""
    def c_of(p, w, k, r):
        c = corrected(kp_residuals(body, cam, p, w, k, r)).reshape(-1)
        return c, c
    jac = torch.func.vmap(torch.func.jacfwd(c_of, argnums=(0, 1), has_aux=True))
    (j_p, j_w), c = jac(params, shape, kp, r0)
    return c, j_p, j_w


class Arrow(NamedTuple):
    """The Gauss-Newton system of a batch of windows: D (W, F, P, P), the
    temporal coupling e (W, F-1) of the off-diagonal blocks -e * diag(tm),
    B (W, F, P, nS), C (W, nS, nS), gradient g_p (W, F, P), g_w (W, nS)."""

    d: torch.Tensor
    off: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    g_p: torch.Tensor
    g_w: torch.Tensor


def multi_system(body, cam, cfg: MultiCfg, params, shape, kp, r0, valid):
    """The Gauss-Newton system of each window at (params, shape), the
    scale held (its row pinned to the identity, zero gradient)."""
    pr = body.prec
    w_n, f_n = params.shape[:2]
    c, j_p, j_w = _frame_jacobians(
        body, cam, params.reshape(w_n * f_n, -1),
        shape[:, None].expand(w_n, f_n, -1).reshape(w_n * f_n, -1),
        kp.reshape(w_n * f_n, *kp.shape[2:]), r0.reshape(w_n * f_n, 3, 3))

    def per(t):
        return t.reshape((w_n, f_n) + t.shape[1:])
    c, j_p, j_w = per(c), per(j_p), per(j_w)
    d = pr.einsum("wfrp,wfrq->wfpq", j_p, j_p)
    b = pr.einsum("wfrp,wfrs->wfps", j_p, j_w)
    cc = pr.einsum("wfrs,wfrt->wst", j_w, j_w)
    g_p = pr.einsum("wfrp,wfr->wfp", j_p, c)
    g_w = pr.einsum("wfrs,wfr->ws", j_w, c)
    dt, dev = params.dtype, params.device
    psel = torch.zeros(P_DIM, dtype=dt, device=dev)
    psel[AA0:AA1] = 1.0
    bp2, bs2 = cfg.beta_pose ** 2, cfg.beta_shape ** 2
    tm = tmask(dev, dt)
    d = d + torch.diag(bp2 * psel)
    g_p = g_p + bp2 * psel * params
    lam = (cfg.lambda_t * valid[:, :-1] * valid[:, 1:]) ** 2       # (W, F-1)
    deg = torch.nn.functional.pad(lam, (0, 1)) + torch.nn.functional.pad(lam, (1, 0))
    d = d + deg[..., None, None] * torch.diag(tm * tm)
    ld = lam[..., None] * (params[:, :-1] - params[:, 1:]) * tm * tm
    g_p = (g_p + torch.nn.functional.pad(ld, (0, 0, 0, 1))
           - torch.nn.functional.pad(ld, (0, 0, 1, 0)))
    g_w = g_w + bs2 * shape
    cc = cc + bs2 * torch.eye(N_SHAPES, dtype=dt, device=dev)
    keep = tm                                                      # scale held
    d = d * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
    b = b * keep[:, None]
    g_p = g_p * keep
    return Arrow(d, -lam, b, cc, g_p, g_w)


def _regularized(a: Arrow) -> Arrow:
    """The lightly regularized system of the dogleg's Gauss-Newton point:
    1e-9 of each diagonal (clipped to [1e-6, 1e32]) plus 1e-8."""
    dp = torch.clamp(torch.diagonal(a.d, dim1=-2, dim2=-1), 1e-6, 1e32)
    dw = torch.clamp(torch.diagonal(a.c, dim1=-2, dim2=-1), 1e-6, 1e32)
    return a._replace(d=a.d + torch.diag_embed(1e-9 * dp + 1e-8),
                      c=a.c + torch.diag_embed(1e-9 * dw + 1e-8))


def arrow_matvec(a: Arrow, v_p, v_w, prec: Prec):
    tm = tmask(v_p.device, v_p.dtype)
    u = prec.einsum("wfab,wfb->wfa", a.d, v_p)
    e = a.off[..., None] * tm
    u = u + torch.nn.functional.pad(e * v_p[:, 1:], (0, 0, 0, 1))
    u = u + torch.nn.functional.pad(e * v_p[:, :-1], (0, 0, 1, 0))
    u = u + prec.einsum("wfps,ws->wfp", a.b, v_w)
    u_w = prec.einsum("wfps,wfp->ws", a.b, v_p) + prec.einsum("wst,wt->ws", a.c, v_w)
    return u, u_w


def _wdot(x, y):
    return torch.sum(x * y, dim=tuple(range(1, x.dim())))


def arrow_pcg(a: Arrow, iters: int, prec: Prec):
    """Jacobi-preconditioned CG on [T B; B^T C] (dp, dw) = -(g_p, g_w),
    ``iters`` steps from zero: the configuration's linear solver."""
    dinv = 1.0 / torch.clamp(torch.diagonal(a.d, dim1=-2, dim2=-1), min=1e-20)
    cinv = 1.0 / torch.clamp(torch.diagonal(a.c, dim1=-2, dim2=-1), min=1e-20)
    x_p, x_w = torch.zeros_like(a.g_p), torch.zeros_like(a.g_w)
    r_p, r_w = -a.g_p, -a.g_w
    d_p, d_w = dinv * r_p, cinv * r_w
    rho = _wdot(r_p, d_p) + _wdot(r_w, d_w)
    for _ in range(iters):
        q_p, q_w = arrow_matvec(a, d_p, d_w, prec)
        alpha = rho / torch.clamp(_wdot(d_p, q_p) + _wdot(d_w, q_w), min=1e-30)
        x_p = x_p + alpha[:, None, None] * d_p
        x_w = x_w + alpha[:, None] * d_w
        r_p = r_p - alpha[:, None, None] * q_p
        r_w = r_w - alpha[:, None] * q_w
        z_p, z_w = dinv * r_p, cinv * r_w
        rho_n = _wdot(r_p, z_p) + _wdot(r_w, z_w)
        beta = rho_n / torch.clamp(rho, min=1e-30)
        d_p = z_p + beta[:, None, None] * d_p
        d_w = z_w + beta[:, None] * d_w
        rho = rho_n
    return x_p, x_w


def arrow_solve_exact(a: Arrow):
    """The exact solution of [T B; B^T C] (dp, dw) = -(g_p, g_w): T by
    block elimination along the frames (its couplings are diagonal), then
    the shape's Schur complement."""
    w_n, f_n, p_n, _ = a.d.shape
    tm = tmask(a.d.device, a.d.dtype)
    rhs = torch.cat([a.g_p[..., None], a.b], dim=-1)              # (W, F, P, 1+nS)
    chol, ys = [], []
    s_prev = y_prev = None
    for f in range(f_n):
        s_f, y_f = a.d[:, f], rhs[:, f]
        if f > 0:
            e = a.off[:, f - 1, None] * tm                         # (W, P)
            s_f = s_f - e[:, :, None] * torch.cholesky_inverse(s_prev) * e[:, None, :]
            y_f = y_f - e[..., None] * torch.cholesky_solve(y_prev, s_prev)
        s_prev = torch.linalg.cholesky(s_f)
        y_prev = y_f
        chol.append(s_prev)
        ys.append(y_f)
    x = [None] * f_n
    x[-1] = torch.cholesky_solve(ys[-1], chol[-1])
    for f in range(f_n - 2, -1, -1):
        e = a.off[:, f, None] * tm
        x[f] = torch.cholesky_solve(ys[f] - e[..., None] * x[f + 1], chol[f])
    sol = torch.stack(x, dim=1)
    y, cap_y = sol[..., 0], sol[..., 1:]
    schur = a.c - torch.einsum("wfps,wfpt->wst", a.b, cap_y)
    rhs_w = -a.g_w + torch.einsum("wfps,wfp->ws", a.b, y)
    dw = torch.linalg.solve(schur, rhs_w)
    return -y - torch.einsum("wfps,ws->wfp", cap_y, dw), dw


def multi_newton_gap(body, cam, cfg: MultiCfg, params, shape, kp, r0, valid):
    """How far each window is from a stationary point of its objective:
    the decrease that one exact Gauss-Newton step from (params, shape)
    predicts, relative to the cost, -(g . step) / 2 / cost. -> (W,)."""
    a = multi_system(body, cam, cfg, params, shape, kp, r0, valid)
    dp, dw = arrow_solve_exact(_regularized(a))
    dec = -(_wdot(a.g_p, dp) + _wdot(a.g_w, dw))
    return 0.5 * dec / multi_cost(body, cam, cfg, params, shape, kp, r0, valid)


def _online_jacobian(body, cam, cfg: OnlineCfg, x, shape, kp, prev, has_prev, r0):
    """All residual rows of each frame's online problem and their
    Jacobian in x, the held dims' columns zeroed."""
    n = x.shape[0]
    w = shape.expand(n, -1)
    r0n = r0.expand(n, 3, 3)
    c, j_p, _ = _frame_jacobians(body, cam, x, w, kp, r0n)
    dt, dev = x.dtype, x.device
    tm = tmask(dev, dt)
    gate = (cfg.lambda_t * has_prev)[:, None]
    rows = [c, cfg.beta_pose * x[:, AA0:AA1], gate * tm * (x - prev)]
    prior_j = torch.zeros((AA1 - AA0, P_DIM), dtype=dt, device=dev)
    prior_j[:, AA0:AA1] = cfg.beta_pose * torch.eye(AA1 - AA0, dtype=dt, device=dev)
    jacs = [j_p, prior_j.expand(n, -1, -1), gate[..., None] * torch.diag(tm)]
    return torch.cat(rows, -1), torch.cat(jacs, 1) * online_free(dev, dt)


def online_free(device, dtype):
    """(P,) 1 for the dims the online fit moves: not the scale, not the
    joints no keypoint sees."""
    m = torch.ones(P_DIM, device=device, dtype=dtype)
    m[0] = 0.0
    for j in FIXED_JOINTS_ONLINE:
        m[AA0 + 3 * (j - 1):AA0 + 3 * j] = 0.0
    return m


def online_newton_gap(body, cam, cfg: OnlineCfg, x, shape, kp, prev, has_prev, r0):
    """Each frame's -(g . GN step) / 2 / cost over its free dims. -> (N,)."""
    r, jac = _online_jacobian(body, cam, cfg, x, shape, kp, prev, has_prev, r0)
    g = torch.einsum("nrp,nr->np", jac, r)
    h = torch.einsum("nrp,nrq->npq", jac, jac)
    held = 1.0 - online_free(x.device, x.dtype)
    step = torch.linalg.solve(h + torch.diag(held), -g)
    dec = -torch.sum(g * step, -1)
    return 0.5 * dec / online_cost(body, cam, cfg, x, shape, kp, prev, has_prev, r0)


# -------------------------------------------------------------- the solvers

class LMOut(NamedTuple):
    params: torch.Tensor
    shape: torch.Tensor
    cost: torch.Tensor
    iters: torch.Tensor


def multi_lm(body, cam, cfg: MultiCfg, params, shape, kp, r0, valid,
             max_iters: int, cg_iters: int) -> LMOut:
    """The configuration's multi-frame fit: Powell dogleg on the
    Gauss-Newton system (its point by ``cg_iters`` Jacobi-PCG steps, or
    the exact solve when ``cg_iters`` is 0), the scale held, accept any
    decrease, radius from sqrt(valid frames), converged on a relative
    decrease <= 1e-6 or a collapsed radius; every window stops on its own.
    Computed in ``body.prec``."""
    pr = body.prec
    w_n = params.shape[0]
    state_p, state_w = params.clone(), shape.clone()
    cost = multi_cost(body, cam, cfg, state_p, state_w, kp, r0, valid)
    radius = torch.sqrt(torch.clamp(valid.sum(-1), min=1.0))
    conv = torch.zeros(w_n, dtype=torch.bool, device=params.device)
    iters = torch.zeros(w_n, dtype=torch.int64, device=params.device)
    for _ in range(max_iters):
        if bool(conv.all()):
            break
        a = multi_system(body, cam, cfg, state_p, state_w, kp, r0, valid)
        reg = _regularized(a)
        gn_p, gn_w = (arrow_pcg(reg, cg_iters, pr) if cg_iters > 0
                      else arrow_solve_exact(reg))
        n_gn = torch.sqrt(_wdot(gn_p, gn_p) + _wdot(gn_w, gn_w))
        hg_p, hg_w = arrow_matvec(a, a.g_p, a.g_w, pr)
        gg = _wdot(a.g_p, a.g_p) + _wdot(a.g_w, a.g_w)
        ghg = torch.clamp(_wdot(a.g_p, hg_p) + _wdot(a.g_w, hg_w), min=1e-30)
        alpha = gg / ghg
        sd_p, sd_w = -alpha[:, None, None] * a.g_p, -alpha[:, None] * a.g_w
        n_sd = torch.sqrt(alpha * alpha * gg)
        df_p, df_w = gn_p - sd_p, gn_w - sd_w
        qa = torch.clamp(_wdot(df_p, df_p) + _wdot(df_w, df_w), min=1e-30)
        qb = 2.0 * (_wdot(sd_p, df_p) + _wdot(sd_w, df_w))
        qc = n_sd * n_sd - radius * radius
        tau = torch.clamp((-qb + torch.sqrt(torch.clamp(qb * qb - 4 * qa * qc, min=0)))
                          / (2 * qa), 0.0, 1.0)
        use_gn = n_gn <= radius
        use_sd = ~use_gn & (n_sd >= radius)
        sd_scale = radius / torch.clamp(n_sd, min=1e-30)

        def pick(gn, sd, df):
            sh = (-1,) + (1,) * (gn.dim() - 1)
            return torch.where(use_gn.view(sh), gn, torch.where(
                use_sd.view(sh), sd_scale.view(sh) * sd, sd + tau.view(sh) * df))
        dp, dw = pick(gn_p, sd_p, df_p), pick(gn_w, sd_w, df_w)
        dp = torch.cat([torch.zeros_like(dp[..., :1]), dp[..., 1:]], -1)
        new_p, new_w = state_p + dp, state_w + dw
        cost_new = multi_cost(body, cam, cfg, new_p, new_w, kp, r0, valid)
        hd, hd_w = arrow_matvec(a, dp, dw, pr)
        model_dec = -(_wdot(a.g_p, dp) + _wdot(a.g_w, dw)) - 0.5 * (
            _wdot(hd, dp) + _wdot(hd_w, dw))
        rho = (cost - cost_new) / torch.clamp(model_dec, min=1e-30)
        accept = torch.isfinite(cost_new) & (model_dec > 0) & (cost - cost_new > 0)
        step_n = torch.sqrt(_wdot(dp, dp) + _wdot(dw, dw))
        new_r = torch.where(rho < 0.25, 0.25 * step_n, torch.where(
            (rho > 0.75) & ~use_gn, 2.0 * radius, radius)).clamp(1e-12, 1e10)
        f_conv = torch.abs(cost - cost_new) <= 1e-6 * cost
        x_n = torch.sqrt(_wdot(state_p, state_p) + _wdot(state_w, state_w))
        move = accept & ~conv
        iters = iters + (~conv).long()
        conv_new = conv | (accept & f_conv) | (new_r <= 1e-8 * (x_n + 1e-8))
        state_p = torch.where(move[:, None, None], new_p, state_p)
        state_w = torch.where(move[:, None], new_w, state_w)
        cost = torch.where(move, cost_new, cost)
        radius = torch.where(conv, radius, new_r)
        conv = conv_new
    return LMOut(state_p, state_w, cost, iters)


def online_lm(body, cam, cfg: OnlineCfg, x0, shape, kp, prev, has_prev, r0,
              max_iters: int) -> LMOut:
    """The online fit of each frame (N problems): Levenberg-Marquardt on
    its free dims, damping on the Gauss-Newton diagonal, converged on a
    relative decrease <= 1e-6; computed in ``body.prec``."""
    pr = body.prec
    n = x0.shape[0]
    x = x0.clone()
    cost = online_cost(body, cam, cfg, x, shape, kp, prev, has_prev, r0)
    mu = torch.full((n,), 1e-4, dtype=x.dtype, device=x.device)
    conv = torch.zeros(n, dtype=torch.bool, device=x.device)
    iters = torch.zeros(n, dtype=torch.int64, device=x.device)
    held = 1.0 - online_free(x.device, x.dtype)
    for _ in range(max_iters):
        if bool(conv.all()):
            break
        r, jac = _online_jacobian(body, cam, cfg, x, shape, kp, prev, has_prev, r0)
        g = pr.einsum("nrp,nr->np", jac, r)
        h = pr.einsum("nrp,nrq->npq", jac, jac)
        dg = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1), 1e-6, 1e32)
        step = torch.linalg.solve(h + torch.diag_embed(mu[:, None] * dg)
                                  + torch.diag(held), -g)
        x_new = x + step
        c_new = online_cost(body, cam, cfg, x_new, shape, kp, prev, has_prev, r0)
        accept = torch.isfinite(c_new) & (c_new < cost)
        move = accept & ~conv
        iters = iters + (~conv).long()
        conv = conv | (accept & (torch.abs(cost - c_new) <= 1e-6 * cost))
        x = torch.where(move[:, None], x_new, x)
        cost = torch.where(move, c_new, cost)
        mu = torch.where(accept, mu * 0.3, mu * 10.0).clamp(1e-12, 1e12)
    return LMOut(x, shape, cost, iters)


# --------------------------------------------------------------- the render

def smpl_vertices(body: Body, params, shape, r0):
    """Camera-space vertices (N, nV, 3) of per-frame params (N, P) under
    ``shape`` (nS,) and r0 (3, 3): SMPL's skinning, no pose blend shapes."""
    pr = body.prec
    n = params.shape[0]
    v_sh = body.v_template + pr.einsum("vxs,s->vx", body.shapedirs, shape)
    j_rest = pr.mm(body.j_reg, v_sh)                                # (nJ, 3)
    rots = rodrigues(params[:, AA0:AA1].unflatten(-1, (N_JOINTS - 1, 3)), pr)
    root = pr.mm(rodrigues(params[:, 1:4], pr), r0.expand(n, 3, 3))
    g = [root]
    x = [params.new_zeros(n, 3)]
    for j in range(1, N_JOINTS):
        p = int(PARENTS[j])
        g.append(pr.mm(g[p], rots[:, j - 1]))
        x.append(pr.mm(g[p], (j_rest[j] - j_rest[p])[:, None])[..., 0] + x[p])
    g = torch.stack(g, 1)                                           # (N, nJ, 3, 3)
    t = torch.stack(x, 1) - pr.einsum("njab,jb->nja", g, j_rest) + params[:, None, 4:7]
    a = pr.einsum("vj,njab->nvab", body.weights, g)
    return (pr.einsum("nvab,vb->nva", a, v_sh)
            + pr.einsum("vj,nja->nva", body.weights, t))


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def rasterize(verts, faces, cam: Camera, height: int, width: int):
    """The z-buffer of verts (B, nV, 3) in float32: -> (gray (B, H, W)
    uint8, covered (B, H, W) bool). Per face: projection, z > 1e-6 at
    every corner, n_z < 0 (facing the camera), gray = round(220 clip(n_hat
    . view, 0, 1)), depth_q = clip(depth / far * (2^22 - 2)) of the
    corners' mean against the frame's farthest kept face (+1e-6), key
    depth_q << 8 | gray; a pixel keeps the least key of the faces whose
    edge functions (px A + (py B + C)) at its center are all > -1e-12,
    over each face's bounding box clipped to the frame."""
    v = verts.to(torch.float32)
    tri = v[:, faces]                                              # (B, F, 3, 3)
    z = tri[..., 2]
    ok = torch.all(z > 1e-6, dim=-1)
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    u = cam.fx * tri[..., 0] / zs + cam.cx
    w = cam.fy * tri[..., 1] / zs + cam.cy
    n = _cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    keep = ok & (n[..., 2] < 0.0)
    center = (tri[..., 0, :] + tri[..., 1, :] + tri[..., 2, :]) * (1.0 / 3.0)
    n_hat = n / torch.clamp(torch.sqrt(_sum3(n * n)), min=1e-30)[..., None]
    view = -center / torch.clamp(torch.sqrt(_sum3(center * center)), min=1e-30)[..., None]
    gray = torch.round(220.0 * torch.clamp(_sum3(n_hat * view), 0.0, 1.0)).to(torch.int32)
    depth = center[..., 2]
    far = torch.where(keep, depth, 0.0).amax(dim=-1, keepdim=True) + 1e-6
    dq = torch.clamp(depth / far * DEPTH_LEVELS, 0, DEPTH_LEVELS).to(torch.int32)
    key = torch.where(keep, (dq << 8) | gray, SENTINEL).to(torch.int32)
    coef = []
    for k in range(3):
        j = (k + 1) % 3
        ax, ay, bx, by = u[..., k], w[..., k], u[..., j], w[..., j]
        coef += [-(by - ay), bx - ax, (by - ay) * ax - (bx - ax) * ay]
    coef = torch.stack(coef, -1)
    area = ((u[..., 1] - u[..., 0]) * (w[..., 2] - w[..., 0])
            - (w[..., 1] - w[..., 0]) * (u[..., 2] - u[..., 0]))
    coef = coef * torch.where(area < 0.0, -1.0, 1.0)[..., None]
    box = face_boxes(u, w, keep, height, width)
    out_g = torch.empty((v.shape[0], height, width), dtype=torch.uint8, device=v.device)
    out_c = torch.empty((v.shape[0], height, width), dtype=torch.bool, device=v.device)
    for b in range(v.shape[0]):
        x0, y0, bw, bh = box[b].long().unbind(-1)
        cnt = bw * bh
        idx = torch.nonzero(cnt > 0).squeeze(1)
        c_n = cnt[idx]
        face = torch.repeat_interleave(idx, c_n)
        first = torch.cumsum(c_n, 0) - c_n
        off = torch.arange(face.numel(), device=v.device) - torch.repeat_interleave(first, c_n)
        xs = x0[face] + off % bw[face]
        ys = y0[face] + torch.div(off, bw[face], rounding_mode="floor")
        px, py = xs.to(torch.float32) + 0.5, ys.to(torch.float32) + 0.5
        c = coef[b, face]
        e = [px * c[:, 3 * k] + (py * c[:, 3 * k + 1] + c[:, 3 * k + 2]) for k in range(3)]
        inside = torch.minimum(torch.minimum(e[0], e[1]), e[2]) > -1e-12
        zbuf = torch.full((height * width,), SENTINEL, dtype=torch.int32, device=v.device)
        zbuf.scatter_reduce_(0, (ys * width + xs)[inside], key[b, face][inside], "amin")
        cov = zbuf != SENTINEL
        out_c[b] = cov.view(height, width)
        out_g[b] = torch.where(cov, zbuf & 0xFF, 0).to(torch.uint8).view(height, width)
    return out_g, out_c


def face_boxes(u, w, keep, height: int, width: int):
    """(B, F, 4) int32 [x0, y0, w, h]: the pixels each kept face's bounding
    box touches, clipped to the frame (zeros for a culled or off-screen
    face; corners clamped to [-1, size] first; a NaN corner drops it)."""
    def span(c, size):
        lo, hi = c.amin(dim=-1), c.amax(dim=-1)
        ok = lo <= hi
        a = torch.floor(torch.clamp(torch.where(ok, lo, 0.0), -1.0, float(size)))
        b = torch.floor(torch.clamp(torch.where(ok, hi, -1.0), -1.0, float(size)))
        a = torch.clamp(a.to(torch.int32), min=0)
        b = torch.clamp(b.to(torch.int32), max=size - 1)
        return a, torch.clamp(b - a + 1, min=0)
    x0, bw = span(u, width)
    y0, bh = span(w, height)
    on = keep & (bw > 0) & (bh > 0)
    zero = torch.zeros_like(x0)
    return torch.stack([torch.where(on, x0, zero), torch.where(on, y0, zero),
                        torch.where(on, bw, zero), torch.where(on, bh, zero)], -1)


def box_pixels(verts, faces, cam: Camera, height: int, width: int) -> int:
    """Pixels of every kept face's clipped bounding box over frames verts
    (B, nV, 3): what the z-buffer walks."""
    v = verts.to(torch.float32)
    tri = v[:, faces]
    z = tri[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    u = cam.fx * tri[..., 0] / zs + cam.cx
    w = cam.fy * tri[..., 1] / zs + cam.cy
    n = _cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    keep = torch.all(z > 1e-6, dim=-1) & (n[..., 2] < 0.0)
    bb = face_boxes(u, w, keep, height, width).long()
    return int((bb[..., 2] * bb[..., 3]).sum())
