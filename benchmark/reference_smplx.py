"""The plain reference of configuration ``multi_smplx``: SMPL-X's fit and
render in plain PyTorch, a frozen copy of ``tests/plain_smplx.py`` carried
in ``reference.py``'s precisions, with the judgement of a video.

It imports torch, numpy and the generic parts of ``reference.py`` and
``judge.py`` (the precisions, the pinhole, Huber, the regularized
system, the z-buffer, the checks and the video's layout), nothing of the
program and no JAX. What it computes (Pavlakos et al. 2019,
``smplx/lbs.py``, with the departures the configuration states):

* the frame vector ``[scale | root_aa | root_t | body joint_aa 1..21 |
  12 left + 12 right hand PCA coefficients]``, P = 94; the jaw and the
  eyes at zero; each hand's 15 joint angles ``mean + coeffs @
  components[:12]``;
* the fit's skeleton model over the 55-joint tree (the chain excluding
  the root's own rotation, R0 before the root's angle-axis, then the scale
  and the translation, joint 0 reporting its shape delta), the 10 shape
  coefficients' joint deltas; 47 keypoint slots, Huber on each, the pose
  prior on the body's angles and the hands' coefficients, the shape prior,
  the temporal term on every dim but the scale;
* SMPL-X's skinning with the 20-column basis, the expression held at
  zero, no pose blend shapes; the z-buffer of ``reference.py``.
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple

import numpy as np
import torch

from benchmark import judge
from benchmark import reference as ref

PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37,
     38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53], np.int64)
N_JOINTS, N_BETAS, N_COMPS = 55, 10, 12
BODY_JOINTS, LEFT = 22, 25
USE_SMPLX = np.concatenate([ref.USE_SMPL, np.arange(LEFT, LEFT + 30)])
B1 = 7 + 3 * (BODY_JOINTS - 1)                # 70: the hands' coefficients start
P_DIM = B1 + 2 * N_COMPS                      # 94


class Body(NamedTuple):
    """The model's arrays in one precision, and what the skeleton needs."""

    v_template: torch.Tensor       # (nV, 3)
    shapedirs: torch.Tensor        # (nV, 3, 20)
    j_reg: torch.Tensor            # (nJ, nV)
    weights: torch.Tensor          # (nV, nJ)
    jsr: torch.Tensor              # (nJ, 3, 10) the shape's joint deltas
    faces: torch.Tensor            # (nF, 3) int64
    base_offsets: torch.Tensor     # (nJ, 3) parent-relative rest offsets
    comps: torch.Tensor            # (2, 12, 45)
    mean: torch.Tensor             # (2, 45)
    prec: ref.Prec


def make_body(model: dict, prec: ref.Prec = ref.F64, device=None) -> Body:
    """``model``: the arrays ``gen_smplx.make_model`` made."""
    def t(k):
        return model[k].to(device=device or model[k].device, dtype=prec.dtype)
    vt, jr, sd = t("v_template"), t("J_regressor"), t("shapedirs")
    rest = prec.mm(jr, vt)
    pj = np.where(PARENTS < 0, 0, PARENTS)
    base = torch.cat([torch.zeros_like(rest[:1]), (rest - rest[pj])[1:]])
    jsr = prec.einsum("jv,vxs->jxs", jr, sd[..., :N_BETAS])
    return Body(vt, sd, jr, t("weights"), jsr,
                model["faces"].to(device=vt.device, dtype=torch.int64), base,
                t("hand_components")[:, :N_COMPS], t("hand_mean"), prec)


def init_params(n: int, device, dtype) -> torch.Tensor:
    x = torch.zeros((n, P_DIM), device=device, dtype=dtype)
    x[:, 0] = 1.0
    x[:, 6] = ref.INIT_DEPTH
    return x


def tmask(device, dtype):
    m = torch.ones(P_DIM, device=device, dtype=dtype)
    m[0] = 0.0
    return m


def joint_angles(body: Body, params):
    """(..., 54, 3): joints 1-21 from the frame vector, 22-24 zero, each
    hand's from its coefficients."""
    pr = body.prec
    lead = params.shape[:-1]
    left = body.mean[0] + pr.einsum("...c,ck->...k", params[..., B1:B1 + N_COMPS],
                                    body.comps[0])
    right = body.mean[1] + pr.einsum("...c,ck->...k", params[..., B1 + N_COMPS:],
                                     body.comps[1])
    face = torch.zeros(lead + (9,), device=params.device, dtype=params.dtype)
    return torch.cat([params[..., 7:B1], face, left, right], -1).unflatten(
        -1, (N_JOINTS - 1, 3))


def skeleton_joints(body: Body, params, shape, r0):
    """The fit's camera-space joints (..., 55, 3) of params (..., P), shape
    (..., 10) (broadcast), r0 (..., 3, 3)."""
    pr = body.prec
    delta = pr.einsum("jxs,...s->...jx", body.jsr, shape)
    pj = np.where(PARENTS < 0, 0, PARENTS)
    dpar = torch.cat([torch.zeros_like(delta[..., :1, :]), delta[..., pj[1:], :]], -2)
    offsets = body.base_offsets + (delta - dpar)
    rot = ref.rodrigues(joint_angles(body, params), pr)
    batch = torch.broadcast_shapes(rot.shape[:-3], offsets.shape[:-2])
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    g = [eye.expand(batch + (3, 3))]
    x = [rot.new_zeros(batch + (3,))]
    for j in range(1, N_JOINTS):
        p = int(PARENTS[j])
        g.append(pr.mm(g[p], rot[..., j - 1, :, :]))
        x.append(pr.mm(g[p], offsets[..., j, :, None])[..., 0] + x[p])
    x[0] = delta[..., 0, :].expand(batch + (3,))
    joints = pr.mm(torch.stack(x, dim=-2), r0.transpose(-1, -2))
    joints = pr.mm(joints, ref.rodrigues(params[..., 1:4], pr).transpose(-1, -2))
    return params[..., 0, None, None] * joints + params[..., None, 4:7]


def kp_residuals(body: Body, cam: ref.Camera, params, shape, kp, r0):
    """Masked keypoint residuals (..., K, 2)."""
    joints = skeleton_joints(body, params, shape, r0)
    idx = kp[..., 0].long()[..., None].expand(kp.shape[:-1] + (3,))
    pred = ref.project(torch.gather(joints, -2, idx), cam)
    return (pred - kp[..., 1:3]) * kp[..., 3:4]


def multi_cost(body, cam, cfg: ref.MultiCfg, params, shape, kp, r0, valid):
    """Cost of each window: params (W, F, P), shape (W, 10), kp (W, F, 47,
    4), r0 (W, F, 3, 3), valid (W, F). -> (W,)."""
    res = kp_residuals(body, cam, params, shape[:, None, :], kp, r0)
    c_kp = torch.sum(ref.huber_rho(torch.sum(res * res, -1)), dim=(-2, -1))
    c_pose = cfg.beta_pose ** 2 * torch.sum(params[..., 7:] ** 2, (-2, -1))
    c_shape = cfg.beta_shape ** 2 * torch.sum(shape * shape, -1)
    pair = (cfg.lambda_t * valid[:, :-1] * valid[:, 1:]) ** 2
    diff = (params[:, :-1] - params[:, 1:]) * tmask(params.device, params.dtype)
    c_t = torch.sum(pair[..., None] * diff * diff, dim=(-2, -1))
    return 0.5 * (c_kp + c_pose + c_shape + c_t)


def multi_system(body, cam, cfg: ref.MultiCfg, params, shape, kp, r0, valid) -> ref.Arrow:
    """The Gauss-Newton system of each window at (params, shape), the
    scale held; the corrected residuals' Jacobians by forward mode."""
    pr = body.prec
    w_n, f_n = params.shape[:2]

    def c_of(p, w, k, r):
        c = ref.corrected(kp_residuals(body, cam, p, w, k, r)).reshape(-1)
        return c, c
    jac = torch.func.vmap(torch.func.jacfwd(c_of, argnums=(0, 1), has_aux=True))
    (j_p, j_w), c = jac(params.reshape(w_n * f_n, -1),
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
    psel = tmask(dev, dt).clone()
    psel[1:7] = 0.0
    bp2, bs2 = cfg.beta_pose ** 2, cfg.beta_shape ** 2
    tm = tmask(dev, dt)
    d = d + torch.diag(bp2 * psel)
    g_p = g_p + bp2 * psel * params
    lam = (cfg.lambda_t * valid[:, :-1] * valid[:, 1:]) ** 2
    pad = torch.nn.functional.pad
    deg = pad(lam, (0, 1)) + pad(lam, (1, 0))
    d = d + deg[..., None, None] * torch.diag(tm * tm)
    ld = lam[..., None] * (params[:, :-1] - params[:, 1:]) * tm * tm
    g_p = g_p + pad(ld, (0, 0, 0, 1)) - pad(ld, (0, 0, 1, 0))
    g_w = g_w + bs2 * shape
    cc = cc + bs2 * torch.eye(N_BETAS, dtype=dt, device=dev)
    d = d * tm[:, None] * tm[None, :] + torch.diag(1.0 - tm)
    return ref.Arrow(d, -lam, b * tm[:, None], cc, g_p * tm, g_w)


def arrow_matvec(a: ref.Arrow, v_p, v_w, prec: ref.Prec):
    tm = tmask(v_p.device, v_p.dtype)
    pad = torch.nn.functional.pad
    u = prec.einsum("wfab,wfb->wfa", a.d, v_p)
    e = a.off[..., None] * tm
    u = u + pad(e * v_p[:, 1:], (0, 0, 0, 1)) + pad(e * v_p[:, :-1], (0, 0, 1, 0))
    u = u + prec.einsum("wfps,ws->wfp", a.b, v_w)
    u_w = prec.einsum("wfps,wfp->ws", a.b, v_p) + prec.einsum("wst,wt->ws", a.c, v_w)
    return u, u_w


def arrow_pcg(a: ref.Arrow, iters: int, prec: ref.Prec):
    """Jacobi-preconditioned CG from zero, ``iters`` steps."""
    wdot = ref._wdot
    dinv = 1.0 / torch.clamp(torch.diagonal(a.d, dim1=-2, dim2=-1), min=1e-20)
    cinv = 1.0 / torch.clamp(torch.diagonal(a.c, dim1=-2, dim2=-1), min=1e-20)
    x_p, x_w = torch.zeros_like(a.g_p), torch.zeros_like(a.g_w)
    r_p, r_w = -a.g_p, -a.g_w
    d_p, d_w = dinv * r_p, cinv * r_w
    rho = wdot(r_p, d_p) + wdot(r_w, d_w)
    for _ in range(iters):
        q_p, q_w = arrow_matvec(a, d_p, d_w, prec)
        alpha = rho / torch.clamp(wdot(d_p, q_p) + wdot(d_w, q_w), min=1e-30)
        x_p = x_p + alpha[:, None, None] * d_p
        x_w = x_w + alpha[:, None] * d_w
        r_p = r_p - alpha[:, None, None] * q_p
        r_w = r_w - alpha[:, None] * q_w
        z_p, z_w = dinv * r_p, cinv * r_w
        rho_n = wdot(r_p, z_p) + wdot(r_w, z_w)
        beta = rho_n / torch.clamp(rho, min=1e-30)
        d_p = z_p + beta[:, None, None] * d_p
        d_w = z_w + beta[:, None] * d_w
        rho = rho_n
    return x_p, x_w


def arrow_solve_exact(a: ref.Arrow):
    """[T B; B^T C] (dp, dw) = -(g_p, g_w) exactly: T by block elimination
    along the frames, then the shape's Schur complement."""
    f_n = a.d.shape[1]
    tm = tmask(a.d.device, a.d.dtype)
    rhs = torch.cat([a.g_p[..., None], a.b], dim=-1)
    chol, ys = [], []
    s_prev = y_prev = None
    for f in range(f_n):
        s_f, y_f = a.d[:, f], rhs[:, f]
        if f > 0:
            e = a.off[:, f - 1, None] * tm
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


def multi_newton_gap(body, cam, cfg: ref.MultiCfg, params, shape, kp, r0, valid):
    """-(g . exact GN step) / 2 / cost of each window. -> (W,)."""
    a = multi_system(body, cam, cfg, params, shape, kp, r0, valid)
    dp, dw = arrow_solve_exact(ref._regularized(a))
    dec = -(ref._wdot(a.g_p, dp) + ref._wdot(a.g_w, dw))
    return 0.5 * dec / multi_cost(body, cam, cfg, params, shape, kp, r0, valid)


def multi_lm(body, cam, cfg: ref.MultiCfg, params, shape, kp, r0, valid,
             max_iters: int, cg_iters: int) -> ref.LMOut:
    """The configuration's multi-frame fit (``reference.multi_lm``'s dogleg
    on this system), computed in ``body.prec``."""
    pr, wdot = body.prec, ref._wdot
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
        reg = ref._regularized(a)
        gn_p, gn_w = (arrow_pcg(reg, cg_iters, pr) if cg_iters > 0
                      else arrow_solve_exact(reg))
        n_gn = torch.sqrt(wdot(gn_p, gn_p) + wdot(gn_w, gn_w))
        hg_p, hg_w = arrow_matvec(a, a.g_p, a.g_w, pr)
        gg = wdot(a.g_p, a.g_p) + wdot(a.g_w, a.g_w)
        alpha = gg / torch.clamp(wdot(a.g_p, hg_p) + wdot(a.g_w, hg_w), min=1e-30)
        sd_p, sd_w = -alpha[:, None, None] * a.g_p, -alpha[:, None] * a.g_w
        n_sd = torch.sqrt(alpha * alpha * gg)
        df_p, df_w = gn_p - sd_p, gn_w - sd_w
        qa = torch.clamp(wdot(df_p, df_p) + wdot(df_w, df_w), min=1e-30)
        qb = 2.0 * (wdot(sd_p, df_p) + wdot(sd_w, df_w))
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
        model_dec = -(wdot(a.g_p, dp) + wdot(a.g_w, dw)) - 0.5 * (
            wdot(hd, dp) + wdot(hd_w, dw))
        rho = (cost - cost_new) / torch.clamp(model_dec, min=1e-30)
        accept = torch.isfinite(cost_new) & (model_dec > 0) & (cost - cost_new > 0)
        step_n = torch.sqrt(wdot(dp, dp) + wdot(dw, dw))
        new_r = torch.where(rho < 0.25, 0.25 * step_n, torch.where(
            (rho > 0.75) & ~use_gn, 2.0 * radius, radius)).clamp(1e-12, 1e10)
        f_conv = torch.abs(cost - cost_new) <= 1e-6 * cost
        x_n = torch.sqrt(wdot(state_p, state_p) + wdot(state_w, state_w))
        move = accept & ~conv
        iters = iters + (~conv).long()
        conv_new = conv | (accept & f_conv) | (new_r <= 1e-8 * (x_n + 1e-8))
        state_p = torch.where(move[:, None, None], new_p, state_p)
        state_w = torch.where(move[:, None], new_w, state_w)
        cost = torch.where(move, cost_new, cost)
        radius = torch.where(conv, radius, new_r)
        conv = conv_new
    return ref.LMOut(state_p, state_w, cost, iters)


def smplx_vertices(body: Body, params, shape, r0):
    """Camera-space vertices (N, nV, 3) of params (N, P) under ``shape``
    (10,) and r0 (3, 3): SMPL-X's skinning, the expression at zero, no pose
    blend shapes, joint 0 at ``root_t``."""
    pr = body.prec
    n = params.shape[0]
    coeffs = torch.cat([shape, shape.new_zeros(body.shapedirs.shape[-1] - N_BETAS)])
    v_sh = body.v_template + pr.einsum("vxs,s->vx", body.shapedirs, coeffs)
    j_rest = pr.mm(body.j_reg, v_sh)
    rots = ref.rodrigues(joint_angles(body, params), pr)
    g = [pr.mm(ref.rodrigues(params[:, 1:4], pr), r0.expand(n, 3, 3))]
    x = [params.new_zeros(n, 3)]
    for j in range(1, N_JOINTS):
        p = int(PARENTS[j])
        g.append(pr.mm(g[p], rots[:, j - 1]))
        x.append(pr.mm(g[p], (j_rest[j] - j_rest[p])[:, None])[..., 0] + x[p])
    g = torch.stack(g, 1)
    t = torch.stack(x, 1) - pr.einsum("njab,jb->nja", g, j_rest) + params[:, None, 4:7]
    a = pr.einsum("vj,njab->nvab", body.weights, g)
    return (pr.einsum("nvab,vb->nva", a, v_sh)
            + pr.einsum("vj,nja->nva", body.weights, t))


# ------------------------------------------------------------ the judgement

def video_readings(cfg: dict, model: dict, outs: List[judge.VideoOut], device) -> dict:
    """``judge.video_readings`` on this model: one entry a problem."""
    body = make_body(model, ref.F64, device)
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    c1, c2 = judge.stage_cfgs(cfg)
    cap1 = cfg["fit"]["stage1"]["max_iters"]
    cap2 = cfg["fit"]["stage2"]["max_iters"]
    r0 = torch.as_tensor(ref.R0, device=device, dtype=torch.float64)
    x_init = init_params(1, device, torch.float64)
    got = {k: [] for k in ("cost_gap", "start_share", "newton_gap", "capped", "fit_px")}

    def d(t):
        return t.to(device=device, dtype=torch.float64)

    def add(cost, e, e0, newton, iters, cap):
        got["cost_gap"].append(torch.abs(d(cost).reshape(-1) - e) / e)
        got["start_share"].append(e / e0)
        got["newton_gap"].append(newton)
        got["capped"].append(torch.as_tensor(iters, device=device).reshape(-1) >= cap)
    for o in outs:
        kp = d(o.kp)
        lay = judge.Layout.of(cfg, kp.shape[0])
        n_a = len(lay.anchor_idx)
        a = (kp[lay.anchor_idx][None], r0.expand(1, n_a, 3, 3),
             torch.ones((1, n_a), device=device, dtype=torch.float64))
        args1 = (d(o.s1_params)[None], d(o.s1_shape)[None]) + a
        e0 = multi_cost(body, cam, c1, x_init.expand(n_a, -1)[None],
                        torch.zeros_like(args1[1]), *a)
        add(o.s1_cost, multi_cost(body, cam, c1, *args1), e0,
            multi_newton_gap(body, cam, c1, *args1), o.s1_iters, cap1)
        kpw, vw = lay.windows(kp)
        p0w = judge.interp_starts(lay, d(o.s1_params), x_init[0])
        for s in range(0, len(lay.starts), 64):
            sl = slice(s, s + 64)
            w = kpw[sl].shape[0]
            rest = (kpw[sl], r0.expand(w, lay.wsize, 3, 3), vw[sl])
            args2 = (d(o.s2_params[sl]), d(o.s2_shape[sl])) + rest
            e0 = multi_cost(body, cam, c2, p0w[sl], d(o.s2_shape[sl]), *rest)
            add(o.s2_cost[sl], multi_cost(body, cam, c2, *args2), e0,
                multi_newton_gap(body, cam, c2, *args2), o.s2_iters[sl], cap2)
        res = kp_residuals(body, cam, d(o.frame_params), d(o.shape), kp, r0)
        got["fit_px"].append(torch.linalg.norm(res, dim=-1).mean()[None])
    return {k: torch.cat([x.reshape(-1) for x in v]).cpu() for k, v in got.items()}


def video_checks(cfg: dict, model: dict, outs: List[judge.VideoOut],
                 render_outs: List[judge.VideoOut], device) -> List[judge.Check]:
    """``judge.video_checks`` on this model: the same numbers, limits from
    the configuration's ``limits``."""
    lim = cfg["limits"]
    r = video_readings(cfg, model, outs, device)
    n_all = r["cost_gap"].numel()
    judge._spread("cost_gap", [r["cost_gap"]], n_all)
    judge._spread("start_share", [r["start_share"]], n_all)
    judge._spread("newton_gap", [r["newton_gap"]], n_all)
    judge._spread("newton_gap of the uncapped", [r["newton_gap"][~r["capped"]]], n_all)
    print("judge: fit_px (not compared) " + " ".join(f"{float(p):.4f}" for p in r["fit_px"]),
          file=sys.stderr, flush=True)
    out = [judge.Check("cost_gap", judge._worst([r["cost_gap"]]), lim["cost_gap"]),
           judge.Check("start_share", judge._worst([r["start_share"]]), lim["start_share"]),
           judge.Check("newton_gap", judge._quantile(r["newton_gap"][~r["capped"]],
                                                     judge.NEWTON_Q), lim["newton_gap"])]
    if render_outs:
        body = make_body(model, ref.F64, device)
        cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
        r0 = torch.as_tensor(ref.R0, device=device, dtype=torch.float64)
        rc = cfg["render"]
        bad = tot = 0
        for o in render_outs:
            idx = torch.as_tensor(o.sample_idx, device=device)
            fp = o.frame_params.to(device=device, dtype=torch.float64)[idx]
            verts = smplx_vertices(body, fp, o.shape.to(device, torch.float64), r0)
            g, c = ref.rasterize(verts, body.faces, cam, rc["height"], rc["width"])
            bad += int(((g != o.gray.to(device)) | (c != o.covered.to(device))).sum())
            tot += g.numel()
        out.append(judge.Check("render_px", bad / max(tot, 1), lim["render_px"]))
    return out
