"""Single-frame pose / pose+shape fitting (port of
``smpltpu/solve/single_frame.py``): every frame of a video fitted at once,
one LM problem per frame, batched over a leading frame axis.

Problem layout per frame (opt_shape=True appends the shape block):
    x = [ frame params (76) | shape w (nS, optional) ]

The reference module lists the semantics kept here: Huber(3.0) on the
keypoint blocks only, scale bounds [0.3, 3.0], joints 10/11/22/23 frozen
on the pose-only path and not on the pose+shape path, the GMM prior only
when asked for (else L2 on the angle-axes), ``freeze_scale`` as a gauge
fix. Its residual goes through ``jax.linearize``; here the Jacobian is
assembled in closed form from the keypoint Jacobian
(``energy/jacobian.py``) and the prior rows (``energy/priors.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from smpltpu_torch.constants import (
    FIXED_JOINTS_POSE_ONLY,
    HUBER_DELTA,
    SCALE_MAX,
    SCALE_MIN,
)
from smpltpu_torch.energy.jacobian import keypoint_residuals_and_jacobian
from smpltpu_torch.energy.params import frame_param_layout
from smpltpu_torch.energy.priors import (
    GMMPrior,
    gmm_pose_prior_residual_and_jacobian,
)
from smpltpu_torch.energy.reproj import (
    Camera,
    SkeletonSpec,
    keypoint_residuals,
    make_skeleton_spec,
)
from smpltpu_torch.models.smpl import SMPLModel
from smpltpu_torch.solve.lm import LMConfig, LMResult, lm_solve


class SingleFrameProblem(NamedTuple):
    spec: SkeletonSpec
    cam: Camera
    gmm: Optional[GMMPrior]
    beta_pose: float
    beta_shape: float
    opt_shape: bool
    n_joints: int
    n_shapes: int
    # hold scale at its init (not reference behavior; the reference
    # module's note says why its consumers want it)
    freeze_scale: bool = False


def make_single_frame_problem(
    model: SMPLModel,
    r0,
    cam: Camera,
    beta_pose: float = 0.0,
    beta_shape: float = 0.0,
    opt_shape: bool = False,
    gmm_dict: Optional[dict] = None,
    freeze_scale: bool = False,
) -> SingleFrameProblem:
    """The problem on the model's device and in its dtype. As in the
    reference, the spec carries the shape dependence only when shape is
    optimized with a positive prior weight: with ``opt_shape`` and
    ``beta_shape == 0`` the shape columns are zero."""
    spec = make_skeleton_spec(model, r0,
                              with_shape=opt_shape and beta_shape > 0.0)
    gmm = None
    if gmm_dict is not None and beta_pose > 0.0:
        gmm = GMMPrior.from_dict(gmm_dict, beta=beta_pose,
                                 device=model.v_template.device,
                                 dtype=model.v_template.dtype)
    return SingleFrameProblem(
        spec=spec, cam=cam, gmm=gmm,
        beta_pose=float(beta_pose), beta_shape=float(beta_shape),
        opt_shape=bool(opt_shape),
        n_joints=len(spec.parents), n_shapes=model.num_shapes,
        freeze_scale=bool(freeze_scale),
    )


def _split_x(x: torch.Tensor, prob: SingleFrameProblem):
    p = frame_param_layout(prob.n_joints)["total"]
    shape = (x[..., p:] if prob.opt_shape
             else x.new_zeros(x.shape[:-1] + (prob.n_shapes,)))
    return x[..., :p], shape


def _residual_fn(prob: SingleFrameProblem, kp: torch.Tensor, x: torch.Tensor,
                 with_jacobian: bool):
    """Residuals of every frame's problem, x (N, P[+nS]), kp (N, K, 4) ->
    (robust blocks (N, K, 2), plain rows (N, M), and with
    ``with_jacobian`` their Jacobians (N, K, 2, P[+nS]), (N, M, P[+nS]),
    else None): the contract of ``solve/lm.py::lm_program``."""
    lay = frame_param_layout(prob.n_joints)
    aa0, aa1 = lay["joint_aa"]
    p_tot = lay["total"]
    n_x = x.shape[-1]
    params, shape = _split_x(x, prob)
    joint_aa = params[..., aa0:aa1]
    if with_jacobian:
        r_kp, j_p, j_w = keypoint_residuals_and_jacobian(
            params, shape, kp, prob.cam, prob.spec)
        jac_kp = torch.cat([j_p, j_w], dim=-1) if prob.opt_shape else j_p
        jb = jac_kp.unflatten(-2, (-1, 2))
    else:
        r_kp = keypoint_residuals(params, shape, kp, prob.cam, prob.spec)
        jb = None
    rb = r_kp.unflatten(-1, (-1, 2))

    rows, jacs = [], []

    def cols(block, start):
        """A Jacobian block placed at columns [start, start + width)."""
        return torch.nn.functional.pad(
            block, (start, n_x - start - block.shape[-1]))

    if prob.beta_pose > 0.0:
        if prob.gmm is not None:
            r, j = gmm_pose_prior_residual_and_jacobian(
                joint_aa, prob.gmm, want_jacobian=with_jacobian)
            rows.append(r)
            if with_jacobian:
                jacs.append(cols(j, aa0))
        else:
            rows.append(prob.beta_pose * joint_aa)
            if with_jacobian:
                eye = torch.eye(aa1 - aa0, dtype=x.dtype, device=x.device)
                jacs.append(cols(prob.beta_pose * eye, aa0).expand(
                    x.shape[:-1] + (aa1 - aa0, n_x)))
    if prob.opt_shape and prob.beta_shape > 0.0:
        rows.append(prob.beta_shape * shape)
        if with_jacobian:
            eye = torch.eye(prob.n_shapes, dtype=x.dtype, device=x.device)
            jacs.append(cols(prob.beta_shape * eye, p_tot).expand(
                x.shape[:-1] + (prob.n_shapes, n_x)))
    rp = (torch.cat(rows, dim=-1) if rows
          else x.new_zeros(x.shape[:-1] + (0,)))
    jp = None
    if with_jacobian:
        jp = (torch.cat(jacs, dim=-2) if jacs
              else x.new_zeros(x.shape[:-1] + (0, n_x)))
    return rb, rp, jb, jp


def _bounds_and_frozen(prob: SingleFrameProblem, *, device, dtype):
    """(lower, upper, frozen) (P[+nS],): the scale bounds, the scale frozen
    under ``freeze_scale``, and on the pose-only path the joints MediaPipe
    never observes."""
    lay = frame_param_layout(prob.n_joints)
    n = lay["total"] + (prob.n_shapes if prob.opt_shape else 0)
    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    lower[0], upper[0] = SCALE_MIN, SCALE_MAX
    frozen = np.zeros(n, dtype=bool)
    if prob.freeze_scale:
        frozen[0] = True
    if not prob.opt_shape:
        for j in FIXED_JOINTS_POSE_ONLY:
            if j < prob.n_joints:
                s = lay["joint_aa"][0] + 3 * (j - 1)
                frozen[s:s + 3] = True
    return (torch.as_tensor(lower, device=device).to(dtype),
            torch.as_tensor(upper, device=device).to(dtype),
            torch.as_tensor(frozen, device=device))


def build_fitter(prob: SingleFrameProblem, max_iters: int, *, device, dtype,
                 lm_cfg: Optional[LMConfig] = None, chunk: int = 0):
    """Return fit(x0 (F, P[+nS]), kp_dense (F, K, 4)) -> LMResult, every
    frame's LM problem solved as one batch (``lm_cfg`` overrides the
    shipped LMConfig; max_iters is still taken from the argument).

    ``chunk > 0`` solves the batch in chunks of that many frames, each with
    its own convergence exit, so a wide batch does not run every frame for
    as many trips as its slowest one. The batch is padded to a multiple of
    ``chunk`` by repeating the last frame, and the pad is stripped.
    Per-frame results are those of the whole batch: a converged frame keeps
    its state."""
    lower, upper, frozen = _bounds_and_frozen(prob, device=device, dtype=dtype)
    cfg = (LMConfig(max_iters=max_iters, huber_delta=HUBER_DELTA)
           if lm_cfg is None else lm_cfg._replace(max_iters=max_iters))

    def solve(x0, kp):
        return lm_solve(lambda x, jac: _residual_fn(prob, kp, x, jac),
                        x0, cfg, lower=lower, upper=upper, frozen=frozen)

    def fit(x0, kp_dense):
        return fit_in_chunks(
            solve, chunk, torch.as_tensor(x0).to(device=device, dtype=dtype),
            torch.as_tensor(kp_dense).to(device=device, dtype=dtype))

    return fit


def fit_in_chunks(fit, chunk: int, x0: torch.Tensor,
                  kp: torch.Tensor) -> LMResult:
    """``fit(x0, kp)`` over the frames in chunks of ``chunk`` (all at once
    for ``chunk <= 0``), each with its own convergence exit; the batch is
    padded to a multiple of ``chunk`` by repeating its last frame, and the
    pad is stripped."""
    n = x0.shape[0]
    if chunk <= 0 or n == 0:
        return fit(x0, kp)
    pad = (-n) % chunk
    if pad:
        x0 = torch.cat([x0, x0[-1:].expand(pad, -1)])
        kp = torch.cat([kp, kp[-1:].expand((pad,) + kp.shape[1:])])
    parts = [fit(x0[s:s + chunk], kp[s:s + chunk])
             for s in range(0, n + pad, chunk)]
    return LMResult(*(torch.cat(f)[:n] for f in zip(*parts)))


_fitter_cache: dict = {}


def fit_frames(prob: SingleFrameProblem, x0: torch.Tensor,
               kp_dense: torch.Tensor, max_iters: int) -> LMResult:
    """``build_fitter`` with a cache per (problem, max_iters, dtype,
    device), in x0's dtype and on its device. Frames whose keypoints are
    all masked converge at once to their init (the reference's skip of an
    empty frame)."""
    key = (id(prob), int(max_iters), x0.dtype, x0.device)
    if key not in _fitter_cache:
        # pin `prob` in the value: id() keys are only unique while the
        # object is alive, so a recycled id must not hit a stale fitter
        _fitter_cache[key] = (prob, build_fitter(
            prob, max_iters, device=x0.device, dtype=x0.dtype))
    return _fitter_cache[key][1](x0, kp_dense)
