"""The comparison that decides ``correct``: the plain reference
(``reference.py``, float64) reads what the timed path produced and
judges it.

A video (configuration ``multi_k1``):

* ``cost_gap``: the widest gap, relative, between the cost the program
  reports for a solved problem (stage 1's anchors and shape; each stage-2
  window) and the reference's cost at the parameters it returned;
* ``start_share``: the largest, over every problem, of the reference's
  cost at the returned parameters over its cost at the problem's start:
  stage 1's default pose, and each window's start worked out again from
  the program's stage-1 anchors (``interp_starts``) at the shape the
  window returned. A window that did not start from stage 1's answer, and
  ended costlier than that start, reads above 1;
* ``newton_gap``: the 90th percentile, over the problems whose solve
  stopped before its trip cap (one capped at ``max_iters`` may still be
  descending), of the share of a problem's cost that one exact
  Gauss-Newton step from the returned parameters would still remove: a
  solve that left its state where it started, or windows left unsolved,
  read high. (Its widest reading is not compared: the program's own
  stopping rule, a relative decrease <= 1e-6 on an accepted step, ends a
  few problems after a short dogleg step well short of stationarity; see
  PERF.md.)
* ``render_px``: the share of pixels of sampled rendered frames whose
  coverage or gray differs from the reference's z-buffer of the same
  per-frame parameters (skinned in float64, rasterized in float32).

The mean keypoint distance of the written-back per-frame parameters
(``fit_px``) goes to standard error and is not compared: bench.py's 2.0 px
gate was set on bench.py's one motion, and sound runs on these seeded
motions read above it where a video's fit settles in a poorer minimum.

A live feed (configuration ``stream_pump``): ``cost_gap`` of every
emitted pose's online problem (its previous pose the one emitted before
it), ``newton_gap`` (the 90th percentile) of those that stopped before
the trip cap, and ``calib_newton_gap`` of the shape calibration.

Each number's limit is in its configuration's file (``limits``), set
from the program's readings on a dozen seeds and the control's (the
reference in the program's place with its matrix products in TF32);
PERF.md gives the readings.
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from benchmark import reference as ref

NEWTON_Q = 0.9       # the quantile of newton_gap that is compared


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def _worst(values: List[torch.Tensor]) -> float:
    v = torch.cat([x.reshape(-1).double().cpu() for x in values])
    if v.numel() == 0:
        return 0.0
    return float("inf") if not torch.all(torch.isfinite(v)) else float(v.max())


def _quantile(v: torch.Tensor, q: float) -> float:
    v = v.reshape(-1).double()
    if v.numel() == 0:
        return 0.0
    return float("inf") if not torch.all(torch.isfinite(v)) else float(torch.quantile(v, q))


def _spread(label: str, values: List[torch.Tensor], n_all: int) -> None:
    """One line on stderr: how many problems a number read, and its
    quartiles and widest."""
    v = torch.cat([x.reshape(-1).double().cpu() for x in values])
    q = (np.quantile(v.numpy(), [0.5, 0.9, 0.99, 1.0]).tolist() if v.numel() else [])
    print(f"judge: {label} over {v.numel()} of {n_all} problems: median, p90, p99, max "
          f"{q}", file=sys.stderr, flush=True)


class VideoOut(NamedTuple):
    """What one video's timed path produced, on the host or the device:
    stage 1 (params (A, P), shape (nS,), cost ()), stage 2 (params (W, F,
    P), shape (W, nS), cost (W,)), each problem's trips (``iters_run``),
    the written-back per-frame params (N,
    P) and shape (nS,), and the sampled frames (indices, gray, covered)."""

    kp: torch.Tensor
    s1_params: torch.Tensor
    s1_shape: torch.Tensor
    s1_cost: torch.Tensor
    s1_iters: torch.Tensor
    s2_params: torch.Tensor
    s2_shape: torch.Tensor
    s2_cost: torch.Tensor
    s2_iters: torch.Tensor
    frame_params: torch.Tensor
    shape: torch.Tensor
    sample_idx: Optional[torch.Tensor]
    gray: Optional[torch.Tensor]
    covered: Optional[torch.Tensor]


class Layout(NamedTuple):
    """The video's anchors and windows, re-derived from the configuration."""

    n_frames: int
    anchor_idx: np.ndarray
    starts: np.ndarray
    wsize: int

    @classmethod
    def of(cls, cfg: dict, n_frames: int) -> "Layout":
        fit = cfg["fit"]
        stride = fit["window"] - fit["overlap"]
        return cls(n_frames, np.arange(0, n_frames, fit["anchor_every"]),
                   np.arange(0, n_frames, stride), fit["window"])

    def windows(self, kp: torch.Tensor):
        """(kp (W, F, K, 4) zero-padded, valid (W, F)) of the windows."""
        f = self.starts[:, None] + np.arange(self.wsize)[None]
        ok = torch.as_tensor(f < self.n_frames, device=kp.device)
        idx = torch.as_tensor(np.minimum(f, self.n_frames - 1), device=kp.device)
        kpw = torch.where(ok[..., None, None], kp[idx], torch.zeros_like(kp[idx]))
        kpw[..., 0] = kp[0, :, 0]
        return kpw, ok.to(kp.dtype)


def stage_cfgs(cfg: dict):
    fit = cfg["fit"]
    s1, s2 = fit["stage1"], fit["stage2"]
    return (ref.MultiCfg(s1["beta_pose"], s1["beta_shape"], s1["lambda_t"]),
            ref.MultiCfg(s2["beta_pose"], s2["beta_shape"], s2["lambda_t"]))


def interp_starts(lay: Layout, anchors, x_init):
    """The window starts (W, F, P) from the anchors' fitted params (A, P):
    linear between consecutive anchors, the last held to the end; window
    frames past the video get ``x_init``."""
    n = lay.n_frames
    a = lay.anchor_idx
    i = np.arange(n)
    seg = np.clip(np.searchsorted(a, i, side="right") - 1, 0, len(a) - 1)
    hi = np.minimum(seg + 1, len(a) - 1)
    nxt = np.where(seg + 1 < len(a), a[hi], n)
    t = torch.as_tensor((i - a[seg]) / np.maximum(nxt - a[seg], 1),
                        device=anchors.device, dtype=anchors.dtype)[:, None]
    poses = (1.0 - t) * anchors[seg] + t * anchors[hi]
    f = lay.starts[:, None] + np.arange(lay.wsize)[None]
    ok = torch.as_tensor(f < n, device=anchors.device)[..., None]
    return torch.where(ok, poses[torch.as_tensor(np.minimum(f, n - 1))], x_init)


def video_readings(cfg: dict, model: dict, outs: List[VideoOut], device) -> dict:
    """The reference's readings of every solve of the videos ``outs``, one
    entry a problem (stage 1, then each window, video after video):
    ``cost_gap``, ``start_share``, ``newton_gap``, ``capped`` (the solve
    stopped at its trip cap), and ``fit_px`` a video."""
    body = ref.make_body(model, ref.F64, device)
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    c1, c2 = stage_cfgs(cfg)
    cap1 = cfg["fit"]["stage1"]["max_iters"]
    cap2 = cfg["fit"]["stage2"]["max_iters"]
    r0 = torch.as_tensor(ref.R0, device=device, dtype=torch.float64)
    x_init = ref.init_params(1, device, torch.float64)
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
        lay = Layout.of(cfg, kp.shape[0])
        n_a = len(lay.anchor_idx)
        a = (kp[lay.anchor_idx][None], r0.expand(1, n_a, 3, 3),
             torch.ones((1, n_a), device=device, dtype=torch.float64))
        args1 = (d(o.s1_params)[None], d(o.s1_shape)[None]) + a
        e0 = ref.multi_cost(body, cam, c1, x_init.expand(n_a, -1)[None],
                            torch.zeros_like(args1[1]), *a)
        add(o.s1_cost, ref.multi_cost(body, cam, c1, *args1), e0,
            ref.multi_newton_gap(body, cam, c1, *args1), o.s1_iters, cap1)
        kpw, vw = lay.windows(kp)
        p0w = interp_starts(lay, d(o.s1_params), x_init[0])
        for s in range(0, len(lay.starts), 128):
            sl = slice(s, s + 128)
            w = kpw[sl].shape[0]
            rest = (kpw[sl], r0.expand(w, lay.wsize, 3, 3), vw[sl])
            args2 = (d(o.s2_params[sl]), d(o.s2_shape[sl])) + rest
            e0 = ref.multi_cost(body, cam, c2, p0w[sl], d(o.s2_shape[sl]), *rest)
            add(o.s2_cost[sl], ref.multi_cost(body, cam, c2, *args2), e0,
                ref.multi_newton_gap(body, cam, c2, *args2), o.s2_iters[sl], cap2)
        res = ref.kp_residuals(body, cam, d(o.frame_params), d(o.shape), kp, r0)
        got["fit_px"].append(torch.linalg.norm(res, dim=-1).mean()[None])
    return {k: torch.cat([x.reshape(-1) for x in v]).cpu() for k, v in got.items()}


def video_checks(cfg: dict, model: dict, outs: List[VideoOut],
                 render_outs: List[VideoOut], device) -> List[Check]:
    """Judge the videos ``outs`` (every solve of each) and the sampled
    frames of ``render_outs``."""
    lim = cfg["limits"]
    r = video_readings(cfg, model, outs, device)
    n_all = r["cost_gap"].numel()
    _spread("cost_gap", [r["cost_gap"]], n_all)
    _spread("start_share", [r["start_share"]], n_all)
    _spread("newton_gap", [r["newton_gap"]], n_all)
    _spread("newton_gap of the uncapped", [r["newton_gap"][~r["capped"]]], n_all)
    print("judge: fit_px (not compared) " + " ".join(f"{float(p):.4f}" for p in r["fit_px"]),
          file=sys.stderr, flush=True)
    out = [Check("cost_gap", _worst([r["cost_gap"]]), lim["cost_gap"]),
           Check("start_share", _worst([r["start_share"]]), lim["start_share"]),
           Check("newton_gap", _quantile(r["newton_gap"][~r["capped"]], NEWTON_Q),
                 lim["newton_gap"])]
    if render_outs:
        body = ref.make_body(model, ref.F64, device)
        cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
        r0 = torch.as_tensor(ref.R0, device=device, dtype=torch.float64)
        rc = cfg["render"]
        bad = tot = 0
        for o in render_outs:
            idx = torch.as_tensor(o.sample_idx, device=device)
            fp = o.frame_params.to(device=device, dtype=torch.float64)[idx]
            verts = ref.smpl_vertices(body, fp, o.shape.to(device, torch.float64), r0)
            g, c = ref.rasterize(verts, body.faces, cam, rc["height"], rc["width"])
            bad += int(((g != o.gray.to(device)) | (c != o.covered.to(device))).sum())
            tot += g.numel()
        out.append(Check("render_px", bad / max(tot, 1), lim["render_px"]))
    return out


class StreamOut(NamedTuple):
    """A live feed's emitted poses and what the judge needs beside them:
    the frames' keypoints (N, K, 4), poses (N, P), costs (N,) and trips
    (N,), the pose before the first (P,), the shape, and the calibration's
    keypoints (C, K, 4), params (C, P)."""

    kp: torch.Tensor
    x: torch.Tensor
    cost: torch.Tensor
    iters: torch.Tensor
    x_start: torch.Tensor
    shape: torch.Tensor
    calib_kp: torch.Tensor
    calib_params: torch.Tensor


def stream_checks(cfg: dict, model: dict, o: StreamOut, device) -> List[Check]:
    lim = cfg["limits"]
    body = ref.make_body(model, ref.F64, device)
    cam = ref.camera(cfg["camera"]["width"], cfg["camera"]["height"])
    on = cfg["online"]
    ocfg = ref.OnlineCfg(on["beta_pose"], on["lambda_t"])
    r0 = torch.as_tensor(ref.R0, device=device, dtype=torch.float64)

    def d(t):
        return torch.as_tensor(t).to(device=device, dtype=torch.float64)
    x, kp, shape = d(o.x), d(o.kp), d(o.shape)
    prev = torch.cat([d(o.x_start)[None], x[:-1]])
    has = torch.ones(x.shape[0], device=device, dtype=torch.float64)
    gaps, newton = [], []
    for s in range(0, x.shape[0], 512):
        sl = slice(s, s + 512)
        args = (x[sl], shape, kp[sl], prev[sl], has[sl], r0)
        e = ref.online_cost(body, cam, ocfg, *args)
        gaps.append(torch.abs(d(o.cost[sl]) - e) / e)
        done = torch.as_tensor(o.iters[sl], device=device) < on["max_iters"]
        newton.append(ref.online_newton_gap(body, cam, ocfg, *args)[done])
    cal = cfg["calibration"]
    ccfg = ref.MultiCfg(on["beta_pose"], cal["beta_shape"], on["lambda_t"])
    n_c = o.calib_kp.shape[0]
    cal_gap = ref.multi_newton_gap(
        body, cam, ccfg, d(o.calib_params)[None], shape[None], d(o.calib_kp)[None],
        r0.expand(1, n_c, 3, 3), torch.ones((1, n_c), device=device, dtype=torch.float64))
    _spread("cost_gap", gaps, x.shape[0])
    _spread("newton_gap", newton, x.shape[0])
    return [Check("cost_gap", _worst(gaps), lim["cost_gap"]),
            Check("newton_gap", _quantile(torch.cat(newton).cpu(), NEWTON_Q), lim["newton_gap"]),
            Check("calib_newton_gap", _worst([cal_gap]), lim["calib_newton_gap"])]
