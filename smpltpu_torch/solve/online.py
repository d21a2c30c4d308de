"""Online (streaming, causal) fitting: one warm-started solve per frame
(port of ``smpltpu/solve/online.py``).

The reference module gives the formulation: per frame, the single-frame
objective (Huber keypoint reprojection plus the pose prior, pose only,
the shape held at its calibrated value) plus a temporal tether
``lambda_t * mask * (x - x_prev)`` to the previous frame's optimum, one
row of the multi-frame temporal stencil with the earlier frame frozen.
The shape is calibrated by the multi-frame fitter on a first buffer of
frames. What changes on the card:

  * the step is batched over a leading problem axis N, as ``solve/lm.py``
    is; the stream solves N = 1;
  * the reference's ``jax.jit`` of the step becomes :class:`OnlineGraph`:
    static device buffers for one problem's inputs and LM state, a CUDA
    graph of ``lm_program``'s init and a CUDA graph of ONE LM trip,
    replayed from a host loop that reads ``converged`` once a trip, as
    ``lm_solve`` does. A converged problem freezes in place, so the loop
    computes what ``lm_solve`` computes, and a trip is one graph launch in
    place of some 900 kernel launches;
  * in that graph the trip's linearization (FK, keypoint Jacobian, Huber
    correction, g and H) and its trial cost are two launches of one
    hand-written kernel (``ops/online.py``, K4) in place of the eager
    composition's ~400 nodes, and its trust-region step (four shifted
    Cholesky factorizations, their solves, the secular update) is one
    launch of another (``ops/trust_region.py``, K5) in place of ~250; the
    acceptance stays as it is. The eager step loop
    (:func:`build_online_step`) keeps the eager composition and is what
    the graph is held to;
  * the causal replay (:func:`build_online_scan`) drives that graph frame
    after frame; the frames to hold (no detection) are picked on the host
    from one copy of the validity flags;
  * :class:`OnlinePump` keeps the reference's interface on the same graph
    with no thread: the reference runs a device loop that blocks inside an
    ``io_callback``, here the host loop is the pump, and each frame is
    staged through a pinned host buffer.

On ``device="cpu"`` the graph's loop runs the same functions eagerly,
with no graph; that path is taken only when the caller asks for the CPU.
A failed capture raises: nothing drops back to eager trips on the card.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from smpltpu_torch.constants import (
    FIXED_JOINTS_POSE_ONLY,
    HUBER_DELTA,
    N_KP_SLOTS,
    SCALE_MAX,
    SCALE_MIN,
    init_root_rotation,
)
from smpltpu_torch.energy.jacobian import (
    _ancestor_mask,
    keypoint_residuals_and_jacobian,
)
from smpltpu_torch.energy.params import frame_param_layout, init_frame_params
from smpltpu_torch.energy.priors import (
    GMMPrior,
    gmm_pose_prior_residual_and_jacobian,
)
from smpltpu_torch.energy.reproj import (
    Camera,
    SkeletonSpec,
    keypoint_residuals,
    make_skeleton_spec,
    parent_tables,
    require_smpl_spec,
)
from smpltpu_torch.energy.temporal import temporal_mask
from smpltpu_torch.models.smpl import SMPLModel
from smpltpu_torch.ops import LAUNCHES
from smpltpu_torch.ops.online import online_normal, online_tables
from smpltpu_torch.ops.trust_region import tr_step
from smpltpu_torch.solve.lm import LMConfig, LMState, _mv, lm_program, lm_solve
from smpltpu_torch.utils.obs import span


class OnlineConfig(NamedTuple):
    """The reference's streaming knobs under the same names and defaults
    (the multi CLI's stage 2: beta_pose 5, lambda_t 3, shape locked);
    ``freeze_scale`` is the gauge fix the reference explains."""

    beta_pose: float = 5.0
    lambda_temporal: float = 3.0
    max_iters: int = 20
    freeze_scale: bool = True
    huber_delta: float = HUBER_DELTA


def _device(device) -> torch.device:
    """``device`` with its index ("cuda" -> "cuda:0"), so that the caches
    keyed by device (``parent_tables``) find what was made at build time."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _OnlineProblem(NamedTuple):
    residual_of: Callable   # (shape, kp, prev, has_prev) -> residual_fn
    lm_cfg: LMConfig
    lower: torch.Tensor
    upper: torch.Tensor
    frozen: torch.Tensor
    # (shape, kp, prev, has_prev) -> (linearize, cost_fn, tr_step) through
    # K4 and K5; None off CUDA
    kernel_of: Optional[Callable]


def _online_problem(spec: SkeletonSpec, cam: Camera, cfg: OnlineConfig,
                    n_joints: int, gmm: Optional[GMMPrior], *, device,
                    dtype) -> _OnlineProblem:
    """Bounds, frozen dims and every constant of the residual, made once on
    the device (a host-to-device copy inside a trip would wait for the
    device, and breaks a graph capture), and the residual function of a
    frame's inputs in ``lm_program``'s contract: the keypoint blocks wrapped
    in Huber; the plain rows the pose prior (the GMM, else ``beta_pose *
    joint_aa``, only when ``beta_pose > 0``), then the tether
    ``lambda * has_prev * tmask * (x - prev)``. With ``has_prev = 0`` or
    ``lambda_temporal = 0`` the tether rows stay, with a zero residual and a
    zero Jacobian, so the step is the single-frame pose-only solve.

    On a CUDA device it also gives ``kernel_of``: the same problem's
    ``lm_program`` linearization and cost through K4
    (``ops/online.py::online_normal``), the GMM rows, where there is a
    GMM, added to its g, H and cost from their eager residual and
    Jacobian, and its trust-region step through K5
    (``ops/trust_region.py::tr_step``)."""
    require_smpl_spec(spec, "the online fit (K4, SMPL's held joints)")
    device = _device(device)
    lay = frame_param_layout(n_joints)
    p_dim = lay["total"]
    aa0, aa1 = lay["joint_aa"]
    lower = np.full(p_dim, -np.inf)
    upper = np.full(p_dim, np.inf)
    lower[0], upper[0] = SCALE_MIN, SCALE_MAX
    frozen = np.zeros(p_dim, dtype=bool)
    if cfg.freeze_scale:
        frozen[0] = True
    # pose-only path: the joints MediaPipe never observes are held
    for j in FIXED_JOINTS_POSE_ONLY:
        if j < n_joints:
            s = aa0 + 3 * (j - 1)
            frozen[s:s + 3] = True

    def t(a):
        return torch.as_tensor(a, device=device).to(dtype)
    tmask = temporal_mask(n_joints, device=device, dtype=dtype)
    lam, bp = t(cfg.lambda_temporal), t(cfg.beta_pose)
    prior_jac = torch.nn.functional.pad(
        bp * torch.eye(aa1 - aa0, dtype=dtype, device=device),
        (aa0, p_dim - aa1))                                       # (D, P)
    tether_jac = torch.diag(tmask)                                # (P, P)
    # the FK's index tables, made now rather than inside the first trip
    parent_tables(spec.parents, device)
    _ancestor_mask(spec.parents, device, dtype)

    def residual_of(shape, kp, prev, has_prev):
        """The residual function over these inputs, read at every call
        (the trip graph's buffers change between frames)."""
        def residual_fn(x, with_jacobian):
            gate = lam * has_prev                                 # (N,)
            joint_aa = x[..., aa0:aa1]
            if with_jacobian:
                r_kp, j_p, _ = keypoint_residuals_and_jacobian(
                    x, shape, kp, cam, spec)
                jb = j_p.unflatten(-2, (-1, 2))
            else:
                r_kp = keypoint_residuals(x, shape, kp, cam, spec)
                jb = None
            rows, jacs = [], []
            if cfg.beta_pose > 0.0:
                if gmm is not None:
                    r, j = gmm_pose_prior_residual_and_jacobian(
                        joint_aa, gmm, want_jacobian=with_jacobian)
                    rows.append(r)
                    if with_jacobian:
                        jacs.append(torch.nn.functional.pad(
                            j, (aa0, p_dim - aa1)))
                else:
                    rows.append(bp * joint_aa)
                    if with_jacobian:
                        jacs.append(prior_jac.expand(
                            x.shape[:-1] + prior_jac.shape))
            rows.append(gate[..., None] * tmask * (x - prev))
            jp = None
            if with_jacobian:
                jacs.append(gate[..., None, None] * tether_jac)
                jp = torch.cat(jacs, dim=-2)
            return r_kp.unflatten(-1, (-1, 2)), torch.cat(rows, dim=-1), jb, jp
        return residual_fn

    frozen_t = torch.as_tensor(frozen, device=device)
    kernel_of = None
    if device.type == "cuda":
        use_gmm = cfg.beta_pose > 0.0 and gmm is not None
        tables = online_tables(
            spec, cam, frozen_t, 0.0 if use_gmm else max(cfg.beta_pose, 0.0),
            cfg.lambda_temporal, cfg.huber_delta, device=device, dtype=dtype)
        free = (~frozen_t).to(dtype)

        def kernel_of(shape, kp, prev, has_prev):
            """(linearize, cost_fn, tr_step) over these inputs, read at
            every call."""
            def gmm_rows(x, with_jacobian):
                r, j = gmm_pose_prior_residual_and_jacobian(
                    x[..., aa0:aa1], gmm, want_jacobian=with_jacobian)
                if j is not None:
                    j = torch.nn.functional.pad(j, (aa0, p_dim - aa1)) * free
                return r, j

            def linearize(x):
                g, h, _ = online_normal(tables, x, prev, has_prev, shape, kp)
                if use_gmm:
                    r, j = gmm_rows(x, True)
                    j_t = j.transpose(-1, -2)
                    g, h = g + _mv(j_t, r), h + j_t @ j
                return g, h

            def cost_fn(x):
                c = online_normal(tables, x, prev, has_prev, shape, kp,
                                  jacobian=False)
                if use_gmm:
                    r, _ = gmm_rows(x, False)
                    c = c + 0.5 * torch.sum(r * r, dim=-1)
                return c
            return linearize, cost_fn, tr_step

    return _OnlineProblem(
        residual_of=residual_of,
        lm_cfg=LMConfig(max_iters=cfg.max_iters, huber_delta=cfg.huber_delta),
        lower=t(lower), upper=t(upper), frozen=frozen_t, kernel_of=kernel_of)


def build_online_step(spec: SkeletonSpec, cam: Camera, cfg: OnlineConfig,
                      n_joints: int, gmm: Optional[GMMPrior] = None, *,
                      device, dtype):
    """Return step(x0 (N, P), shape (nS,), kp (N, K, 4), prev (N, P),
    has_prev (N,)) -> LMResult: N frames fitted as one batch by the eager
    ``lm_solve`` (the per-dispatch path). ``has_prev`` (0/1) gates the
    tether, so the first frame of a stream solves the plain single-frame
    problem. ``spec`` carries the shape dependence (``with_shape=True``):
    the shape is data here, never an unknown."""
    prob = _online_problem(spec, cam, cfg, n_joints, gmm, device=device,
                           dtype=dtype)

    def to(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    def step(x0, shape, kp, prev, has_prev):
        return lm_solve(prob.residual_of(to(shape), to(kp), to(prev),
                                         to(has_prev)),
                        to(x0), prob.lm_cfg, prob.lower, prob.upper,
                        prob.frozen)
    return step


def _copy_into(dst: LMState, src: LMState) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class OnlineGraph:
    """One online problem (N = 1) on static buffers: ``prev`` (1, P),
    ``shape`` (nS,), ``kp`` (1, K, 4), ``has_prev`` (1,) in, ``state`` (an
    LMState of (1, ...) tensors) out. The caller writes the inputs in place
    and calls :meth:`solve`, which fits the frame warm-started from
    ``prev``.

    On a CUDA device the constructor captures a graph of ``lm_program``'s
    init and a graph of one LM trip, in a memory pool of this object's own
    (a second graph never replays into this one's buffers), after two
    warm-up trips on a side stream; it then zeroes every buffer, so the
    warm-up leaks into no result. A capture that fails raises. There the
    trip's linearization and trial cost are K4's and its trust-region
    step K5's (``kernel_of`` of the problem); on the CPU the loop runs ``lm_solve``'s own functions. The
    graphs read the constants that the eager functions hold, so this
    object keeps those functions for as long as it lives."""

    def __init__(self, spec: SkeletonSpec, cam: Camera, cfg: OnlineConfig,
                 n_joints: int, gmm: Optional[GMMPrior] = None, *,
                 n_kp_slots: int = N_KP_SLOTS, device, dtype):
        self.device = _device(device)
        self.dtype = dtype
        self.max_iters = int(cfg.max_iters)
        prob = _online_problem(spec, cam, cfg, n_joints, gmm,
                               device=self.device, dtype=dtype)
        p_dim = frame_param_layout(n_joints)["total"]
        n_s = (0 if spec.joint_shape_reg is None
               else spec.joint_shape_reg.shape[-1])

        def zeros(*size, dt=dtype):
            return torch.zeros(size, dtype=dt, device=self.device)
        self.prev, self.shape = zeros(1, p_dim), zeros(n_s)
        self.kp, self.has_prev = zeros(1, n_kp_slots, 4), zeros(1)
        self.state = LMState(
            x=zeros(1, p_dim), radius=zeros(1), decrease_factor=zeros(1),
            cost=zeros(1), converged=zeros(1, dt=torch.bool),
            n_accepted=zeros(1, dt=torch.int32),
            iters_run=zeros(1, dt=torch.int32))
        inputs = (self.shape, self.kp, self.prev, self.has_prev)
        init, step = lm_program(
            prob.residual_of(*inputs), prob.lm_cfg, prob.lower, prob.upper,
            prob.frozen, *(prob.kernel_of(*inputs) if prob.kernel_of
                           else ()))
        # the eager functions hold every constant the graphs read (bounds,
        # masks, Jacobian blocks, the model's tables): they live as long as
        # this object, or their memory would be reused under the graphs
        self._eager = (lambda: _copy_into(self.state, init(self.prev)),
                       lambda: _copy_into(self.state, step(self.state)))
        self._run_init, self._run_trip = self._eager
        self.trips = 0          # LM trips run (graph replays on the card)
        if self.device.type == "cuda":
            self._capture()

    def _buffers(self):
        return (self.prev, self.shape, self.kp, self.has_prev) + tuple(self.state)

    def _capture(self):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        eager_init, eager_trip = self._eager
        with torch.cuda.stream(side):
            for _ in range(2):
                eager_init()
                eager_trip()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._pool = torch.cuda.graph_pool_handle()

        def captured(fn):
            """fn's graph, and a function that replays it. A kernel wrapper
            counts a launch where it records one: a capture runs none, so
            its counts move to each replay."""
            graph, before = torch.cuda.CUDAGraph(), LAUNCHES.copy()
            with torch.cuda.graph(graph, pool=self._pool):
                fn()
            nodes = LAUNCHES - before
            LAUNCHES.subtract(nodes)

            def replay():
                graph.replay()
                LAUNCHES.update(nodes)
            return graph, replay
        self._g_init, self._run_init = captured(eager_init)
        self._g_trip, self._run_trip = captured(eager_trip)
        for b in self._buffers():
            b.zero_()

    def solve(self) -> int:
        """Fit the frame in ``kp`` from ``prev``: init, then LM trips until
        the problem converges or ``max_iters`` trips have run, reading
        ``converged`` once a trip (after init it is False, so the first
        trip needs no read). The result is in ``state``; returns the trips
        run. Under a profiler: the spans ``online.init``, ``online.trip``
        (each trip's launch) and ``online.wait`` (each read)."""
        with span("online.init"):
            self._run_init()
        trips = 0
        while trips < self.max_iters and (trips == 0 or not self._converged()):
            with span("online.trip"):
                self._run_trip()
            trips += 1
        self.trips += trips
        return trips

    def _converged(self) -> bool:
        """The host's read of ``converged``: it waits for the trip."""
        with span("online.wait"):
            return bool(self.state.converged.all())

    def set_start(self, x0, shape, has_prev) -> None:
        """Load the stream's start: prev <- x0 (P,), the shape, has_prev."""
        def to(a):
            return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)
        self.prev.copy_(to(x0).reshape(self.prev.shape))
        if self.shape.numel():
            self.shape.copy_(to(shape).reshape(self.shape.shape))
        self.has_prev.fill_(float(has_prev))

    def advance(self) -> None:
        """The solved frame becomes the next frame's prev, tether on."""
        self.prev.copy_(self.state.x)
        self.has_prev.fill_(1.0)

    def scan(self, x0, shape, kp_seq, has_prev0):
        """Causal replay over kp_seq (F, K, 4) from x0 (P,): each frame's
        keypoints copied device to device into ``kp`` and solved; a frame
        with no valid keypoint (picked on the host from one copy of the
        (F,) flags) keeps ``prev``, its tether gate unchanged, and reports
        cost 0, iters 0, solved False, conv False. -> (xs (F, P), costs
        (F,), iters (F,) int32, solved (F,) bool, conv (F,) bool), device
        tensors."""
        kp_seq = torch.as_tensor(kp_seq).to(device=self.device,
                                            dtype=self.dtype)
        n = kp_seq.shape[0]
        valid = (torch.sum(kp_seq[:, :, 3], dim=-1) > 0.0).cpu().numpy()
        self.set_start(x0, shape, has_prev0)
        xs = torch.empty((n, self.prev.shape[-1]), dtype=self.dtype,
                         device=self.device)
        costs = torch.zeros(n, dtype=self.dtype, device=self.device)
        iters = torch.zeros(n, dtype=torch.int32, device=self.device)
        conv = torch.zeros(n, dtype=torch.bool, device=self.device)
        for f in range(n):
            if not valid[f]:
                xs[f] = self.prev[0]
                continue
            self.kp.copy_(kp_seq[f:f + 1])
            self.solve()
            xs[f] = self.state.x[0]
            costs[f] = self.state.cost[0]
            iters[f] = self.state.iters_run[0]
            conv[f] = self.state.converged[0]
            self.advance()
        return (xs, costs, iters, torch.as_tensor(valid, device=self.device),
                conv)


def build_online_scan(spec: SkeletonSpec, cam: Camera, cfg: OnlineConfig,
                      n_joints: int, gmm: Optional[GMMPrior] = None, *,
                      device, dtype):
    """Whole-stream causal replay: ``fn(x0 (P,), shape (nS,), kp_seq (F, K,
    4), has_prev0) -> (xs (F, P), costs (F,), iters (F,) int32, solved (F,)
    bool, conv (F,) bool)``, the recursion of driving the step frame by
    frame (warm start and tether to the previous optimum, shape locked,
    empty frames held), run on one :class:`OnlineGraph`
    (:meth:`OnlineGraph.scan`; the graph is ``fn.__self__``)."""
    return OnlineGraph(spec, cam, cfg, n_joints, gmm, device=device,
                       dtype=dtype).scan


class OnlinePump:
    """The request pump: the causal per-frame filter fed one frame at a
    time (``submit``), its state on the device between frames. The
    reference keeps a device loop resident behind ordered ``io_callback``s
    to avoid a dispatch per frame; here each frame is staged through a
    pinned host buffer into an :class:`OnlineGraph` and solved by graph
    replays, with no thread. Same recursion as ``OnlineFitter.step``; an
    empty frame holds the previous pose with ``solved=False``."""

    def __init__(self, spec: SkeletonSpec, cam: Camera, cfg: OnlineConfig,
                 n_joints: int, n_kp_slots: int,
                 gmm: Optional[GMMPrior] = None, *, device, dtype):
        self.n_kp_slots = int(n_kp_slots)
        self._graph = OnlineGraph(spec, cam, cfg, n_joints, gmm,
                                  n_kp_slots=self.n_kp_slots, device=device,
                                  dtype=dtype)
        self._kp_host = torch.empty(
            (1, self.n_kp_slots, 4), dtype=dtype,
            pin_memory=self._graph.device.type == "cuda")
        self._running = False
        self.prev = None
        self.has_prev = 0.0

    def start(self, x0, shape, has_prev: float = 0.0) -> "OnlinePump":
        """Load the stream's state; callable again after :meth:`stop`."""
        self._graph.set_start(x0, shape, has_prev)
        self._running = True
        return self

    def submit(self, kp_dense):
        """Fit one (K, 4) frame. -> (params (P,) np, cost, iters, solved);
        solved=False: no valid keypoint, the pose held. Under a profiler the
        frame is the span ``online.submit``, its copy to the device
        ``online.copy_in`` and the read-back ``online.copy_out``."""
        if not self._running:
            raise RuntimeError("pump not started")
        with span("online.submit"):
            return self._submit(np.asarray(kp_dense))

    def _submit(self, kp):
        g = self._graph
        if float(kp[:, 3].sum()) <= 0.0:
            return g.prev[0].cpu().numpy().copy(), 0.0, 0, False
        with span("online.copy_in"):
            self._kp_host.copy_(torch.from_numpy(np.ascontiguousarray(
                kp, dtype=np.float64)).reshape(self._kp_host.shape))
            g.kp.copy_(self._kp_host, non_blocking=True)
        g.solve()
        with span("online.copy_out"):
            out = torch.cat([g.state.x[0], g.state.cost,
                             g.state.iters_run.to(g.dtype)]).cpu().numpy()
        g.advance()
        return out[:-2], float(out[-2]), int(out[-1]), True

    def stop(self) -> None:
        """End the stream; ``prev`` (P,) np and ``has_prev`` then hold its
        end state. A second call does nothing."""
        if self._running:
            self.prev = self._graph.prev[0].cpu().numpy().copy()
            self.has_prev = float(self._graph.has_prev[0])
            self._running = False


class OnlineFitter:
    """Stateful causal fitter over an incoming keypoint stream.

    >>> fit = OnlineFitter(model, cam, device="cuda")
    >>> fit.calibrate(first_frames_kp)    # optional shared-shape solve
    >>> for kp in stream:                 # kp: (K, 4) dense rows
    ...     params, res = fit.step(kp)

    Empty frames (no valid detections) are skipped on the host: params hold
    at the previous frame, as the reference's skip of an empty frame; the
    pose prior would otherwise drag the held pose toward zero. ``model``
    and ``cam`` are used on ``device`` in ``dtype`` (copied there if they
    live elsewhere)."""

    def __init__(self, model: SMPLModel, cam: Camera,
                 cfg: OnlineConfig = OnlineConfig(),
                 shape: Optional[np.ndarray] = None,
                 gmm_dict: Optional[dict] = None, r0=None, *,
                 device="cuda", dtype=torch.float32):
        self.device = _device(device)
        self.dtype = dtype
        if (model.v_template.device != self.device
                or model.v_template.dtype != dtype):
            model = copy.deepcopy(model).to(device=self.device, dtype=dtype)
        self.model = model
        self.cam = Camera(*(self._t(c) for c in cam))
        self.cfg = cfg
        r0 = init_root_rotation() if r0 is None else r0
        # with_shape=True: the calibrated (constant) shape still moves the
        # rest-pose joints; it is data here, never an unknown
        self.spec = make_skeleton_spec(model, r0, with_shape=True)
        gmm = None
        if gmm_dict is not None and cfg.beta_pose > 0.0:
            gmm = GMMPrior.from_dict(gmm_dict, beta=cfg.beta_pose,
                                     device=self.device, dtype=dtype)
        self._gmm = gmm
        self._scan = None
        self._step = build_online_step(self.spec, self.cam, cfg,
                                       model.num_joints, gmm=gmm,
                                       device=self.device, dtype=dtype)
        self.shape = self._t(np.zeros(model.num_shapes) if shape is None
                             else shape)
        self.prev = init_frame_params(model.num_joints, device=self.device,
                                      dtype=dtype)
        self.has_prev = 0.0
        self.n_seen = 0
        self.last_calib_ms = 0.0   # solve-only wall time of calibrate()

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calibrate(self, kp_frames: np.ndarray, max_iters: int = 100,
                  beta_shape: float = 25.0) -> np.ndarray:
        """Shared-shape fit over a buffered (F, K, 4) batch (the port's
        ``build_multi_fitter`` with the reference's ``MultiFrameConfig``,
        its default ``linear="tridiag"`` included): sets the locked shape,
        seeds the warm start from the last buffered frame and returns the
        buffer's fitted params (F, P). A one-trip run of the same solve
        comes first, so ``last_calib_ms`` times the solve alone."""
        from smpltpu_torch.solve.multi_frame import (
            MultiFrameConfig,
            build_multi_fitter,
        )

        f = int(kp_frames.shape[0])
        cfg1 = MultiFrameConfig(
            beta_pose=self.cfg.beta_pose, beta_shape=beta_shape,
            lambda_temporal=self.cfg.lambda_temporal, max_iters=max_iters)
        n_j, n_s = self.model.num_joints, self.model.num_shapes
        args = (init_frame_params(n_j, device=self.device,
                                  dtype=self.dtype).repeat(f, 1),
                torch.zeros(n_s, dtype=self.dtype, device=self.device),
                self._t(kp_frames), self.spec.r0.repeat(f, 1, 1))

        def fitter(iters):
            return build_multi_fitter(self.spec, self.cam,
                                      cfg1._replace(max_iters=iters), n_s,
                                      device=self.device, dtype=self.dtype)
        fitter(1)(*args)
        self._sync()
        t0 = time.perf_counter()
        st = fitter(max_iters)(*args)
        self._sync()
        self.last_calib_ms = (time.perf_counter() - t0) * 1e3
        self.shape = st.shape
        self.prev = st.params[-1]
        self.has_prev = 1.0
        self.n_seen += f
        return st.params.cpu().numpy()

    def replay(self, kp_frames: np.ndarray):
        """Causal whole-sequence fit (:func:`build_online_scan`): the
        recursion of calling :meth:`step` per frame, on the trip graph.
        Advances the state to the end of the sequence (prev the last row,
        has_prev 1 if some frame was solved). -> (params (F, P), solved
        (F,) bool, costs (F,), iters (F,), converged (F,) bool) as numpy;
        an empty frame holds the previous pose, converged False."""
        if self._scan is None:
            self._scan = build_online_scan(
                self.spec, self.cam, self.cfg, self.model.num_joints,
                gmm=self._gmm, device=self.device, dtype=self.dtype)
        xs, costs, iters, solved, conv = self._scan(
            self.prev, self.shape, kp_frames, self.has_prev)
        solved_np = solved.cpu().numpy()
        n = int(kp_frames.shape[0])
        self.n_seen += n
        if n:
            self.prev = xs[-1]
            if solved_np.any():
                self.has_prev = 1.0
        return (xs.cpu().numpy(), solved_np, costs.cpu().numpy(),
                iters.cpu().numpy(), conv.cpu().numpy())

    def make_pump(self, n_kp_slots: Optional[int] = None) -> OnlinePump:
        """A request pump running the same recursion as :meth:`step`, on a
        trip graph of its own; seed it with ``pump.start(fit.prev,
        fit.shape, fit.has_prev)``."""
        return OnlinePump(self.spec, self.cam, self.cfg,
                          self.model.num_joints,
                          N_KP_SLOTS if n_kp_slots is None else n_kp_slots,
                          gmm=self._gmm, device=self.device, dtype=self.dtype)

    def step(self, kp_dense: np.ndarray):
        """Fit one frame by the eager ``lm_solve`` (the per-dispatch path).
        -> (params (P,) np, LMResult of one problem, or None when the frame
        had no valid keypoint and the pose held)."""
        kp = np.asarray(kp_dense)
        self.n_seen += 1
        if float(kp[:, 3].sum()) <= 0.0:
            return self.prev.cpu().numpy().copy(), None
        prev = self.prev[None]
        res = self._step(prev, self.shape, kp[None], prev,
                         torch.full((1,), self.has_prev, dtype=self.dtype,
                                    device=self.device))
        self.prev = res.x[0]
        self.has_prev = 1.0
        return res.x[0].cpu().numpy(), res
