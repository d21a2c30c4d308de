"""K4, the online trip's linearization kernel (``smpltpu_torch/ops/online.py``,
``csrc/online_normal.cu``), and the seam through which ``lm_program`` takes
it.

On the CPU:
  * the kernel's constant tables against the eager spec they pack
    (parents, the joints by tree depth, the strict-ancestor bits against
    ``energy/jacobian.py::_strict_ancestor_mask``, ``jsr_off``, R0, the bone
    offsets, the tether and free masks, the scalars);
  * ``online_normal`` refuses tensors off the card (K4 has no CPU build:
    there the online problem keeps the eager composition);
  * ``lm_program`` through the seam, given the plain linearization
    explicitly and by default, computes the very states ``lm_solve``
    computed before the seam existed, bit for bit (recorded in
    ``tests/data/online_seam_ref.npz`` by ``python -m
    tests.test_torch_online_kernel --record`` on the tree before the seam).

On a CUDA card (marker ``card``, skipped elsewhere; this file imports no
JAX, so ``python -m pytest tests/test_torch_online_kernel.py -m card
--noconftest`` runs it there):
  * K4 in float64 against the eager composition it is held to
    (``solve/lm.py::plain_linearization`` of ``solve/online.py``'s
    residual) on a 300-vertex model: a first and a tethered frame, a free
    scale, a slot not visible, a slot at the z guard, Huber outliers, the
    GMM prior;
  * ``chip_smoke.py::online_kernel_cases`` at the stream configuration's
    widths, every case within its tolerance of the eager float32 and
    float64 compositions, one frame the same on the trip graph with K4 and
    with the eager composition in float64, and bitwise the same over 100
    replays of the trip graph.
"""

import os
import sys

import numpy as np
import pytest
import torch

from smpltpu_torch.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu_torch.energy.priors import GMMPrior
from smpltpu_torch.energy.reproj import make_skeleton_spec, project, skeleton_joints_cam
from smpltpu_torch.models import SMPLModel, make_synthetic_gmm
from smpltpu_torch.models.synthetic import make_synthetic_model
from smpltpu_torch.solve import online as t_online
from smpltpu_torch.solve.lm import LMState
from smpltpu_torch.utils import default_intrinsics

F64 = torch.float64
CFG = dict(beta_pose=5.0, lambda_temporal=3.0, max_iters=20)
SEAM_REF = os.path.join(os.path.dirname(__file__), "data", "online_seam_ref.npz")
SEAM_CASES = {"frozen": dict(freeze_scale=True), "gmm": dict(freeze_scale=True),
              "free_scale": dict(freeze_scale=False)}
PLAIN_TOL = 1e-11              # float64: the two sum in other orders


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rig(device="cpu"):
    """A 300-vertex synthetic model in float64 on ``device``, its skeleton
    (shape-aware), the 720 x 1280 camera, a shape, four poses and their
    keypoints (1 px noise), and the GMM prior."""
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=300, n_shapes=10, seed=0),
                                device=device, dtype=F64)
    spec = make_skeleton_spec(model, init_root_rotation(), True)
    cam = default_intrinsics(720, 1280, device=device, dtype=F64)
    rng = np.random.default_rng(17)
    gt = np.zeros((4, 76))
    gt[:, 0] = 1.0
    gt[:, 1:4] = 0.2 * rng.normal(size=(4, 3))
    gt[:, 4:7] = [0.1, -0.1, 3.2]
    gt[:, 7:] = 0.3 * rng.normal(size=(4, 69))
    shape = 0.3 * rng.normal(size=10)
    uv = project(skeleton_joints_cam(torch.as_tensor(gt, device=device),
                                     torch.as_tensor(shape, device=device), spec),
                 cam).cpu().numpy()
    kp = np.zeros((4, N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(size=(4, N_KP_SLOTS, 2))
    kp[:, :, 3] = 1.0
    gmm = GMMPrior.from_dict(make_synthetic_gmm(n_comps=8, dim=69, seed=0), beta=5.0,
                             device=device, dtype=F64)
    return dict(spec=spec, cam=cam, gt=gt, shape=shape, kp=kp, gmm=gmm, device=device)


@pytest.fixture(scope="module")
def rig():
    return _rig()


def _seam_states(rig):
    """{case: the LMResult of ``lm_solve`` on a tethered frame}, float64."""
    out = {}
    for case, kw in SEAM_CASES.items():
        cfg = t_online.OnlineConfig(**dict(CFG, **kw))
        step = t_online.build_online_step(rig["spec"], rig["cam"], cfg, 24,
                                          rig["gmm"] if case == "gmm" else None,
                                          device="cpu", dtype=F64)
        prev = torch.as_tensor(rig["gt"][1:2] + 0.03)
        out[case] = step(prev, rig["shape"], rig["kp"][2:3], prev,
                         torch.ones(1, dtype=F64))
    return out


def record(path=SEAM_REF):
    res = _seam_states(_rig())
    np.savez(path, **{f"{case}.{name}": getattr(r, name).numpy()
                      for case, r in res.items() for name in r._fields})
    print(f"wrote {path}")


def _problem(rig, case, gmm=False, **kw):
    cfg = t_online.OnlineConfig(**dict(CFG, **kw))
    return cfg, t_online._online_problem(rig["spec"], rig["cam"], cfg, 24,
                                         rig["gmm"] if gmm else None,
                                         device=rig["device"], dtype=F64)


def _unpack(tab):
    """The tables' parts by name, as ``csrc/online_normal.cu`` reads them."""
    from smpltpu_torch.energy.params import frame_param_layout
    from smpltpu_torch.ops.online import N_SCALARS

    n_j, n_s, n_l = tab.n_joints, tab.n_shapes, tab.n_levels
    p_dim = frame_param_layout(n_j)["total"]
    ints = tab.ints.tolist()
    sizes = {"scal": N_SCALARS, "r0": 9, "base": 3 * n_j,
             "jsr_off": 3 * n_j * n_s, "tmask": p_dim, "free": p_dim}
    assert tab.reals.numel() == sum(sizes.values())
    parts = dict(zip(sizes, torch.split(tab.reals, list(sizes.values()))))
    parts.update(parents=ints[:n_j], order=ints[n_j:2 * n_j],
                 starts=ints[2 * n_j:2 * n_j + n_l + 2],
                 anc=ints[2 * n_j + n_l + 2:])
    assert len(parts["anc"]) == n_j
    return parts


def test_tables_hold_the_eager_spec(rig):
    from smpltpu_torch.energy.jacobian import _strict_ancestor_mask
    from smpltpu_torch.energy.temporal import temporal_mask
    from smpltpu_torch.ops.online import online_tables, tree_tables

    spec = rig["spec"]
    _, prob = _problem(rig, "frozen")
    tab = online_tables(spec, rig["cam"], prob.frozen, 5.0, 3.0, 3.0,
                        device="cpu", dtype=F64)
    t = _unpack(tab)
    parents = np.asarray(spec.parents)
    assert t["parents"] == parents.tolist()
    depth = tree_tables(parents)["depth"]
    order, starts = t["order"], t["starts"]
    assert sorted(order) == list(range(24)) and starts[0] == 0 and starts[-1] == 24
    assert tab.n_levels == depth.max() == len(starts) - 2
    for d in range(tab.n_levels + 1):
        assert all(depth[j] == d for j in order[starts[d]:starts[d + 1]])
    # every joint after its parent in the order: the FK reads finished rows
    pos = {j: i for i, j in enumerate(order)}
    assert all(pos[parents[j]] < pos[j] for j in range(1, 24))
    bits = np.asarray(t["anc"], np.int64) & 0xFFFFFFFF
    anc = (bits[:, None] >> np.arange(1, 24)) & 1
    np.testing.assert_array_equal(anc.astype(bool), _strict_ancestor_mask(parents))
    jsr = spec.joint_shape_reg
    jsr_off = jsr - torch.where(torch.as_tensor(parents >= 0)[:, None, None],
                                jsr[np.maximum(parents, 0)], torch.zeros_like(jsr))
    assert torch.equal(t["jsr_off"].reshape(24, 3, 10), jsr_off)
    assert torch.equal(t["base"].reshape(24, 3), spec.base_offsets)
    assert torch.equal(t["r0"].reshape(3, 3), spec.r0)
    assert torch.equal(t["tmask"], temporal_mask(24, device="cpu", dtype=F64))
    assert torch.equal(t["free"], (~prob.frozen).to(F64))
    assert t["free"][0] == 0 and t["free"][1:7].all()
    for j in (10, 11, 22, 23):
        assert not t["free"][7 + 3 * (j - 1):7 + 3 * j].any()
    assert t["scal"][:7].tolist() == [float(c) for c in rig["cam"]] + [5.0, 3.0, 3.0]


def test_tree_tables_refuse_what_the_kernel_cannot_walk():
    from smpltpu_torch.ops.online import tree_tables
    with pytest.raises(ValueError):
        tree_tables([-1, 2, 0])               # a parent after its child
    with pytest.raises(ValueError):
        tree_tables([-1] + list(range(32)))   # 33 joints
    assert tree_tables([-1, 0, 0, 1])["anc"].tolist() == [0, 1, 1, 3]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU build")
    return torch.device("cuda", 0)


def test_kernel_refuses_tensors_off_the_card(rig):
    """K4 has no CPU build: ``online_normal`` says so for CPU tensors."""
    from smpltpu_torch.ops.online import online_normal, online_tables

    _, prob = _problem(rig, "frozen")
    tab = online_tables(rig["spec"], rig["cam"], prob.frozen, 5.0, 3.0, 3.0,
                        device="cpu", dtype=F64)
    x = torch.as_tensor(rig["gt"][1:2])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        online_normal(tab, x, x, torch.ones(1, dtype=F64), torch.as_tensor(rig["shape"]),
                      torch.as_tensor(rig["kp"][1:2]))
    assert prob.kernel_of is None


PLAIN_CASES = {
    "first": dict(has_prev=0.0),
    "tethered": dict(has_prev=1.0),
    "free_scale": dict(has_prev=1.0, freeze_scale=False),
    "invisible": dict(has_prev=1.0, hide=3),
    "outliers": dict(has_prev=1.0, outliers=40.0),
    "z_guard": dict(has_prev=1.0, z_guard=True),
    "gmm": dict(has_prev=1.0, gmm=True),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_kernel_equals_the_eager_composition(card, case):
    """K4 in float64, from the packed tables, against
    ``plain_linearization`` of the online residual on the card: g, H and
    the cost at a pose off the optimum, and the cost alone at the trial
    pose."""
    from smpltpu_torch.ops.online import online_normal, online_tables
    from smpltpu_torch.solve.lm import plain_linearization

    rig = _rig(card)
    dev = card
    kw = dict(PLAIN_CASES[case])
    has_prev = kw.pop("has_prev")
    hide, outliers = kw.pop("hide", None), kw.pop("outliers", 0.0)
    z_guard, gmm = kw.pop("z_guard", False), kw.pop("gmm", False)
    cfg, prob = _problem(rig, case, gmm=gmm, **kw)
    rng = np.random.default_rng(7)
    shape = torch.as_tensor(rig["shape"], device=dev)
    kp = rig["kp"][1:2].copy()
    x = rig["gt"][1:2] + 0.05 * rng.normal(size=(1, 76))
    x[:, 0] = 1.1
    prev = torch.as_tensor(rig["gt"][1:2] + 0.02 * rng.normal(size=(1, 76)), device=dev)
    if hide is not None:
        kp[0, hide, 1:3], kp[0, hide, 3] = 1e4, 0.0
    kp[0, :, 1:3] += outliers * rng.normal(size=(N_KP_SLOTS, 2))
    if z_guard:
        # slot 15 on the root joint, which sits at t with no shape: z = 5e-9
        shape = torch.zeros(10, dtype=F64, device=dev)
        kp[0, 15, 0] = 0.0
        x[0, 4:7] = [0.1, -0.1, 5e-9]
    x, kp = torch.as_tensor(x, device=dev), torch.as_tensor(kp, device=dev)
    has = torch.full((1,), has_prev, dtype=F64, device=dev)
    lin, cost = plain_linearization(prob.residual_of(shape, kp, prev, has),
                                    cfg.huber_delta, prob.frozen)
    g0, h0 = lin(x)
    tab = online_tables(rig["spec"], rig["cam"], prob.frozen, 0.0 if gmm else 5.0,
                        3.0, 3.0, device=dev, dtype=F64)
    g1, h1, c1 = online_normal(tab, x, prev, has, shape, kp)
    x_new = x + 0.01 * torch.as_tensor(rng.normal(size=(1, 76)), device=dev)
    c_new = online_normal(tab, x_new, prev, has, shape, kp, jacobian=False)
    if gmm:
        from smpltpu_torch.energy.priors import gmm_pose_prior_residual_and_jacobian
        for xi, ci in ((x, c1), (x_new, c_new)):
            r, _ = gmm_pose_prior_residual_and_jacobian(xi[:, 7:], rig["gmm"])
            ci += 0.5 * torch.sum(r * r, -1)
        r, j = gmm_pose_prior_residual_and_jacobian(x[:, 7:], rig["gmm"])
        j = torch.nn.functional.pad(j, (7, 0)) * (~prob.frozen).to(F64)
        g1 = g1 + (j.transpose(1, 2) @ r[..., None])[..., 0]
        h1 = h1 + j.transpose(1, 2) @ j
    for got, want in ((g1, g0), (h1, h0), (c1, cost(x)), (c_new, cost(x_new))):
        assert float((got - want).abs().max()) <= PLAIN_TOL * float(want.abs().max())
    frozen = prob.frozen
    assert not g1[:, frozen].any() and not h1[:, frozen].any()
    assert not h1[:, :, frozen].any()
    assert torch.equal(h1, h1.transpose(1, 2))
    if z_guard:
        assert float(h0.abs().max()) > 1e11        # the guard's branch ran (~1e7 off it)


@pytest.mark.parametrize("case", sorted(SEAM_CASES))
def test_seam_computes_what_lm_solve_computed_before_it(rig, case):
    """``lm_solve`` (the default pair) and ``lm_program`` given
    ``plain_linearization`` explicitly, driven trip by trip: both the
    recorded pre-seam state, bit for bit."""
    from smpltpu_torch.solve.lm import lm_program, plain_linearization

    with np.load(SEAM_REF) as ref:
        want = {k: ref[k] for k in ref.files if k.startswith(case + ".")}
    got = _seam_states(rig)[case]
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[f"{case}.{name}"])
    cfg, prob = _problem(rig, case, gmm=case == "gmm", **SEAM_CASES[case])
    prev = torch.as_tensor(rig["gt"][1:2] + 0.03)
    fn = prob.residual_of(torch.as_tensor(rig["shape"]), torch.as_tensor(rig["kp"][2:3]),
                          prev, torch.ones(1, dtype=F64))
    init, step = lm_program(fn, prob.lm_cfg, prob.lower, prob.upper, prob.frozen,
                            *plain_linearization(fn, cfg.huber_delta, prob.frozen))
    state = init(prev)
    while not bool(state.converged.all()) and int(state.iters_run[0]) < cfg.max_iters:
        state = step(state)
    for name in LMState._fields:
        np.testing.assert_array_equal(getattr(state, name).numpy(), want[f"{case}.{name}"])
    assert int(state.iters_run[0]) > 2


@pytest.mark.parametrize("case", sorted(SEAM_CASES))
@pytest.mark.parametrize("step_fn", ["chol_tr_step", "tr_step"])
def test_seam_takes_the_trust_region_step(rig, case, step_fn):
    """``lm_program`` given ``chol_tr_step`` as its trust-region step, or
    K5's wrapper (``chol_tr_step`` itself on the CPU), with and without the
    plain linearization: the recorded pre-seam state, bit for bit, as the
    default computes it."""
    from smpltpu_torch.ops.trust_region import tr_step
    from smpltpu_torch.solve.lm import chol_tr_step, lm_program, plain_linearization

    with np.load(SEAM_REF) as ref:
        want = {k: ref[k] for k in ref.files if k.startswith(case + ".")}
    cfg, prob = _problem(rig, case, gmm=case == "gmm", **SEAM_CASES[case])
    prev = torch.as_tensor(rig["gt"][1:2] + 0.03)
    fn = prob.residual_of(torch.as_tensor(rig["shape"]), torch.as_tensor(rig["kp"][2:3]),
                          prev, torch.ones(1, dtype=F64))
    fn_step = {"chol_tr_step": chol_tr_step, "tr_step": tr_step}[step_fn]
    for lin in ((None, None), plain_linearization(fn, cfg.huber_delta, prob.frozen)):
        init, step = lm_program(fn, prob.lm_cfg, prob.lower, prob.upper, prob.frozen,
                                *lin, tr_step=fn_step)
        state = init(prev)
        while (not bool(state.converged.all())
               and int(state.iters_run[0]) < cfg.max_iters):
            state = step(state)
        for name in LMState._fields:
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          want[f"{case}.{name}"])


@pytest.mark.card
def test_kernel_on_the_card(card):
    """K4 within ``chip_smoke.py``'s tolerances of the eager float32 and
    float64 compositions in every case, frozen columns exactly zero, and a
    frame solved 100 times on the trip graph bitwise the same."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    res = chip_smoke.online_kernel_cases(card)
    assert res["failed"] == [], res["failed"]
    assert res["replays_bitwise"] and res["replays"] == chip_smoke.ONLINE_KERNEL_REPLAYS


if __name__ == "__main__":
    if sys.argv[1:] == ["--record"]:
        record()
    else:
        raise SystemExit("usage: python -m tests.test_torch_online_kernel --record")
