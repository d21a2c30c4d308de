"""The plain versions of K1 (arrowhead PCG) and K2 (blendshapes + LBS)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as the reference's own tests run them, and the wrappers' routing: a CPU
tensor takes the plain version, any other non-CUDA tensor is refused. The
CUDA kernels themselves are checked against these plain versions on the
card by chip_smoke.py."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smpltpu.models import SMPLModel as JModel
from smpltpu.models import rodrigues as j_rodrigues
from smpltpu.models import smpl_forward as j_forward
from smpltpu.ops.cg import arrow_pcg_pallas
from smpltpu.ops.lbs import joint_affines as j_joint_affines
from smpltpu.ops.lbs import lbs_pallas
from smpltpu.ops.lbs import prepare_lbs_operands as j_prepare
from smpltpu_torch import _build
from smpltpu_torch.models import SMPLModel, smpl_forward
from smpltpu_torch.ops import LAUNCHES, cg, lbs

CPU = torch.device("cpu")
F, P, NS = 6, 76, 10


def _system(rng, scale=1.0, f=F):
    """Random SPD arrowhead system in the solver's block layout (float32,
    the layout of tests/test_cg_kernel.py); past F = 6 frames B shrinks by
    sqrt(6/F), so the shape Schur complement stays as far from singular."""
    a = rng.normal(size=(f, P, P)).astype(np.float32) * 0.1
    d = np.einsum("fab,fcb->fac", a, a) + 2.0 * np.eye(P, dtype=np.float32)
    off = (-np.abs(rng.normal(size=f - 1)) * 0.05 * scale).astype(np.float32)
    tm = np.ones(P, np.float32)
    tm[0] = 0.0
    b = rng.normal(size=(f, P, NS)).astype(np.float32) * 0.05
    if f > F:
        b = b * np.float32(np.sqrt(F / f))
    cw = rng.normal(size=(NS, NS)).astype(np.float32) * 0.1
    c = cw @ cw.T + 1.5 * np.eye(NS, dtype=np.float32)
    gp = rng.normal(size=(f, P)).astype(np.float32)
    gw = rng.normal(size=NS).astype(np.float32)
    return d, off, tm, b, c, gp, gw


def _batch(systems):
    """Stack per-window systems into the port's (W, ...) layout; tmask is
    shared."""
    cols = [np.stack([s[i] for s in systems]) for i in range(7)]
    cols[2] = systems[0][2]
    return [torch.as_tensor(c) for c in cols]


def _assert_pcg_close(got_p, got_w, want_p, want_w):
    """tests/test_cg_kernel.py's tolerance: 2e-4 of the solution's scale,
    f32 with a different reduction order."""
    want_p, want_w = np.asarray(want_p), np.asarray(want_w)
    np.testing.assert_allclose(got_p, want_p, atol=2e-4 * np.max(np.abs(want_p)),
                               rtol=2e-4)
    np.testing.assert_allclose(got_w, want_w,
                               atol=2e-4 * max(np.max(np.abs(want_w)), 1.0),
                               rtol=2e-4)


@pytest.mark.parametrize("rtol,iters,f,n_win", [
    pytest.param(0.0, 32, F, 3, id="0.0-32"),
    pytest.param(0.2, 24, F, 3, id="0.2-24"),
    pytest.param(1e-12, 16, F, 3, id="1e-12-16"),
    # the stage-1 shape (one window of 100 frames) that K1's cluster
    # layout targets
    pytest.param(0.0, 6, 100, 1, id="stage1-f100-6"),
])
def test_pcg_plain_matches_pallas_kernel(rtol, iters, f, n_win):
    """Windows of different coupling strength through the plain batched
    PCG, against the Pallas kernel window by window (fixed trip count, a
    loose tolerance exit, one that never fires, and the stage-1 shape)."""
    rng = np.random.default_rng(11)
    systems = [_system(rng, scale=float(k + 1), f=f) for k in range(n_win)]
    got_p, got_w = cg.arrow_pcg_torch(*_batch(systems), iters=iters, rtol=rtol)
    assert got_p.dtype == torch.float32
    for k, s in enumerate(systems):
        want_p, want_w = arrow_pcg_pallas(*map(jnp.asarray, s), iters=iters,
                                          interpret=True, rtol=rtol)
        _assert_pcg_close(got_p[k].numpy(), got_w[k].numpy(), want_p, want_w)


def test_pcg_rtol_exit_is_per_window():
    """With rtol, a window's iterate does not depend on the batch it is
    solved in (each window stops on its own residual, as under vmap of
    the reference loop). f64, so batch-dependent summation order stays at
    rounding level (1e-12)."""
    rng = np.random.default_rng(12)
    systems = [_system(rng, scale=float(k + 1)) for k in range(3)]

    def run(group):
        return cg.arrow_pcg_torch(*(a.double() for a in _batch(group)),
                                  iters=24, rtol=0.2)
    both_p, both_w = run(systems)
    for k, s in enumerate(systems):
        one_p, one_w = run([s])
        np.testing.assert_allclose(both_p[k].numpy(), one_p[0].numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(both_w[k].numpy(), one_w[0].numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_pcg_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    rng = np.random.default_rng(13)
    args = _batch([_system(rng)])
    before = LAUNCHES["arrow_pcg"]
    got = cg.arrow_pcg(*args, iters=8)
    want = cg.arrow_pcg_torch(*args, iters=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert LAUNCHES["arrow_pcg"] == before      # no kernel launch on the CPU
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cg.arrow_pcg(*(a.to("meta") for a in args), iters=8)


@pytest.fixture(scope="module")
def skin_case(small_model_dict):
    rng = np.random.default_rng(21)
    b = 3
    shapes = (0.4 * rng.normal(size=(b, 10))).astype(np.float32)
    rots = np.array(j_rodrigues(jnp.asarray(
        (0.3 * rng.normal(size=(b, 24, 3))).astype(np.float32))))
    pos = (rng.normal(size=(b, 3)) + [0.0, 0.0, 3.0]).astype(np.float32)
    return small_model_dict, shapes, rots, pos


def test_lbs_plain_matches_pallas_kernel_and_forward(skin_case):
    """f32: against lbs_pallas in interpret mode with its lane padding cut
    off (1e-5 on metre-scale vertices: the same sums, f32 rounding), and
    in f64 against the port's own smpl_forward vertices."""
    model_dict, shapes, rots, pos = skin_case
    jm = JModel.from_dict(model_dict, dtype=jnp.float32)
    n_v = jm.num_verts
    g, _ = jax.vmap(lambda w, r, p: j_joint_affines(jm, w, r, p))(
        jnp.asarray(shapes), jnp.asarray(rots), jnp.asarray(pos))
    want = np.asarray(lbs_pallas(jnp.asarray(shapes), g, j_prepare(jm),
                                 tile=128, interpret=True))[:, :, :n_v]
    tm32 = SMPLModel.from_dict(model_dict, device=CPU, dtype=torch.float32)
    got = lbs.lbs(torch.as_tensor(shapes), torch.as_tensor(np.array(g)),
                  lbs.prepare_lbs_operands(tm32))
    assert tuple(got.shape) == (3, 3, n_v)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    tm = SMPLModel.from_dict(model_dict, device=CPU, dtype=torch.float64)
    w64, r64, p64 = (torch.as_tensor(a, dtype=torch.float64)
                     for a in (shapes, rots, pos))
    g64, joints = lbs.joint_affines(tm, w64, r64, p64)
    verts = lbs.lbs_torch(w64, g64, lbs.prepare_lbs_operands(tm))
    ref = smpl_forward(tm, w64, r64, p64)
    np.testing.assert_allclose(verts.transpose(1, 2).numpy(),
                               ref["verts"].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(joints.numpy(), ref["joints"].numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("b", [1, 37])
def test_lbs_plain_matches_pallas_kernel_at_other_batches(small_model_dict, b):
    """One frame, and 37 (which no frame tile of the CUDA kernel divides):
    ``lbs_torch`` against ``lbs_pallas`` in interpret mode, 1e-5 on
    metre-scale vertices (the same sums, f32 rounding)."""
    rng = np.random.default_rng(30 + b)
    shapes = (0.4 * rng.normal(size=(b, 10))).astype(np.float32)
    rots = np.array(j_rodrigues(jnp.asarray(
        (0.3 * rng.normal(size=(b, 24, 3))).astype(np.float32))))
    pos = (rng.normal(size=(b, 3)) + [0.0, 0.0, 3.0]).astype(np.float32)
    jm = JModel.from_dict(small_model_dict, dtype=jnp.float32)
    g, _ = jax.vmap(lambda w, r, p: j_joint_affines(jm, w, r, p))(
        jnp.asarray(shapes), jnp.asarray(rots), jnp.asarray(pos))
    want = np.asarray(lbs_pallas(jnp.asarray(shapes), g, j_prepare(jm),
                                 tile=128, interpret=True))[:, :, :jm.num_verts]
    tm = SMPLModel.from_dict(small_model_dict, device=CPU, dtype=torch.float32)
    got = lbs.lbs(torch.as_tensor(shapes), torch.as_tensor(np.array(g)),
                  lbs.prepare_lbs_operands(tm))
    assert tuple(got.shape) == (b, 3, jm.num_verts)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", sorted(_build._SIGNATURES))
def test_ctypes_signatures_match_the_kernel_sources(entry):
    """Each C entry point is declared once in the sources, with as many
    parameters as its ctypes signature has, pointers (and the stream) as
    ``c_void_p``."""
    csrc = Path(lbs.__file__).resolve().parents[1] / "csrc"
    text = "".join((csrc / name).read_text() for name in _build.SOURCES)
    found = re.findall(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert len(found) == 1
    params = [p.strip() for p in found[0].split(",")]
    res, args = _build._SIGNATURES[entry]
    assert res is ctypes.c_int and len(args) == len(params)
    for param, arg in zip(params, args):
        assert ("*" in param) == (arg is ctypes.c_void_p), (param, arg)


def test_joint_affines_match_jax(skin_case):
    """f64, 1e-12: identical O(nJ) FK up to summation order."""
    model_dict, shapes, rots, pos = skin_case
    jm = JModel.from_dict(model_dict, dtype=jnp.float64)
    tm = SMPLModel.from_dict(model_dict, device=CPU, dtype=torch.float64)
    args = [a.astype(np.float64) for a in (shapes, rots, pos)]
    got = lbs.joint_affines(tm, *map(torch.as_tensor, args))
    want = jax.vmap(lambda w, r, p: j_joint_affines(jm, w, r, p))(
        *map(jnp.asarray, args))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    # and the reference forward's vertices through the JAX einsum path
    verts = lbs.lbs(torch.as_tensor(args[0]), got[0],
                    lbs.prepare_lbs_operands(tm))
    ref = jax.vmap(lambda w, r, p: j_forward(jm, w, r, p)["verts"])(
        *map(jnp.asarray, args))
    np.testing.assert_allclose(verts.transpose(1, 2).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-12)


def test_lbs_wrapper_routes_cpu_to_plain_and_refuses_other_devices(skin_case):
    model_dict, shapes, rots, pos = skin_case
    tm = SMPLModel.from_dict(model_dict, device=CPU, dtype=torch.float32)
    ops = lbs.prepare_lbs_operands(tm)
    g, _ = lbs.joint_affines(tm, torch.as_tensor(shapes), torch.as_tensor(rots),
                             torch.as_tensor(pos))
    before = LAUNCHES["lbs"]
    torch.testing.assert_close(lbs.lbs(torch.as_tensor(shapes), g, ops),
                               lbs.lbs_torch(torch.as_tensor(shapes), g, ops),
                               rtol=0, atol=0)
    assert LAUNCHES["lbs"] == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lbs.lbs(torch.as_tensor(shapes).to("meta"), g.to("meta"), ops)
