"""K5, the online LM trip's trust-region step kernel
(``smpltpu_torch/ops/trust_region.py``, ``csrc/tr_step.cu``).

On the CPU:
  * ``tr_step`` is ``solve/lm.py::chol_tr_step`` itself on CPU tensors,
    bit for bit, on every system of ``chip_smoke.py::tr_step_systems``,
    and launches nothing;
  * it refuses a device with no kernel;
  * its bound on P is the kernel's (``kMaxP`` in the source).

On a CUDA card (marker ``card``, skipped elsewhere; this file imports no
JAX, so ``python -m pytest tests/test_torch_tr_step.py -m card
--noconftest`` runs it there), K5 against ``chol_tr_step`` on the card:
  * in float64 within ``TR_STEP_TOL`` (1e-12 of scale) on each system: a
    Gauss-Newton step interior at the floor shift, a boundary step that
    takes all four Newton trips, a badly scaled h (condition ~1e12), an h
    that no shift of four trips factorizes (NaN throughout, as the eager
    step) and one whose third trip does, pinned frozen dims (their step
    exactly 0); the NaNs and the boundary flags the same;
  * N = 4 with the systems mixed, each problem bitwise its own launch's;
  * in float32 within ``TR_STEP_TOL["float32"]``;
  * one launch captured into a CUDA graph and replayed on other inputs,
    bitwise the eager launch's; ``chip_smoke.py::tr_step_cases`` whole.
"""

import os
import re
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 4


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 runs only on the card")
    return torch.device("cuda", 0)


CASES = ("interior", "boundary", "ill_conditioned", "not_pd",
         "not_pd_recovers", "frozen")


@pytest.mark.parametrize("case", CASES)
def test_wrapper_is_chol_tr_step_on_the_cpu(smoke, case):
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.ops.trust_region import tr_step
    from smpltpu_torch.solve.lm import chol_tr_step

    assert smoke.TR_STEP_CASES == CASES
    h, g, r = smoke.tr_step_systems(torch.float64, "cpu")[case]
    before = LAUNCHES["tr_step"]
    got, want = tr_step(h, g, r, ITERS), chol_tr_step(h, g, r, ITERS)
    assert LAUNCHES["tr_step"] == before
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    assert torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(want[0]))


def test_systems_are_the_cases_they_are_named_for(smoke):
    """On the CPU, chol_tr_step of each system does what its name says."""
    from smpltpu_torch.solve.lm import chol_tr_step

    sy = smoke.tr_step_systems(torch.float64, "cpu")
    res = {c: chol_tr_step(*sy[c], ITERS) for c in CASES}
    assert not res["interior"][1].any()
    for c in ("boundary", "ill_conditioned", "frozen", "not_pd_recovers"):
        assert res[c][1].all() and torch.isfinite(res[c][0]).all(), c
    assert torch.isnan(res["not_pd"][0]).all()
    # the floor shift fails to factorize not_pd_recovers
    h, g, r = sy["not_pd_recovers"]
    assert torch.isnan(chol_tr_step(h, g, r, 1)[0]).all()
    assert not res["frozen"][0][:, smoke.TR_STEP_FROZEN].any()


def test_wrapper_refuses_a_device_with_no_kernel(smoke):
    from smpltpu_torch.ops.trust_region import tr_step

    h, g, r = (t.to("meta") for t in smoke.tr_step_systems(
        torch.float64, "cpu")["interior"])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tr_step(h, g, r, ITERS)


def test_bound_on_p_is_the_kernels():
    from smpltpu_torch.ops.trust_region import MAX_P

    src = open(os.path.join(REPO, "smpltpu_torch", "csrc", "tr_step.cu")).read()
    assert int(re.search(r"constexpr int kMaxP = (\d+);", src).group(1)) == MAX_P
    assert MAX_P >= 94          # SMPL-X's whole-body frame vector


def _apart(smoke, got, want):
    rel, nan_same, flags_same = smoke.tr_step_apart(got, want)
    assert nan_same and flags_same
    return rel


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_k5_equals_chol_tr_step_in_float64(smoke, card, case):
    from smpltpu_torch.ops.trust_region import tr_step
    from smpltpu_torch.solve.lm import chol_tr_step

    h, g, r = smoke.tr_step_systems(torch.float64, card)[case]
    got, want = tr_step(h, g, r, ITERS), chol_tr_step(h, g, r, ITERS)
    assert _apart(smoke, got, want) <= smoke.TR_STEP_TOL["float64"]
    if case == "frozen":
        assert not got[0][:, smoke.TR_STEP_FROZEN].any()
    if case == "not_pd":
        assert torch.isnan(got[0]).all()


@pytest.mark.card
def test_k5_batch_of_four_mixed(smoke, card):
    from smpltpu_torch.ops.trust_region import tr_step
    from smpltpu_torch.solve.lm import chol_tr_step

    sy = smoke.tr_step_systems(torch.float64, card)
    mix = ("interior", "boundary", "ill_conditioned", "frozen")
    h, g, r = (torch.cat([sy[c][k] for c in mix]) for k in range(3))
    got = tr_step(h, g, r, ITERS)
    assert got[1].tolist() == [False, True, True, True]
    assert _apart(smoke, got, chol_tr_step(h, g, r, ITERS)) <= \
        smoke.TR_STEP_TOL["float64"]
    for i, c in enumerate(mix):
        one = tr_step(*sy[c], ITERS)
        assert torch.equal(got[0][i:i + 1], one[0]) and torch.equal(got[1][i:i + 1], one[1])


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_k5_in_float32(smoke, card, case):
    from smpltpu_torch.ops.trust_region import tr_step
    from smpltpu_torch.solve.lm import chol_tr_step

    h, g, r = smoke.tr_step_systems(torch.float32, card)[case]
    got, want = tr_step(h, g, r, ITERS), chol_tr_step(h, g, r, ITERS)
    assert got[0].dtype == torch.float32
    assert _apart(smoke, got, want) <= smoke.TR_STEP_TOL["float32"]


@pytest.mark.card
def test_k5_refuses_what_it_cannot_take(card):
    from smpltpu_torch.ops.trust_region import MAX_P, tr_step

    p = MAX_P + 1
    h = torch.eye(p, dtype=torch.float64, device=card)[None]
    g = torch.ones(1, p, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="P <= "):
        tr_step(h, g, torch.ones(1, dtype=torch.float64, device=card), ITERS)
    with pytest.raises(ValueError, match="contiguous"):
        tr_step(h[:, :4, :4], g[:, :4].contiguous(), g[:, 0].contiguous(), ITERS)


@pytest.mark.card
def test_k5_cases_on_the_card(smoke, card):
    """``chip_smoke.py::tr_step_cases``: every system in both precisions,
    the batch, and one replay inside a captured graph, bitwise the eager
    launch's."""
    res = smoke.tr_step_cases(card)
    assert res["failed"] == [], res["failed"]
    assert res["graph_bitwise"] and res["batch_bitwise"]
