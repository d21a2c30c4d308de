"""K1's launch plan (smpltpu_torch/ops/cg.py::k1_plan), a plain function of
the system's shapes and the device's limits, so it is checked here on the
CPU: every frame is owned by exactly one CTA, the shared memory a CTA asks
for fits the budget, global scratch is asked for only when the vectors do
not fit, and the fit's single stage-1 window spreads over a cluster. The
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import re
from pathlib import Path

import pytest

from smpltpu_torch.ops import cg

P = 76
# an H100's opt-in shared memory per block with clusters of 16, and the
# same budget where only the portable cluster size 8 can be scheduled
H100 = {"smem_per_block": 232448, "max_cluster": 16}
CLUSTER8 = {"smem_per_block": 232448, "max_cluster": 8}
SHAPES = [(1, 100), (67, 20), (1, 1), (1, 7), (3, 7), (1, 160), (3, 160),
          (1, 400), (1, 1000), (1, 10000), (667, 20)]


@pytest.mark.parametrize("limits", [H100, CLUSTER8], ids=["h100", "cluster8"])
@pytest.mark.parametrize("n_s", [1, 10, 16])
@pytest.mark.parametrize("n_win,n_frames", SHAPES)
def test_k1_plan(n_win, n_frames, n_s, limits):
    plan = cg.k1_plan(n_win, n_frames, P, n_s, **limits)
    assert 1 <= plan.cluster <= min(limits["max_cluster"], n_frames)
    ranges = cg.k1_frame_ranges(n_frames, plan.cluster)
    owned = [g for lo, hi in ranges for g in range(lo, hi)]
    assert owned == list(range(n_frames))           # each frame once
    assert min(hi - lo for lo, hi in ranges) >= 1
    assert max(hi - lo for lo, hi in ranges) == plan.frames_per_cta
    assert 0 <= plan.resident_frames <= plan.frames_per_cta
    assert plan.vec_len >= plan.frames_per_cta * P and plan.vec_len % 4 == 0
    vec_bytes = 4 * cg.K1_VECS * plan.vec_len
    resident = plan.resident_frames * 4 * P * (P + n_s)
    assert plan.smem_bytes == (4 * cg.K1_HEADER_FLOATS + resident
                               + (vec_bytes if plan.vec_in_smem else 0))
    assert plan.smem_bytes <= limits["smem_per_block"]
    if plan.vec_in_smem:
        assert plan.scratch_floats == 0
    else:
        assert plan.scratch_floats == (n_win * plan.cluster * cg.K1_VECS
                                       * plan.vec_len)
    if plan.resident_frames == plan.frames_per_cta:
        assert plan.scratch_floats == 0             # all on chip
    if (n_win, n_frames) == (1, 100):
        assert plan.cluster > 1                     # stage 1 off one SM


def test_k1_plan_picks_the_measured_layouts():
    """The plan's layouts at the fit's two stage shapes, timed on an H100
    (PERF.md, K1 layouts): one window of 100 frames over 15 CTAs of 6-7
    resident frames (532 rows, one pass of the 544 threads), 67 windows of
    20 over 3 CTAs of 6-7; with clusters of 8 only, 13 frames a CTA, 7 of
    them resident."""
    s1 = cg.k1_plan(1, 100, P, 10, **H100)
    assert (s1.cluster, s1.frames_per_cta, s1.resident_frames) == (15, 7, 7)
    s2 = cg.k1_plan(67, 20, P, 10, **H100)
    assert (s2.cluster, s2.frames_per_cta, s2.resident_frames) == (3, 7, 7)
    s8 = cg.k1_plan(1, 100, P, 10, **CLUSTER8)
    assert (s8.cluster, s8.frames_per_cta, s8.resident_frames) == (8, 13, 7)


@pytest.mark.parametrize("n_win,n_frames,want", [
    # the 10 000-frame video's stage 1: 63 frames a CTA, 4 of them
    # resident, the other 59 streamed from L2 on every CG step
    (1, 1000, (16, 63, 4, True, 0)),
    # the 100 000-frame video's stage 1: the vectors of 625 frames no
    # longer fit beside the header; they go to global scratch
    # (16 CTAs x 6 vectors x 47 500 floats), and 8 frames stay resident
    (1, 10000, (16, 625, 8, False, 16 * 6 * 47500 * 4)),
    # the 10 000-frame video's stage 2 as one batch: the 67-window plan
    (667, 20, (3, 7, 7, True, 0)),
])
def test_k1_plan_long_video_shapes(n_win, n_frames, want):
    """K1's plans at the long-video configuration's shapes with an H100's
    limits: (cluster, frames per CTA, resident frames, vectors in shared
    memory, scratch bytes)."""
    plan = cg.k1_plan(n_win, n_frames, P, 10, **H100)
    assert (plan.cluster, plan.frames_per_cta, plan.resident_frames,
            plan.vec_in_smem, 4 * plan.scratch_floats) == want
    assert plan.vec_len == -(-plan.frames_per_cta * P // 4) * 4


def _one_pass_on_chip(plan, p):
    return (plan.resident_frames == plan.frames_per_cta
            and plan.frames_per_cta * p <= cg.K1_THREADS)


@pytest.mark.parametrize("p", [31, P])
@pytest.mark.parametrize("n_win,n_frames", SHAPES)
def test_k1_plan_takes_the_smallest_cluster_on_chip(n_win, n_frames, p):
    """The rule: the smallest cluster whose CTAs hold all their frames in
    shared memory and their rows in one pass of the threads; where none
    does, the largest the device allows."""
    plan = cg.k1_plan(n_win, n_frames, p, 10, **H100)
    top = min(H100["max_cluster"], n_frames)
    smaller = [cg.k1_plan(n_win, n_frames, p, 10, **H100, cluster=c)
               for c in range(1, plan.cluster)]
    assert not any(_one_pass_on_chip(s, p) for s in smaller)
    assert _one_pass_on_chip(plan, p) or plan.cluster == top


def test_k1_plan_is_cached():
    """A launch asks for its plan once per shape: the same arguments give
    the same object, without recomputing the layouts."""
    assert cg.k1_plan(67, 20, P, 10, **H100) is cg.k1_plan(67, 20, P, 10,
                                                           **H100)


def test_k1_plan_forced_cluster_and_scratch():
    """A forced one-CTA plan for 160 frames keeps its vectors in global
    scratch (W * 6 vectors of 160 * 76 floats) and 8 frames resident."""
    plan = cg.k1_plan(2, 160, P, 10, **H100, cluster=1)
    assert (plan.cluster, plan.vec_in_smem) == (1, False)
    assert plan.scratch_floats == 2 * cg.K1_VECS * 160 * P
    assert plan.resident_frames == 8


@pytest.mark.parametrize("kw,match", [
    ({"n_s": 17}, "nS must be 1..16"),
    ({"n_s": 0}, "nS must be 1..16"),
    ({"p": 129}, "P <= 128"),
    ({"n_frames": 0}, "W=1 F=0"),
    ({"cluster": 17}, "cluster 17 not in"),
    ({"n_frames": 4, "cluster": 5}, "cluster 5 not in 1..4"),
    ({"smem_per_block": 1024}, "less than the kernel's header"),
])
def test_k1_plan_refuses(kw, match):
    args = {"n_win": 1, "n_frames": 100, "p": P, "n_s": 10, **H100, **kw}
    with pytest.raises(ValueError, match=match):
        cg.k1_plan(**args)


def test_k1_constants_match_the_kernel_source():
    """The plan mirrors the kernel's shared-memory layout: the constants
    of ops/cg.py against those of csrc/arrow_pcg.cu."""
    src = (Path(cg.__file__).resolve().parents[1] / "csrc"
           / "arrow_pcg.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kHeader") == cg.K1_HEADER_FLOATS
    assert const("kVecs") == cg.K1_VECS
    assert const("kMaxShapes") == cg.K1_MAX_SHAPES
    assert const("kMaxCluster") == cg.K1_MAX_CLUSTER
    assert const("kMaxP") == cg.K1_MAX_P
    assert const("kThreads") == cg.K1_THREADS
