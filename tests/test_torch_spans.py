"""The port's spans (``smpltpu_torch.utils.obs.span``) on the CPU: no cost
but a flag read when no profiler records; under ``torch.profiler`` one
``multi_frame.trip`` a trip of the LM loop, each trip and read of
``converged`` inside its fit and its stage, one ``render.fk`` /
``render.lbs`` / ``render.raster`` a chunk of the render, and one
``online.trip`` a trip of the pump's frame."""

import collections
import contextlib

import numpy as np
import pytest
import torch

from smpltpu_torch.energy.params import init_frame_params
from smpltpu_torch.pipeline.common import SKIN_BATCH, render_frames
from smpltpu_torch.solve import (
    MultiFrameConfig,
    OnlineConfig,
    OnlineFitter,
    build_fused_two_stage,
    build_multi_fitter,
)
from smpltpu_torch.utils import obs
from tests.test_torch_energy import make_rig

F64 = torch.float64
CPU = torch.device("cpu")
CFG = dict(beta_pose=5.0, beta_shape=25.0, lambda_temporal=3.0, linear="pcg",
           cg_iters=8)


def _profiled(fn):
    """-> (fn's result, {span name: [(start ns, end ns)] by start}) of the
    program's spans recorded while ``fn`` ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    got = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().split(".")[0] in ("two_stage", "multi_frame", "render", "online"):
            s = int(ev.start_ns())
            got[ev.name()].append((s, s + int(ev.duration_ns())))
    return out, {k: sorted(v) for k, v in got.items()}


def _inside(inner, outer):
    return [sum(1 for s, e in inner if os <= s and e <= oe) for os, oe in outer]


def _p0(*lead):
    return torch.as_tensor(np.tile(
        init_frame_params(depth=3.0, device=CPU, dtype=F64).numpy(), lead + (1,)))


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = obs.span("multi_frame.trip"), obs.span("online.wait")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass


def test_span_under_a_profiler_is_a_named_range():
    def twice():
        for _ in range(2):
            with obs.span("multi_frame.fit"):
                torch.ones(3).sum()
    _, got = _profiled(twice)
    assert len(got["multi_frame.fit"]) == 2


@pytest.mark.parametrize("max_iters", [6, 30])
def test_batched_fit_has_a_trip_span_a_trip(small_model_dict, max_iters):
    """Two 5-frame windows as one batch, stopped by the trip cap (6) or
    converged at different trips (30, a loose ``ftol``): the loop runs
    until the slower window stops, one ``multi_frame.trip`` a trip, and
    every trip and every read of ``converged`` lies inside the fit's
    span."""
    rig = make_rig(small_model_dict, 10, seed=17)
    fit = build_multi_fitter(rig["spec"], rig["cam"],
                             MultiFrameConfig(max_iters=max_iters, ftol=3e-2, **CFG),
                             10, device=CPU, dtype=F64)
    res, got = _profiled(lambda: fit(
        _p0(2, 5), torch.zeros(10, dtype=F64),
        torch.as_tensor(rig["kp"]).reshape(2, 5, -1, 4),
        torch.as_tensor(rig["r0"]).reshape(2, 5, 3, 3)))
    assert bool(res.converged.all()) == (max_iters == 30)
    assert len(set(res.iters_run.tolist())) == 2
    trips, waits = got["multi_frame.trip"], got["multi_frame.wait"]
    assert len(trips) == int(res.iters_run.max()) > 0
    # a read before each trip, and one more where the loop stopped on it
    assert len(waits) == len(trips) + int(len(trips) < max_iters)
    assert len(got["multi_frame.fit"]) == 1
    assert _inside(trips + waits, got["multi_frame.fit"]) == [len(trips) + len(waits)]
    # the trips and the reads alternate, a read first
    order = sorted([(s, "w") for s, _ in waits] + [(s, "t") for s, _ in trips])
    assert [k for _, k in order][:4] == ["w", "t", "w", "t"]


def test_fused_two_stage_trips_lie_in_their_stage(small_model_dict):
    rig = make_rig(small_model_dict, 12, seed=19)
    anchors, starts, wsize, n = [0, 4, 8], [0, 5], 7, 12
    cfg1 = MultiFrameConfig(max_iters=4, **CFG)
    cfg2 = MultiFrameConfig(max_iters=3, **CFG)
    run = build_fused_two_stage(rig["spec"], rig["cam"], cfg1, cfg2, 10, anchors,
                                starts, wsize, n, device=CPU, dtype=F64)
    kp, r0 = torch.as_tensor(rig["kp"]), torch.as_tensor(rig["r0"])
    win = torch.as_tensor([[min(s + k, n - 1) for k in range(wsize)] for s in starts])
    vw = torch.as_tensor([[float(s + k < n) for k in range(wsize)] for s in starts],
                         dtype=F64)
    (st1, st2), got = _profiled(lambda: run(
        _p0(3), torch.zeros(10, dtype=F64), kp[anchors], r0[anchors],
        kp[win], r0[win], vw))
    stages = got["two_stage.stage1"] + got["two_stage.stage2"]
    assert len(stages) == 2 and len(got["two_stage.interp"]) == 1
    trips, waits = got["multi_frame.trip"], got["multi_frame.wait"]
    assert _inside(trips, stages) == [int(st1.iters_run), int(st2.iters_run.max())]
    assert sum(_inside(waits, stages)) == len(waits)
    assert _inside(got["multi_frame.fit"], stages) == [1, 1]


def test_render_has_three_spans_a_chunk(small_model_dict):
    n = SKIN_BATCH + 1
    rig = make_rig(small_model_dict, n, seed=23)
    (gray, covered), got = _profiled(lambda: render_frames(
        rig["model"], rig["gt"], rig["shape"], rig["r0"], rig["cam"], 24, 40))
    assert gray.shape == (n, 24, 40)
    frames = got["render.frames"]
    assert len(frames) == 1
    for name in ("render.fk", "render.lbs", "render.raster"):
        assert _inside(got[name], frames) == [2], name
    # a chunk's FK, then its skinning, then its raster
    order = sorted((s, name) for name in ("render.fk", "render.lbs", "render.raster")
                   for s, _ in got[name])
    assert [k for _, k in order] == ["render.fk", "render.lbs", "render.raster"] * 2


@pytest.mark.parametrize("frames", [1, 3])
def test_pump_frame_has_a_trip_span_a_trip(small_model_dict, frames):
    """The first frame runs to the trip cap, a repeat of it stops after
    two trips, the next after one."""
    rig = make_rig(small_model_dict, 3, seed=29)
    fit = OnlineFitter(rig["model"], rig["cam"], OnlineConfig(max_iters=20),
                       shape=rig["shape"], device=CPU, dtype=F64)
    pump = fit.make_pump().start(fit.prev, fit.shape, fit.has_prev)
    out, got = _profiled(lambda: [pump.submit(rig["kp"][0]) for _ in range(frames)])
    pump.stop()
    assert [o[2] for o in out] == [20, 2, 1][:frames]
    submits = got["online.submit"]
    assert len(submits) == frames
    assert _inside(got["online.trip"], submits) == [o[2] for o in out]
    for name in ("online.copy_in", "online.init", "online.copy_out"):
        assert _inside(got[name], submits) == [1] * frames, name
    # a read after each trip but the last, and after the last where the
    # frame stopped on it and not at the trip cap
    assert _inside(got["online.wait"], submits) == [
        o[2] - int(o[2] == 20) for o in out]
