"""The span metrics' readers on hand-built traces (nested spans, launch
calls, device intervals with known gaps), where each value is known
exactly; on a trace without the program's spans each reads None; and on
real traces of the tiny cells on the CPU the program's spans are found,
one ``multi_frame.trip`` a trip and one ``online.trip`` a pump trip."""

import pytest
import torch

from benchmark import run, spans, spec
from benchmark import trace as tr
from benchmark.conftest import tiny_cell

US = 1000                      # the traces below in microseconds
VIDEO = ["lm.dispatch_ms.video", "lm.wait_ms.video", "lm.trip_launches.video",
         "render.fk_launches.video", "device.idle_unspanned.video"]
STREAM = ["stream.launch_ms", "stream.wait_ms", "stream.frame_overhead_ms"]


def _ops(*items):
    return [tr.Op(n, s * US, e * US) for n, s, e in items]


def _video_trace():
    """Stage 1 with three trips and four reads of ``converged``, then a
    render of two chunks; launch calls inside and outside the trips; six
    device intervals (two overlapping) leaving five gaps, the last one
    (920-980) after every span of the program."""
    host = _ops(
        ("two_stage.stage1", 10, 500), ("multi_frame.fit", 20, 490),
        ("multi_frame.wait", 25, 30), ("multi_frame.trip", 30, 80),
        ("multi_frame.wait", 80, 100), ("multi_frame.trip", 100, 150),
        ("multi_frame.wait", 150, 200), ("multi_frame.trip", 200, 250),
        ("multi_frame.wait", 250, 260),
        ("aten::bmm", 32, 50), ("cudaLaunchKernel", 35, 36),
        ("cudaLaunchKernel", 40, 41), ("cudaLaunchKernel", 45, 46),
        ("cudaLaunchKernel", 85, 86), ("cudaStreamSynchronize", 87, 99),
        ("cudaLaunchKernelExC_v11060", 110, 111), ("cudaMemcpyAsync", 120, 121),
        ("cudaMemsetAsync_ptsz", 210, 211), ("cuLaunchKernel", 220, 221),
        ("cudaLaunchKernelEx", 230, 231),
        ("render.frames", 600, 900),
        ("render.fk", 610, 650), ("render.lbs", 650, 700), ("render.raster", 700, 750),
        ("render.fk", 760, 800), ("render.lbs", 800, 820), ("render.raster", 820, 880),
        ("cudaLaunchKernel", 615, 616), ("cudaLaunchKernel", 620, 621),
        ("cudaLaunchKernel", 660, 661), ("cudaGraphLaunch", 770, 771),
        ("cudaLaunchKernel", 950, 951))
    device = _ops(("k", 0, 20), ("k", 40, 60), ("k", 300, 350), ("k", 340, 400),
                  ("k", 550, 560), ("k", 650, 920), ("k", 980, 1000))
    return tr.Trace(device, host, 0, 1000 * US)


def _stream_trace():
    """Three frames: two trips and one read, then one trip, then an empty
    frame with no trip; device work under the trips."""
    host = _ops(
        ("online.submit", 0, 1000), ("online.copy_in", 10, 20),
        ("online.init", 20, 40), ("online.trip", 40, 100),
        ("cudaGraphLaunch", 41, 99), ("online.wait", 100, 150),
        ("online.trip", 150, 210), ("online.copy_out", 210, 260),
        ("online.submit", 2000, 2500), ("online.init", 2010, 2050),
        ("online.trip", 2050, 2100), ("online.submit", 3000, 3100))
    device = _ops(("g", 45, 140), ("g", 155, 250), ("g", 2055, 2200))
    return tr.Trace(device, host, 0, 3100 * US)


def _read(name, t):
    return spec.reader(name).read({"trace": t})


def test_video_readers_on_a_hand_built_trace():
    t = _video_trace()
    assert _read("lm.dispatch_ms.video", t) == pytest.approx(0.05, rel=1e-12)
    assert _read("lm.wait_ms.video", t) == pytest.approx(0.085 / 3, rel=1e-12)
    # 3 + 2 + 2 launch calls in the trips: not the one in a read of
    # ``converged``, not a synchronize, not an unlisted name
    assert _read("lm.trip_launches.video", t) == pytest.approx(7 / 3, rel=1e-12)
    assert _read("render.fk_launches.video", t) == pytest.approx(1.5, rel=1e-12)
    # gaps 20-40, 60-300, 400-550 (in stage 1), 560-650 (middle in the
    # render), 920-980 (after it): 60 of 560 us
    assert _read("device.idle_unspanned.video", t) == pytest.approx(
        100 * 60 / 560, rel=1e-12)


def test_stream_readers_on_a_hand_built_trace():
    t = _stream_trace()
    assert _read("stream.launch_ms", t) == pytest.approx(0.17 / 3, rel=1e-12)
    assert _read("stream.wait_ms", t) == pytest.approx(0.05 / 3, rel=1e-12)
    # frames' time outside their trips and reads: 830, 450 and 100 us
    assert _read("stream.frame_overhead_ms", t) == pytest.approx(
        (0.83 + 0.45 + 0.1) / 3, rel=1e-12)


@pytest.mark.parametrize("name", VIDEO + STREAM)
def test_a_trace_without_the_programs_spans_reads_none(name):
    host = _ops(("aten::bmm", 0, 50), ("cudaLaunchKernel", 10, 11),
                ("bm.window", 0, 100))
    t = tr.Trace(_ops(("k", 20, 30)), host, 0, 100 * US)
    assert _read(name, t) is None
    assert spec.reader(name).read({}) is None


def test_idle_share_needs_the_device():
    t = _video_trace()
    assert _read("device.idle_unspanned.video", t._replace(device=[])) is None


def test_launch_names():
    for n in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelExC_v11060",
              "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
              "cudaMemsetAsync", "cudaMemcpyAsync_ptsz"):
        assert spans.LAUNCH.match(n), n
    for n in ("cudaStreamSynchronize", "cudaLaunchKernelEx", "aten::copy_",
              "cudaGraphLaunchX", "multi_frame.trip"):
        assert not spans.LAUNCH.match(n), n


def test_every_span_metric_is_entered_for_its_cells():
    ents = {m["name"]: m for m in spec.load_bench()["per_layer"]}
    for name in VIDEO + STREAM:
        m = ents[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] == (["stream_steady"] if name in STREAM
                                  else ["video1k", "video10k"])


@pytest.mark.parametrize("cell", ["video1k", "stream_steady"])
def test_the_tiny_cells_trace_the_programs_spans(cell):
    """A tiny traced unit on the CPU: its trace holds one ``multi_frame.trip``
    per LM trip of the video, or one ``online.trip`` per pump trip of the
    traced frames, each inside its parent; the CPU has no device, so no
    idle share."""
    c = tiny_cell(cell)
    res = spec.runner(c.config).run(c.config, c.traffic, 11, 0.05, True, run.CLOCK,
                                    torch.device("cpu"))
    t = res.ctx["trace"]
    if cell == "video1k":
        v = res.ctx["traced_video"]
        trips = spans.find(t, spans.LM_TRIP)
        assert len(trips) == v["trips1"] + v["trips2"]
        fits = spans.find(t, spans.LM_FIT)
        assert len(fits) == 2
        for o in trips + spans.find(t, spans.LM_WAIT):
            assert any(f.start_ns <= o.start_ns and o.end_ns <= f.end_ns for f in fits)
        assert len(spans.find(t, spans.FK)) == -(-v["frames"] // 100)
        assert _read("lm.dispatch_ms.video", t) > 0
    else:
        trips = spans.find(t, spans.ON_TRIP)
        assert len(trips) == int(sum(res.ctx["traced_trips"]))
        assert len(spans.find(t, spans.SUBMIT)) == c.traffic["trace_frames"]
        assert _read("stream.frame_overhead_ms", t) > 0
