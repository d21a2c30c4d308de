"""bench.py's twin in its optional modes on the CPU, one torch thread:
the render, the stream modes and the single-frame sub-modes through the
twin's functions, and the mesh path on two gloo ranks as threads against
one device (the whole run with BENCH_SINGLE is
``tests/test_torch_bench_single.py``).

The single-frame sub-modes run in float64 on the reference's keypoints and
their residuals are held to bench.py's recipe in the JAX package, recorded
in ``tests/data/bench_jax_ref.npz`` (``tests/test_torch_bench.py::
record_modes``), within GATE_PX_ATOL (the free scale's gauge; see
tests/test_torch_bench.py).

The mesh run sets BENCH_CG_ITERS=10: the sharded stage 1 runs every one of
its 150 trips with eager collectives, ~25 s a run at 40 steps on a CPU.
Its residual is held within 0.05 px of the same recipe on one device (the
multi CLI's mesh tests hold their means to 0.05 px, chip_smoke.py's
CLI_MESH_GAP_MAX_PX).
"""

import json
import re

import numpy as np
import pytest
import torch

import smpltpu_torch.bench as bench
from smpltpu_torch.parallel import run_ranks
from tests.test_torch_bench import (
    GATE_PX_ATOL,
    GOLDEN,
    MODE_FRAMES,
    SINGLE_MODES,
    anchor_poses,
)

N_FRAMES = 60
MESH_GAP_MAX_PX = 0.05
MESH_FRAMES = 70


@pytest.fixture
def bench_env(monkeypatch):
    """A clean BENCH_* environment at 60 frames; returns a setter."""
    import os
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_FRAMES", str(N_FRAMES))
    return lambda **kw: [monkeypatch.setenv(k, str(v)) for k, v in kw.items()]


def _one_line(out):
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == bench.METRIC and rec["value"] > 0
    return rec


def _records(err, metric):
    return [json.loads(ln) for ln in err.splitlines()
            if ln.startswith(f'{{"metric": "{metric}"')]


def _sampled_px(err):
    return float(re.search(r"^bench: residual pixel error ([\d.]+)px", err,
                           re.M).group(1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w32():
    return bench.workload("cpu", N_FRAMES)


def test_render_pass(w32, capsys):
    """BENCH_RENDER's pass on the CPU (the plain versions of K2 and K3):
    every frame drawn at the default 0.375 of the camera, 270 x 480, with
    both roofline lines."""
    cfg1, cfg2 = bench.stage_configs(s1_iters=20, s2_iters=5)
    fit1, args1 = bench.build_stage1(w32, cfg1)
    st1 = fit1(*args1)
    poses = anchor_poses(st1.params.numpy(), w32["anchor_idx"], N_FRAMES)
    st2 = bench.build_stage2(w32, cfg2)(*bench.stage2_inputs(w32, poses,
                                                             st1.shape))
    fp, shp = bench.write_back(w32, st2)
    bench.render_pass(w32, fp, shp, 0.375, 1.0, torch.device("cpu"))
    err = capsys.readouterr().err
    m = re.search(r"render (\d+) frames at 270x480 in \d+ ms .*, (\d+) frames "
                  r"drawn\)", err)
    assert m and int(m.group(1)) == int(m.group(2)) == N_FRAMES, err
    assert "roofline[lbs]" in err and "roofline[raster]" in err


def test_stream_pass(w32, capsys):
    """BENCH_STREAM, _SCAN and _PUMP on the CPU: the three latency lines and
    the pump's record with bench.py's keys."""
    env = bench.read_env({"BENCH_STREAM": "1", "BENCH_STREAM_SCAN": "1",
                          "BENCH_STREAM_PUMP": "1",
                          "BENCH_STREAM_FRAMES": "4"})
    shp = torch.zeros(10)
    bench.stream_pass(w32, env, shp, torch.device("cpu"), torch.float32)
    err = capsys.readouterr().err
    assert re.search(r"^bench: stream 4 frames: latency mean", err, re.M)
    assert re.search(r"^bench: stream-scan 4 frames in", err, re.M)
    assert re.search(r"^bench: stream-pump 4 frames: latency mean", err, re.M)
    (rec,) = _records(err, "stream_pump_latency_ms")
    assert set(rec) == {"metric", "value", "unit", "p95_ms", "mean_ms"}


@pytest.mark.parametrize("env", list(SINGLE_MODES.values()))
def test_single_pass_modes(capsys, env):
    """BENCH_SINGLE's other sub-modes at 4 frames of the video, float64:
    multi-start (5 starts) with the eigh trust region, the prior-vs-data
    GMM variant with a chol trip cap, and the adaptive start with its
    options. Each prints bench.py's record with its keys, and its
    residuals lie within GATE_PX_ATOL of bench.py's recipe in the JAX
    package on the same keypoints."""
    mode = next(k for k, v in SINGLE_MODES.items() if v == env)
    golden = np.load(GOLDEN)
    w64 = bench.workload("cpu", N_FRAMES, dtype=torch.float64,
                         kp=golden["kp"])
    e = bench.read_env(dict(env, BENCH_SINGLE="1",
                            BENCH_SINGLE_FRAMES=str(MODE_FRAMES)))
    px = bench.single_pass(w64, e, 2 * 17, torch.device("cpu"), torch.float64)
    err = capsys.readouterr().err
    (rec,) = _records(err, "single_frame_throughput_frames_per_sec")
    assert rec["value"] > 0 and rec["residual_px"] == round(px["single"], 2)
    assert rec["starts"] == (5 if e.single_multistart else 1)
    assert rec["gmm"] is (e.single_gmm == "stress")
    assert rec["tr"] == (e.single_tr or "default")
    assert set(px) == ({"single", "adaptive"} if e.single_adaptive
                       else {"single"})
    for k, v in px.items():
        want = float(golden[f"single_{mode}_{k}_px"])
        assert abs(v - want) <= GATE_PX_ATOL, (k, v, want)
    if e.single_adaptive:
        (ad,) = _records(err, "single_frame_adaptive_throughput_frames_per_sec")
        assert set(ad) == {"metric", "value", "unit", "residual_px",
                           "hard_frames", "px_thresh", "orient", "propagate"}
        assert ad["orient"] is False and ad["propagate"] is True
        assert ad["residual_px"] == round(px["adaptive"], 2)


def test_mesh_two_ranks(bench_env, capsys):
    """The mesh path on two gloo ranks as threads, at 70 frames: the
    frame-sharded stage 1 on 7 anchors and a padding row, window DP on 5
    windows and a dummy one. One stdout line, from rank 0; its sampled
    residual within MESH_GAP_MAX_PX of the same recipe on one device."""
    bench_env(BENCH_CG_ITERS=10, BENCH_FRAMES=MESH_FRAMES)
    assert run_ranks(2, lambda m: bench.main([], device="cpu",
                                             mesh=m)) == [0, 0]
    cap = capsys.readouterr()
    _one_line(cap.out)
    assert "mesh size 2" in cap.err and "5 windows (+1 pad)" in cap.err
    px_mesh = _sampled_px(cap.err)

    w = bench.workload("cpu", MESH_FRAMES)
    cfg1, cfg2 = bench.stage_configs(cg_iters=10)
    fit1, args1 = bench.build_stage1(w, cfg1)
    st1 = fit1(*args1)
    poses = anchor_poses(st1.params.numpy(), w["anchor_idx"], MESH_FRAMES)
    st2 = bench.build_stage2(w, cfg2)(*bench.stage2_inputs(w, poses,
                                                           st1.shape))
    px_one = bench.sampled_residual(w, st2.params, st2.shape)
    assert abs(px_mesh - px_one) <= MESH_GAP_MAX_PX, (px_mesh, px_one)
    assert np.isfinite(px_mesh) and px_mesh < 2.0
