"""bench.py's twin run whole with BENCH_SINGLE on the CPU, one torch
thread: the twin of ``tests/test_integration.py::test_bench_single_smoke``
(BENCH_FRAMES=60, BENCH_SINGLE_FRAMES=6, the GMM quality gate, chunks of
3). Its printed gate residuals (float32, two decimals) are held to bench.py's
recipe in the JAX package (float64, ``tests/data/bench_jax_ref.npz``)
within the print's rounding and GATE_PX_ATOL (measured: 2.5e-5 px with the
GMM, 1.7e-4 without, before rounding)."""

import re

import numpy as np
import pytest
import torch

import smpltpu_torch.bench as bench
from tests.test_torch_bench import GATE_PX_ATOL, GOLDEN
from tests.test_torch_bench_modes import (  # noqa: F401 (a fixture)
    _one_line,
    _records,
    bench_env,
)

PRINT_HALF_STEP = 0.005   # the gate line and the record print two decimals


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_main_single_gmm_run(bench_env, capsys):
    """BENCH_SINGLE=1 with _FRAMES=6, _GMM=1 (the quality gate), _CHUNK=3:
    the headline stays one stdout line; stderr holds the single-frame
    record with bench.py's keys (gmm on, the prior-seeded starts) and the
    gate's line."""
    bench_env(BENCH_SINGLE=1, BENCH_SINGLE_FRAMES=6, BENCH_SINGLE_GMM=1,
              BENCH_SINGLE_CHUNK=3)
    assert bench.main([], device="cpu") == 0
    cap = capsys.readouterr()
    _one_line(cap.out)
    (rec,) = _records(cap.err, "single_frame_throughput_frames_per_sec")
    assert set(rec) == {"metric", "value", "unit", "residual_px", "starts",
                        "gmm", "tr"}
    # 4 yaws + the blind init + one start per component of the prior
    assert rec["value"] > 0 and rec["gmm"] is True and rec["starts"] == 13
    gate = re.search(r"GMM quality gate: gmm ([\d.]+)px vs no-gmm ([\d.]+)px"
                     r" .*\(gap ([+-][\d.]+)px", cap.err)
    assert gate, cap.err
    golden = np.load(GOLDEN)
    want = (float(golden["gate_gmm_px"]), float(golden["gate_l2_px"]))
    want += (want[0] - want[1],)
    for got, ref, n in zip(map(float, gate.groups()), want, (1, 1, 2)):
        assert abs(got - ref) <= PRINT_HALF_STEP + n * GATE_PX_ATOL, (got, ref)
    assert rec["residual_px"] == float(gate.group(1))
