"""On a CUDA card: each cell runs briefly through ``python3 -m benchmark.run``
and comes out correct, and the card's kernels show in the trace.
Skips without a card (the ``card`` fixture decides)."""

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.card
@pytest.mark.parametrize("cell", ["video1k", "stream_steady"])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", "4294967311", "--seconds", "2", "--trace", "1"],
                         cwd=spec.ROOT, text=True, capture_output=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0 and line["metrics"]
