"""The control at a size a test run holds: the reference put in the
program's place with its matrix products in TF32 has to come out not
correct under the configurations' limits, and the same in float32 correct.
On the card the control runs at the cells' own sizes
(``python3 -m benchmark.control``; PERF.md has the readings)."""

import pytest

from benchmark import control
from benchmark import reference as ref
from benchmark.conftest import tiny_cell

SEED = 31415926535


@pytest.mark.parametrize("prec, correct", [("tf32", False), ("f32", True)])
def test_video_control(prec, correct):
    checks = control.video_control(tiny_cell("video1k"), SEED, ref.Prec(prec), "cpu")
    assert all(c.ok for c in checks) is correct


def test_stream_control():
    checks = control.stream_control(tiny_cell("stream_steady"), SEED, ref.Prec("tf32"),
                                    "cpu", 0.05)
    assert not all(c.ok for c in checks)
