"""The whole run but the look for a card, at a tiny size on the CPU, with
the timed path broken underneath: ``correct`` has to come out false for
each fault the cell can have, and true without one.

Faults planted in the program (by monkeypatching what the timed path
calls):
* a step that returns its state unchanged: K1's entry returns a zero step
  (videos); the online LM trip returns its state as it was (the feed);
* half of the batch left out: stage 2 solves the first half of the
  windows and hands back the other half's starts, at their starting cost
  (videos, ``faults.plant("half")``; a feed has one frame a problem and
  no batch);
* an answer altered where it is produced: one window's parameters moved
  after its solve (videos), the pose the pump returns moved (the feed).
No cell spans chips, so no exchange between chips can be left out.
"""

import pytest
import torch

from benchmark import faults, run
from benchmark.conftest import tiny_cell

pytest.importorskip("smpltpu_torch")
import smpltpu_torch.ops.cg as cg_ops  # noqa: E402
import smpltpu_torch.solve.online as online  # noqa: E402
import smpltpu_torch.solve.two_stage as two_stage  # noqa: E402

SEED = 2 ** 31 + 12345


def video_line():
    return run.execute(tiny_cell("video1k"), SEED, 0.1, False, "cpu")


def stream_line():
    return run.execute(tiny_cell("stream_steady"), SEED, 0.05, False, "cpu")


def test_sound_video_run_is_correct():
    line = video_line()
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"


def test_video_step_returns_state_unchanged(monkeypatch):
    monkeypatch.setattr(cg_ops, "arrow_pcg",
                        lambda d, o, t, b, c, g_p, g_w, iters, rtol=0.0:
                        (torch.zeros_like(g_p), torch.zeros_like(g_w)))
    line = video_line()
    assert not line["correct"]
    assert line["checks"]["newton_gap"]["value"] > line["checks"]["newton_gap"]["limit"]


def test_video_half_the_windows_left_out(monkeypatch):
    faults.plant("half", monkeypatch.setattr)
    line = video_line()
    assert not line["correct"]
    assert line["checks"]["newton_gap"]["value"] > line["checks"]["newton_gap"]["limit"]
    # a window handed back at its start keeps its start's whole cost
    assert line["checks"]["start_share"]["value"] >= 1.0 - 1e-9


@pytest.mark.parametrize("fault", [None, "half"])
def test_fault_readings_tool(monkeypatch, fault):
    """``python3 -m benchmark.faults``' readings, at the tiny size."""
    if fault:
        faults.plant(fault, monkeypatch.setattr)
    r = faults.readings(tiny_cell("video1k"), SEED, 2, torch.device("cpu"))
    assert r["correct"] is (fault is None)
    assert r["problems"] == 2 * 5 and len(r["start_share_q50_90_99_max"]) == 4


def test_video_answer_altered(monkeypatch):
    """One window's parameters moved after its solve (stage 2, the second
    fitter build_fused_two_stage builds)."""
    real = two_stage.build_multi_fitter
    built = []

    def build(spec, cam, cfg, n_shapes, *, device, dtype):
        fit = real(spec, cam, cfg, n_shapes, device=device, dtype=dtype)
        built.append(fit)
        if len(built) % 2 == 1:
            return fit

        def alter(*a):
            st = fit(*a)
            p = st.params.clone()
            p[0, 5, 20] += 0.3
            return st._replace(params=p)
        return alter
    monkeypatch.setattr(two_stage, "build_multi_fitter", build)
    line = video_line()
    assert not line["correct"]
    assert line["checks"]["cost_gap"]["value"] > line["checks"]["cost_gap"]["limit"]


def test_sound_stream_run_is_correct():
    line = stream_line()
    assert line["correct"] and line["attempted"] >= 5


def test_stream_step_returns_state_unchanged(monkeypatch):
    real = online.lm_program

    def frozen(*a, **k):
        init, _ = real(*a, **k)
        return init, lambda state: state
    monkeypatch.setattr(online, "lm_program", frozen)
    assert not stream_line()["correct"]


def test_stream_answer_altered(monkeypatch):
    real = online.OnlinePump.submit

    def submit(self, kp):
        x, c, it, ok = real(self, kp)
        x = x.copy()
        x[20] += 0.3
        return x, c, it, ok
    monkeypatch.setattr(online.OnlinePump, "submit", submit)
    line = stream_line()
    assert not line["correct"]
    assert line["checks"]["cost_gap"]["value"] > line["checks"]["cost_gap"]["limit"]
