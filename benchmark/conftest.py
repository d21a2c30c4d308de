"""Test helpers of the benchmark's own tests (``python -m pytest benchmark``).

``tiny_cell`` gives a cell of ``BENCHMARK.json`` cut to a size the CPU
runs in seconds: a 300-vertex model; 60-frame videos with few LM trips,
a 72 x 128 camera and render; or a short feed (its camera as
configured). Tests that need a CUDA card
carry the ``card`` marker and skip, from inside their ``card`` fixture,
where there is none."""

import copy

import pytest
import torch

from benchmark import spec


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


def tiny_cell(name: str, s1_iters: int = 8, s2_iters: int = 6):
    c = spec.cell(spec.load_bench(), name)
    cfg = copy.deepcopy(c.config)
    cfg["model_sizes"] = {"n_verts": 300, "n_shapes": 10, "n_faces": 596,
                          "n_pose_blend": 207}
    tr = dict(c.traffic)
    if cfg["runner"] == "video":
        cfg["camera"] = {"width": 72, "height": 128}
        cfg["render"] = {"width": 72, "height": 128}
        cfg["fit"]["stage1"]["max_iters"] = s1_iters
        cfg["fit"]["stage2"]["max_iters"] = s2_iters
        tr.update(frames=60, videos=4)
    else:
        tr.update(frames=120, rate_fps=200.0, trace_frames=4)
    return c._replace(config=cfg, traffic=tr)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
