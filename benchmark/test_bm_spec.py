"""The benchmark is data: every cell, configuration, traffic mix and
per-layer metric loads from its own files by the name BENCHMARK.json
gives, every name and unit keeps to the allowed characters, and a new
cell with a new configuration, traffic mix and metric is added by new
files and entries alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import spec

BENCH = spec.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    c = spec.cell(BENCH, w["name"])
    assert c.config["name"] == w["config"] and c.traffic["name"] == w["traffic"]
    assert spec.runner(c.config).run
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.reader(m["name"]).read)
    assert TEXT.match(w["why"]) and w["chips"] in (1, 4)


def test_names_units_and_text():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"]) and set(m["workloads"]) <= {
            w["name"] for w in BENCH["workloads"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a metric
    and a cell as new files and entries, and load the new cell."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.load(open(os.path.join(spec.ROOT, "benchmark/configs/multi_k1.json")))
    conf["fit"]["stage1"]["max_iters"] = 100
    (root / "benchmark/configs/multi_k1_short.json").write_text(json.dumps(conf))
    traffic = json.load(open(os.path.join(spec.ROOT, "benchmark/traffic/videos_1000f.json")))
    (root / "benchmark/traffic/videos_200f.json").write_text(
        json.dumps(dict(traffic, frames=200)))
    (root / "benchmark/metrics/videos.count.py").write_text(
        "def read(ctx):\n    v = ctx.get('videos')\n    return None if v is None else len(v)\n")
    bench["configs"].append({"name": "multi_k1_short", "source": "test",
                             "file": "benchmark/configs/multi_k1_short.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "video200", "config": "multi_k1_short",
                               "traffic": "videos_200f", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "videos.count", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "video_fps", "workloads": ["video200"]})
    bench["end_to_end"][0]["workloads"].append("video200")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell(spec.load_bench(str(root)), "video200", str(root))
    assert c.traffic["frames"] == 200 and c.config["fit"]["stage1"]["max_iters"] == 100
    assert "videos.count" in [m["name"] for m in c.per_layer]
    assert spec.reader("videos.count", str(root)).read({"videos": [1, 2]}) == 2
    # the cells already there load as before from the copy
    for w in BENCH["workloads"]:
        assert spec.cell(spec.load_bench(str(root)), w["name"], str(root)).config


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no_such_cell")
