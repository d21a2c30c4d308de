"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout,
each configuration's file under ``benchmark/configs/``, each traffic mix's
under ``benchmark/traffic/`` and each per-layer metric's reader under
``benchmark/metrics/``, all found by the names ``BENCHMARK.json`` gives.
A cell, a configuration, a traffic mix or a metric is added by adding its
files and its entry; no file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    config: dict           # the configuration's file, with its entry's name
    traffic: dict          # the traffic mix's file, with its name
    chips: int
    end_to_end: list       # the entries of the end-to-end metrics it reports
    per_layer: list        # the entries of the per-layer metrics it reports


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    ws = {w["name"]: w for w in bench["workloads"]}
    if name not in ws:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(ws)})")
    w = ws[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(load_json(os.path.join(root, conf["file"])), name=conf["name"])
    traffic = dict(load_json(os.path.join(root, "benchmark", "traffic",
                                          w["traffic"] + ".json")),
                   name=w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per)


def runner(config: dict):
    """The module that runs this configuration's kind of system:
    ``benchmark/runners/<runner>.py``."""
    return importlib.import_module(f"benchmark.runners.{config['runner']}")


def reader(metric_name: str, root: str = ROOT):
    """The per-layer metric's reader, ``benchmark/metrics/<name>.py``: its
    ``read(ctx)`` returns the value, or None where the run has nothing for
    it to read."""
    path = os.path.join(root, "benchmark", "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
