"""The benchmark of the port (package ``smpltpu_torch``) on NVIDIA cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix and per-layer metrics are files found by
name (``spec.py``). Set-up makes the model and the inputs on the device
from ``--seed`` and warms every shape the cell uses; the window then
measures for ``--seconds``; with ``--trace 1`` one more unit of work runs
under the profiler and the cell's per-layer metrics are read. After the
window the plain reference judges what the timed path produced
(``judge.py``).

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
Standard error ends with the same numbers, one a line.

Exit codes: 0 a result was printed (correct or not); 2 bad arguments; 3
no CUDA device, or fewer than the cell asks for; 4 JAX or the JAX
package was loaded. Bytecode goes to ``build/pycache`` and every build
and kernel cache under ``build/`` in the checkout.
"""

from __future__ import annotations

import os
import sys

from benchmark.clock import Clock

CLOCK = Clock()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "smpltpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the run may not hold, compared
    whole: ``smpltpu_torch`` is the port, ``smpltpu`` the JAX package."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def layer_metrics(cell, res) -> dict:
    """The cell's per-layer metrics that their readers find, by name."""
    from benchmark import spec
    out = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"]).read(res.ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell, res, trace: bool, device_info: dict) -> dict:
    from benchmark import trace as tr
    if trace:
        metrics = layer_metrics(cell, res)
    else:
        metrics = {m["name"]: {"value": float(res.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": all(c.ok for c in res.checks) and res.failed == 0,
            "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": dict(device_info)}
    if trace and res.traced is not None:
        t = res.traced["trace"]
        line["device"].update(busy_s=tr.busy_s(t), window_s=t.window_s)
        line["breakdown"] = {"device_ops": tr.top_ops(t), "idle_gaps": tr.idle_gaps(t)}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in res.checks}
    return line


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            clock=CLOCK) -> dict:
    """Set-up, window, trace and judgement of ``cell`` on ``device``: the
    whole run but the look for a card. -> the result line."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark import spec
    res = spec.runner(cell.config).run(cell.config, cell.traffic, seed, seconds,
                                       trace, clock, device)
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        info = {"platform": "cpu", "kind": "cpu"}
    info.update(count=cell.chips, memory_peak_bytes=res.peak_bytes)
    for c in res.checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}")
    return result_line(cell, res, trace, info)


def main(argv=None) -> int:
    try:
        args = parse(sys.argv[1:] if argv is None else argv)
    except SystemExit as e:
        return 2 if e.code else 0
    from benchmark import spec
    cell = spec.cell(spec.load_bench(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 3
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: the run loaded {bad}: the port may not import JAX "
            "or the JAX package")
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
