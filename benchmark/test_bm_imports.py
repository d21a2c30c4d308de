"""What a run may load: nothing whose top-level module name is ``jax``,
``jaxlib``, ``flax`` or ``smpltpu`` (the JAX package; ``smpltpu_torch``,
the port, begins with the same letters and is compared as a whole name),
and a reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import run, spec

REFERENCE_SIDE = ("reference.py", "gen.py", "judge.py", "counts.py", "trace.py",
                  "clock.py", "spec.py")

PROBE = r"""
import json, sys
from benchmark import run, spec
from benchmark.conftest import tiny_cell
for name in ("video1k", "stream_steady"):
    run.execute(tiny_cell(name), 7, 0.05, True, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_whole_words():
    assert run.forbidden_modules({"smpltpu_torch": 1, "smpltpu_torch.ops": 1}) == []
    assert run.forbidden_modules({"smpltpu.models": 1, "jax.numpy": 1}) == ["jax", "smpltpu"]
    assert run.forbidden_modules({"jaxtyping": 1, "flaxen": 1}) == []


def test_reference_side_imports_nothing_of_the_program():
    for name in REFERENCE_SIDE:
        mods = set(_imports(os.path.join(spec.HERE, name)))
        assert not mods & {"smpltpu_torch", "smpltpu", "jax", "jaxlib", "flax"}, name


def test_no_file_of_the_benchmark_imports_jax():
    for root, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                mods = set(_imports(os.path.join(root, f)))
                assert not mods & {"smpltpu", "jax", "jaxlib", "flax"}, f


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Both kinds of cell, traced, at a tiny size in a fresh interpreter."""
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT, text=True,
                         capture_output=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "smpltpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "smpltpu"}
