"""The port imports no JAX and nothing of the JAX package, and its copies
of the reference's numpy helpers and constants stay equal to the
originals."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import smpltpu.constants as j_constants
import smpltpu_torch.constants as constants
from smpltpu.energy.params import FrameParams as JFrameParams
from smpltpu.energy.params import pack_frame_params as j_pack_frame_params
from smpltpu.models.synthetic import make_synthetic_gmm as j_make_gmm
from smpltpu.models.synthetic import make_synthetic_model as j_make_model
from smpltpu.solve.two_stage import interp_tables as j_interp_tables
from smpltpu_torch.energy.params import (
    FrameParams,
    pack_frame_params,
    unpack_frame_params,
)
from smpltpu_torch.models.synthetic import make_synthetic_gmm, make_synthetic_model
from smpltpu_torch.solve.two_stage import interp_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every source file of the port, and the card check
PORT_FILES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "smpltpu_torch", "**", "*.py"), recursive=True))
# every module of the port, found on disk, so that a new one is covered
SLICE_MODULES = sorted(
    p[:-len(".py")].replace(os.sep, ".").removesuffix(".__init__")
    for p in PORT_FILES)
PORT_FILES.append("chip_smoke.py")


def _foreign(name):
    """A module of JAX or of the JAX package (``smpltpu_torch`` is fine)."""
    return name.split(".")[0] in ("jax", "jaxlib", "smpltpu")


def test_port_imports_no_jax():
    """A fresh interpreter (this one has JAX loaded by conftest) imports
    every slice module and must not have pulled in JAX or any module of the
    JAX package (``smpltpu`` or ``smpltpu.*``); importing builds no kernel
    and leaves TF32 off."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch, smpltpu_torch._build as b\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "assert b._lib is None\n"
            "import smpltpu_torch.native as n\n"
            "assert n._lib is None\n"
            "print(sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'smpltpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("kw", [
    {"n_verts": 300, "n_shapes": 10, "seed": 0},
    {"n_verts": 150, "seed": 5, "with_posedirs": False},
    {},   # the full width, bench.py's model (its faces built in a batch)
])
def test_synthetic_model_copy_matches_reference(kw):
    got, want = make_synthetic_model(**kw), j_make_model(**kw)
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("kw", [{}, {"n_comps": 4, "dim": 69, "seed": 2},
                                {"n_comps": 3, "dim": 12, "seed": 7,
                                 "dtype": np.float32}])
def test_synthetic_gmm_copy_matches_reference(kw):
    """The port's ``make_synthetic_gmm``, which its tests draw their GMM
    from, equals the reference's array for array."""
    got, want = make_synthetic_gmm(**kw), j_make_gmm(**kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_frame_params_copy_matches_reference(seed):
    """``pack_frame_params`` packs as the reference's does, and inverts
    ``unpack_frame_params`` for one frame."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(seed)
    parts = (rng.normal(), rng.normal(size=3), rng.normal(size=3),
             rng.normal(size=(23, 3)))
    got = pack_frame_params(FrameParams(*(torch.as_tensor(np.asarray(a))
                                          for a in parts)))
    want = j_pack_frame_params(JFrameParams(*(jnp.asarray(a) for a in parts)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pack_frame_params(unpack_frame_params(got)).numpy(), got.numpy())


@pytest.mark.parametrize("anchors,n", [(list(range(0, 40, 10)), 40),
                                       ([0, 3, 4, 9], 12), ([0], 5)])
def test_interp_tables_copy_matches_reference(anchors, n):
    for got, want in zip(interp_tables(anchors, n), j_interp_tables(anchors, n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", PORT_FILES)
def test_sources_import_nothing_of_jax(path):
    """Every import statement of the port's files and of chip_smoke.py, at
    any depth (the subprocess above sees only what runs at import), names
    neither JAX nor a module of the JAX package."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _foreign(n)], path


@pytest.mark.parametrize("name", sorted(
    n for n in vars(constants) if not n.startswith("_") and n != "np"))
def test_constants_copy_matches_reference(name):
    got, want = getattr(constants, name), getattr(j_constants, name)
    if callable(want):
        got, want = got(), want()
    np.testing.assert_array_equal(got, want)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype



@pytest.mark.parametrize("module", ["parallel", "parallel.mesh",
                                    "parallel.sharded"])
def test_parallel_names_match_reference(module):
    """Every public name that the JAX package's ``smpltpu/parallel``
    defines has its counterpart in the port."""
    import importlib

    ref = importlib.import_module(f"smpltpu.{module}")
    want = {n for n, v in vars(ref).items() if not n.startswith("_")
            and getattr(v, "__module__", "").startswith("smpltpu.parallel")}
    got = vars(importlib.import_module(f"smpltpu_torch.{module}"))
    assert want and not sorted(want - set(got))


# the reference's names that the port leaves in the JAX package
# (ROADMAP.md, "Do not port"): XLA and TPU machinery
LEFT_IN_JAX = {"solve.online": {"probe_io_callback"},
               "utils.obs": {"enable_compile_cache"}}


@pytest.mark.parametrize("module", [
    "energy", "energy.params", "models", "models.synthetic", "render",
    "native", "io", "io.keypoints", "constants", "solve.tridiag",
    "solve.multi_frame", "solve.online", "utils.obs"])
def test_public_names_match_reference(module):
    """Every public function and class that a module of the JAX package
    defines (a package: defines or re-exports from its submodules), and
    every array of its constants, has its twin in the port, but for the
    names that stay in the JAX package."""
    import importlib

    ref = importlib.import_module(f"smpltpu.{module}")

    def own(v):
        if isinstance(v, np.ndarray):
            return module == "constants"
        home = getattr(v, "__module__", None) or ""
        return callable(v) and (home == ref.__name__ or (
            hasattr(ref, "__path__") and home.startswith(ref.__name__ + ".")))
    want = {n for n, v in vars(ref).items() if not n.startswith("_") and own(v)}
    got = vars(importlib.import_module(f"smpltpu_torch.{module}"))
    missing = sorted(want - set(got) - LEFT_IN_JAX.get(module, set()))
    assert want and not missing, missing
