"""Build and load the port's CUDA kernels.

The sources under ``smpltpu_torch/csrc/`` are compiled by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use (never at import), into ``build/smpltpu_torch/`` at the root
of the checkout, and is keyed by a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one is loaded as it is.
Nothing outside the checkout is used except the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
SOURCES = ("arrow_pcg.cu", "lbs.cu", "raster.cu")
BUILD_DIR = _PKG.parent / "build" / "smpltpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "smpltpu_arrow_pcg_f32": (_I, [_P] * 10 + [_I] * 5 + [ctypes.c_float]
                              + [_I] * 6 + [_P]),
    "smpltpu_arrow_pcg_limits": (_I, [_P]),
    "smpltpu_lbs_f32": (_I, [_P] * 6 + [_I] * 4 + [_P]),
    "smpltpu_raster_i32": (_I, [_P] * 5 + [_I] * 4 + [_P] * 8),
    "smpltpu_raster_verts_f32": (_I, [_P] + [ctypes.c_longlong] * 3 + [_I, _P]
                                 + [ctypes.c_float] * 4 + [_I] * 4 + [_P] * 8),
}

_lib = None
# what the last load did: {"built": bool, "seconds": float, "path": str,
# "log": compiler output (register and spill counts from -Xptxas -v)}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of smpltpu_torch "
                       "need the CUDA toolkit to build")


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if the sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((_CSRC / name).read_bytes())
    so = BUILD_DIR / f"libsmpltpu_torch_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    built = not so.is_file()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{name}.{tag}.o" for name in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(_CSRC / name)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for name, o in zip(SOURCES, objs)]
        failed = []
        for name, proc in zip(SOURCES, procs):
            out = proc.communicate()[0]
            log += f"== {name}\n{out}"
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        for o in objs:
            o.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn, (res, args) in _SIGNATURES.items():
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    build_info.update(built=built, seconds=time.perf_counter() - t0,
                      path=str(so), log=log)
    _lib = lib
    return lib
