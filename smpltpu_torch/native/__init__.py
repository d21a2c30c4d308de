"""The host runtime (port of ``smpltpu/native``): a parallel MediaPipe-JSON
keypoint parser and a triangle fill in C++, bound with ``ctypes``.

The source is the port's own, ``smpltpu_torch/csrc/host/smpltpu_native.cpp``.
It is built with the host's C++ compiler (``CXX``, ``g++``) at first use,
never at import, into ``build/smpltpu_torch/host/`` at the root of the
checkout. The library's name carries a hash of the source, the flags and the
machine's architecture, so an edited source rebuilds, an unchanged one is
loaded as it is, and a checkout shared by two kinds of host keeps one
library for each. The
compiler writes to a name of its own process and the result is renamed
into place, so processes that build at once each load a whole library.

No fallback hides a failed build: :func:`ensure_built` raises
:class:`NativeBuildError` with the compiler's output, and so does every
entry point. :func:`available` answers the question without raising.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "smpltpu_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "smpltpu_torch" / "host"
CXX = "g++"
# no -march: the library may be built on one host and loaded on another
# that shares the checkout; no fused multiply-add, so the fill's edge
# functions round as the numpy fill's do
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
             "-ffp-contract=off")

_P = ctypes.c_void_p
_SIGNATURES = {
    "smpltpu_parse_mp_json": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_long,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_double, _P]),
    "smpltpu_parse_mp_json_files": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, _P]),
    "smpltpu_fill_triangles": (None, [_P, ctypes.c_int, ctypes.c_int, _P, _P,
                                      ctypes.c_long]),
}

_lock = threading.Lock()
_lib = None
# what the last load did: {"built": bool, "seconds": float, "path": str}
build_info: dict = {}


class NativeBuildError(RuntimeError):
    """The host runtime could not be built or loaded."""


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join((platform.machine(),) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsmpltpu_native_{h.hexdigest()[:16]}.so"


def ensure_built() -> ctypes.CDLL:
    """Return the library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        t0 = time.perf_counter()
        built = not so.is_file()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}."
                               f"{threading.get_ident()}.tmp")
            try:
                proc = subprocess.run(
                    [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                     "-lpthread"], capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(
                    f"cannot run the C++ compiler {CXX!r}: {e}; "
                    "load_keypoint_dir(backend='python') parses without "
                    "it") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"{CXX} failed (exit {proc.returncode}) on {SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}\n"
                    "load_keypoint_dir(backend='python') parses without it")
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeBuildError(f"cannot load {so}: {e}") from e
        for fn, (res, args) in _SIGNATURES.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        build_info.update(built=built, seconds=time.perf_counter() - t0,
                          path=str(so))
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        ensure_built()
    except NativeBuildError:
        return False
    return True


def parse_mp_json_bytes(data: bytes, width: int, height: int,
                        midpoint_default_vis: float = 1.0) -> np.ndarray:
    """One JSON buffer -> dense (17, 4) [jid, u, v, valid]."""
    lib = ensure_built()
    out = np.zeros(17 * 4, dtype=np.float64)
    lib.smpltpu_parse_mp_json(data, len(data), width, height,
                              midpoint_default_vis, out.ctypes.data)
    return out.reshape(17, 4)


def load_keypoint_dir_native(paths, width: int, height: int,
                             midpoint_default_vis: float = 1.0) -> np.ndarray:
    """Parse many JSON files (a thread per core, in C++) -> (F, 17, 4)."""
    lib = ensure_built()
    n = len(paths)
    out = np.zeros((n, 17, 4), dtype=np.float64)
    if n == 0:
        return out
    lib.smpltpu_parse_mp_json_files("\n".join(paths).encode(), n, width,
                                    height, midpoint_default_vis,
                                    out.ctypes.data)
    return out


def fill_triangles(img: np.ndarray, tris: np.ndarray,
                   gray: np.ndarray) -> None:
    """In-place painter-order fill of (m, 3, 2) pixel triangles with gray
    levels (m,) on a (H, W, 3) uint8 image: the pixels and colours of
    ``render/raster.py::_fill_triangles_numpy``."""
    lib = ensure_built()
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"fill_triangles needs a (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    img_c = np.ascontiguousarray(img)
    tris_d = np.ascontiguousarray(tris, dtype=np.float64)
    gray_i = np.ascontiguousarray(gray, dtype=np.int32)
    if tris_d.shape[1:] != (3, 2) or gray_i.shape != tris_d.shape[:1]:
        raise ValueError(f"fill_triangles needs (m, 3, 2) triangles and (m,) "
                         f"gray levels, got {tris_d.shape} and {gray_i.shape}")
    lib.smpltpu_fill_triangles(img_c.ctypes.data, img.shape[0], img.shape[1],
                               tris_d.ctypes.data, gray_i.ctypes.data,
                               len(gray_i))
    if img_c is not img:
        img[:] = img_c
