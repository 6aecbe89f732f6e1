"""ctypes loader for the native host-ops library (``hostops.cc``, a copy of
the JAX package's; host code, not a device kernel).

The library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/pcseg_tpu_torch/hostops-<hash>.so`` at the root
of the checkout (listed in ``.gitignore``), keyed by a hash of the source
like the CUDA kernels (kernels/build.py). :func:`load_hostops` returns
None when there is no host compiler or the build fails; the callers
(models/boundary.py, utils/hostgeom.py) then take their NumPy paths, and
the pipeline's mean shift its device growth (models/mean_shift.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

from pcseg_tpu_torch.kernels.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hostops.cc")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_TRIED = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"hostops-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, out)
    return True


def load_hostops() -> Optional[ctypes.CDLL]:
    """The loaded host-ops library, built if needed; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.pcseg_moore_trace.restype = ctypes.c_int64
    lib.pcseg_moore_trace.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.pcseg_flood_outside.restype = None
    lib.pcseg_flood_outside.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.pcseg_convex_hull_2d.restype = ctypes.c_int64
    lib.pcseg_convex_hull_2d.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.pcseg_mean_shift_grid.restype = ctypes.c_int32
    lib.pcseg_mean_shift_grid.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pcseg_mean_shift_shift.restype = None
    lib.pcseg_mean_shift_shift.argtypes = [
        f32p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        i32p, f32p, f32p, f32p, u8p, f32p]
    lib.pcseg_mean_shift_grow.restype = ctypes.c_int32
    lib.pcseg_mean_shift_grow.argtypes = [
        f32p, u8p, ctypes.c_int32, ctypes.c_int32, f32p, f32p, f32p, u8p,
        f32p, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p]
    lib.pcseg_cluster_unorganized.restype = ctypes.c_int32
    lib.pcseg_cluster_unorganized.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_float,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.pcseg_mean_shift_points.restype = ctypes.c_int32
    lib.pcseg_mean_shift_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return _LIB
