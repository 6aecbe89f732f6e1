"""Build and load the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers taking raw device
pointers, sizes and a stream. It is compiled once, at first use, for
``sm_90a`` into ``build/pcseg_tpu_torch/<name>-<hash>.so`` at the root of
the checkout (listed in ``.gitignore``); the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds. Nothing here runs at import time.

``-Xptxas -v`` makes each build report its kernels' registers, shared
memory and spills; ``build_all`` returns those lines.

The flags carry no ``--use_fast_math`` (the plane-distance gates compare
NaN points) and ``--fmad=false``: every f32 multiply and add rounds on its
own, exactly as the plain PyTorch versions evaluate them, so kernel and
plain version agree bit for bit on the gate words.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pcseg_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]
SOURCES = ("epoch_word", "ccl_gated", "flood_packed", "normal_support",
           "mean_shift_modes")

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, output path, temp path)."""
    out = library_path(name)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish_build(name, proc, out, tmp) -> list:
    """Wait for nvcc; returns its report of each kernel's registers, shared
    memory and spills (nothing when the library was built before)."""
    if proc is None:
        return []
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    keep = ("Compiling entry", "Used ", "spill stores")
    return [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def build_all(names=SOURCES):
    """Compile every listed source not built yet, one nvcc each, all
    started together. Returns (wall seconds, {name: ptxas info lines})."""
    t0 = time.perf_counter()
    jobs = [(n, *_start_build(n)) for n in names]
    report = {job[0]: _finish_build(*job) for job in jobs}
    return time.perf_counter() - t0, report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish_build(name, *_start_build(name))
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
