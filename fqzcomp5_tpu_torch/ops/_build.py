"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, nvcc compiles every source under ``csrc/`` for ``sm_90a``
into one shared library with a plain C interface, under
``build/fqz5_torch_kernels/`` at the repository root, and ``ctypes``
loads it.  The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.  A build
or load failure raises: there is no other route to the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "fqz5_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last build in this process took (0.0 when a built
# library was reused); read by chip_smoke.py
build_seconds = 0.0


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fp:
            h.update(os.path.basename(src).encode() + fp.read())
    return os.path.join(BUILD_DIR, f"libfqz5_torch_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.monotonic() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as fp:
        fp.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none


def _register(L: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    L.fqz5_rans_encode_walk.restype = i32
    L.fqz5_rans_encode_walk.argtypes = [
        vp, i32, vp, vp, i64, i32, vp, i32, i32, i32, vp, vp, vp, vp]
    L.fqz5_rans_decode_o0.restype = i32
    L.fqz5_rans_decode_o0.argtypes = [
        vp, i64, vp, vp, vp, i32, i32, vp, vp, vp]
    L.fqz5_rans_decode_o1.restype = i32
    L.fqz5_rans_decode_o1.argtypes = [
        vp, i64, vp, vp, i32, vp, i32, i32, vp, vp, vp, vp]


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            L = ctypes.CDLL(path)
            _register(L)
            _lib = L
        return _lib


def check(rc: int, what: str) -> None:
    """Raise for a non-zero cudaGetLastError() code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
