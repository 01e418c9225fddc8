"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, nvcc compiles every source under ``csrc/`` for ``sm_90a``
(one nvcc process per source, all started together) and links the
objects into one shared library with a plain C interface, under
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
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "fqz5_torch_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

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
    nvcc = _nvcc()
    t0 = time.monotonic()
    # objects live in a private directory that is removed whatever happens
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as odir:
        srcs = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(odir, os.path.basename(s) + ".o") for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, text=True,
                                  stderr=subprocess.STDOUT) for c in cmds]
        steps = [(c, p.communicate()[0], p.returncode)
                 for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in steps):
            link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
            res = subprocess.run(link, stdout=subprocess.PIPE, text=True,
                                 stderr=subprocess.STDOUT)
            steps.append((link, res.stdout, res.returncode))
    build_seconds = time.monotonic() - t0
    log = [" ".join(c) + "\n" + out for c, out, _ in steps]
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as fp:
        fp.write("\n".join(log))
    failed = [entry for entry, (_, _, rc) in zip(log, steps) if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
        vp, i64, vp, vp, i32, vp, i32, i32, vp, vp, vp, vp, i64, vp]
    L.fqz5_rans_decode_bnd_o0.restype = i32
    L.fqz5_rans_decode_bnd_o0.argtypes = [
        vp, i64, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp]
    L.fqz5_rans_decode_dense_o1.restype = i32
    L.fqz5_rans_decode_dense_o1.argtypes = [
        vp, i64, vp, vp, i32, i32, i32, vp, i32, i32, i32, vp, vp, vp, vp,
        i64, vp]
    L.fqz5_evolve.restype = i32
    L.fqz5_evolve.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp, vp]
    L.fqz5_tiny_evolve.restype = i32
    L.fqz5_tiny_evolve.argtypes = [vp, vp, i32, i32, i32, vp, vp, vp]
    L.fqz5_rc_encode_walk.restype = i32
    L.fqz5_rc_encode_walk.argtypes = [
        vp, vp, vp, vp, vp, i32, i64, vp, vp, vp, vp]


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


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches``: the host driver's
    worker threads launch kernels at once, and ``+=`` on an attribute
    is not atomic."""
    with _count_lock:
        wrapper.launches += 1


def check(rc: int, what: str) -> None:
    """Raise for a non-zero cudaGetLastError() code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
