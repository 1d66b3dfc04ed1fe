"""Builds the CUDA kernels with ``nvcc`` at first use and loads them.

All sources under ``csrc/`` go through one ``nvcc`` command into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
``build/voxelhex_tpu_torch/libvhx_<hash>.so`` beside the package, where the
hash covers the sources, the flags, the compiler (path and version) and this
module, so a change to any of them builds anew and an unchanged one loads at
once.  It is compiled under a temporary name and
moved into place with ``os.replace``: a build that is cut off leaves no
partial library and no lock behind.

Importing this module builds nothing; only :func:`library` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "voxelhex_tpu_torch")
SOURCES = ("traverse.cu", "shade.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_LEVELS = 12  # VHX_MAX_LEVELS in traverse.cu

_lock = threading.Lock()
_lib = None


class TraceParams(ctypes.Structure):
    """Mirror of ``struct TraceParams`` in traverse.cu."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("bases", ctypes.c_int * MAX_LEVELS),
        ("dims", ctypes.c_int * MAX_LEVELS),
        ("size", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
        ("max_iters", ctypes.c_int),
    ]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def _nvcc_id() -> bytes:
    """The compiler's path and ``--version`` text."""
    nvcc = _nvcc()
    out = subprocess.run([nvcc, "--version"], capture_output=True, timeout=60)
    return nvcc.encode() + b"\0" + out.stdout


def library_path() -> str:
    """Where the library of these sources, flags, compiler and this module
    (which mirrors the C structs) lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_nvcc_id())
    with open(os.path.abspath(__file__), "rb") as f:
        h.update(f.read())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libvhx_{h.hexdigest()[:16]}.so")


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` printed when the library was built."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", path[:-3] + ".log")
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.vhx_traverse.argtypes = [p, p, p, p, ctypes.POINTER(TraceParams), i,
                                         p, p, p, p, p, i, p]
            lib.vhx_traverse.restype = i
            lib.vhx_shade.argtypes = [p, p, p, p, i, f, f, f, i, p, p, i, p]
            lib.vhx_shade.restype = i
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
