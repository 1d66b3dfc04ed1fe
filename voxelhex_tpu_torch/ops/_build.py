"""Builds the CUDA kernels with ``nvcc`` at first use and loads them.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface, loaded
with ``ctypes``.  The libraries are ``build/voxelhex_tpu_torch/<hash>/
lib<source>.so`` beside the package, where the hash covers every file of
``csrc/``, the flags, the compiler (path and version) and this module, so a
change to any of them builds anew and an unchanged one loads at once.  Each
is compiled under a temporary name and moved into place with ``os.replace``:
a build that is cut off leaves no partial library and no lock behind.

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
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "voxelhex_tpu_torch")
SOURCES = ("traverse.cu", "shade.cu", "frame.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600
MAX_LEVELS = 12  # VHX_MAX_LEVELS in traverse.cuh

_lock = threading.Lock()
_lib = None


class TraceParams(ctypes.Structure):
    """Mirror of ``struct TraceParams`` in traverse.cuh."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("bases", ctypes.c_int * MAX_LEVELS),
        ("dims", ctypes.c_int * MAX_LEVELS),
        ("size", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
        ("max_iters", ctypes.c_int),
    ]


class FrameParams(ctypes.Structure):
    """Mirror of ``struct FrameParams`` in frame.cu."""

    _fields_ = [
        ("trace", TraceParams),
        ("origin", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("forward", ctypes.c_float * 3),
        ("scale", ctypes.c_float * 2),
        ("cw", ctypes.c_float),
        ("ch", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
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


def library_dir() -> str:
    """Where the libraries of these sources, flags, compiler and this module
    (which mirrors the C structs) live."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_nvcc_id())
    with open(os.path.abspath(__file__), "rb") as f:
        h.update(f.read())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16])


def _so(out_dir: str, source: str) -> str:
    return os.path.join(out_dir, f"lib{os.path.splitext(source)[0]}.so")


def build_log(source: str) -> str:
    """What ``nvcc -Xptxas -v`` printed when ``source`` was built."""
    path = _so(library_dir(), source)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _build(out_dir: str, sources) -> None:
    """Compile ``sources``, one ``nvcc`` each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    try:
        for name in sources:
            tmp = f"{_so(out_dir, name)}.{os.getpid()}.tmp"
            log = open(f"{tmp}.log", "w")
            cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name)]
            jobs.append((name, tmp, log, subprocess.Popen(cmd, stdout=log,
                                                          stderr=subprocess.STDOUT)))
        failed = {}
        for name, _tmp, _log, proc in jobs:
            rc = proc.wait(timeout=BUILD_TIMEOUT_S)
            if rc != 0:
                failed[name] = rc
    finally:
        for _name, _tmp, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    messages = []
    for name, tmp, _log, _proc in jobs:
        with open(f"{tmp}.log") as f:
            text = f.read()
        if name in failed:
            messages.append(f"nvcc {name} failed ({failed[name]}):\n{text}")
            for path in (tmp, f"{tmp}.log"):
                if os.path.exists(path):
                    os.remove(path)
            continue
        final = _so(out_dir, name)
        os.replace(f"{tmp}.log", final[:-3] + ".log")
        os.replace(tmp, final)
    if messages:
        raise RuntimeError("\n".join(messages))


def library() -> types.SimpleNamespace:
    """The kernels' C entry points (``vhx_traverse``, ``vhx_shade``,
    ``vhx_render_frame``), built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = library_dir()
            missing = [s for s in SOURCES if not os.path.exists(_so(out_dir, s))]
            if missing:
                _build(out_dir, missing)
            dlls = {s: ctypes.CDLL(_so(out_dir, s)) for s in SOURCES}
            trav, shade, frame = dlls["traverse.cu"], dlls["shade.cu"], dlls["frame.cu"]
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            trav.vhx_traverse.argtypes = [p, p, p, p, ctypes.POINTER(TraceParams), i,
                                          p, p, p, p, p, i, p]
            trav.vhx_traverse.restype = i
            shade.vhx_shade.argtypes = [p, p, p, p, i, f, f, f, i, p, p, i, p]
            shade.vhx_shade.restype = i
            frame.vhx_render_frame.argtypes = [p, p, p, i, ctypes.POINTER(FrameParams), p, p,
                                               i, p]
            frame.vhx_render_frame.restype = i
            for fn, struct in ((trav.vhx_trace_params_size, TraceParams),
                               (frame.vhx_frame_params_size, FrameParams)):
                fn.argtypes, fn.restype = [], i
                if fn() != ctypes.sizeof(struct):
                    raise RuntimeError(f"{struct.__name__}: {fn()} B in C, "
                                       f"{ctypes.sizeof(struct)} B in ctypes")
            _lib = types.SimpleNamespace(
                vhx_traverse=trav.vhx_traverse, vhx_shade=shade.vhx_shade,
                vhx_render_frame=frame.vhx_render_frame, dlls=dlls,
            )
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
