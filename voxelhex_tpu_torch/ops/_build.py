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
SOURCES = ("traverse.cu", "shade.cu", "frame.cu", "frames.cu", "multihit.cu", "composite.cu",
           "adam.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600
MAX_LEVELS = 12  # VHX_MAX_LEVELS in traverse.cuh
KMAX = 32  # VHX_KMAX in frames.cu: cameras a launch

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


class FrameCam(ctypes.Structure):
    """Mirror of ``struct FrameCam`` in frames.cu."""

    _fields_ = [
        ("origin", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("forward", ctypes.c_float * 3),
        ("scale", ctypes.c_float * 2),
    ]


class FramesParams(ctypes.Structure):
    """Mirror of ``struct FramesParams`` in frames.cu."""

    _fields_ = [
        ("trace", TraceParams),
        ("cw", ctypes.c_float),
        ("ch", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("n_frames", ctypes.c_int),
        ("cams", FrameCam * KMAX),
    ]


class AdamParams(ctypes.Structure):
    """Mirror of ``struct AdamParams`` in adam.cu."""

    _fields_ = [
        ("neg_lr", ctypes.c_float),
        ("b1", ctypes.c_float),
        ("b2", ctypes.c_float),
        ("one_m_b1", ctypes.c_float),
        ("one_m_b2", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("b1_d", ctypes.c_double),
        ("b2_d", ctypes.c_double),
        ("l1_scale", ctypes.c_float),
        ("lo", ctypes.c_float * 2),
        ("hi", ctypes.c_float * 2),
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
    ``vhx_render_frame``, ``vhx_render_frames``, ``vhx_multihit``, ``vhx_composite_forward``,
    ``vhx_composite_backward``, ``vhx_adam``), built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = library_dir()
            missing = [s for s in SOURCES if not os.path.exists(_so(out_dir, s))]
            if missing:
                _build(out_dir, missing)
            dlls = {s: ctypes.CDLL(_so(out_dir, s)) for s in SOURCES}
            p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
            trace_p, f3 = ctypes.POINTER(TraceParams), ctypes.POINTER(ctypes.c_float)
            signatures = {
                "traverse.cu": {"vhx_traverse": [p, p, p, p, trace_p, i, p, p, p, p, p, i, p]},
                "shade.cu": {"vhx_shade": [p, p, p, p, i, f, f, f, i, p, p, i, p]},
                "frame.cu": {"vhx_render_frame": [p, p, p, i, ctypes.POINTER(FrameParams), p,
                                                  p, i, p]},
                "frames.cu": {"vhx_render_frames": [p, p, p, i, ctypes.POINTER(FramesParams), p,
                                                    p, p, p, i, p]},
                "multihit.cu": {"vhx_multihit": [p, p, p, trace_p, i, i, p, p, p, i, p]},
                "composite.cu": {
                    "vhx_composite_forward": [p, p, p, i, i, i, f3, p, i, p],
                    "vhx_composite_backward": [p, p, p, p, i, i, i, f3, p, p, i, p],
                },
                "adam.cu": {"vhx_adam": [p, p, p, p, ll, p, p, p, p, ll, p, p,
                                         ctypes.POINTER(AdamParams), i, p]},
            }
            fns = {}
            for source, entries in signatures.items():
                for name, argtypes in entries.items():
                    fn = getattr(dlls[source], name)
                    fn.argtypes, fn.restype = argtypes, i
                    fns[name] = fn
            for source, name, struct in (("traverse.cu", "vhx_trace_params_size", TraceParams),
                                         ("multihit.cu", "vhx_multihit_params_size", TraceParams),
                                         ("frame.cu", "vhx_frame_params_size", FrameParams),
                                         ("frames.cu", "vhx_frames_params_size", FramesParams),
                                         ("adam.cu", "vhx_adam_params_size", AdamParams)):
                fn = getattr(dlls[source], name)
                fn.argtypes, fn.restype = [], i
                if fn() != ctypes.sizeof(struct):
                    raise RuntimeError(f"{struct.__name__}: {fn()} B in C, "
                                       f"{ctypes.sizeof(struct)} B in ctypes")
            kmax = dlls["frames.cu"].vhx_frames_kmax
            kmax.argtypes, kmax.restype = [], i
            if kmax() != KMAX:
                raise RuntimeError(f"VHX_KMAX is {kmax()} in C, KMAX {KMAX} in ctypes")
            _lib = types.SimpleNamespace(dlls=dlls, **fns)
        return _lib


def check_inputs(dev, specs) -> None:
    """Raise unless each ``(name, tensor, dtype, shape)`` of ``specs`` is a
    contiguous tensor of that dtype and shape on ``dev``."""
    for name, t, dtype, shape in specs:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dtype} {tuple(shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
