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

import contextlib
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
           "adam.cu", "albedo.cu", "stream.cu", "far.cu", "beam.cu", "splat.cu", "prepass.cu",
           "flat.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600
MAX_LEVELS = 12  # VHX_MAX_LEVELS in traverse.cuh
KMAX = 32  # VHX_KMAX in frames.cu: cameras a launch
FAR_MAX_LAYERS = 8  # VHX_FAR_MAX_LAYERS in far.cu: the window and its rings
BEAM_MAX_GRIDS = 8  # VHX_BEAM_MAX_GRIDS in beam.cu: beam levels a launch
PREPASS_MAX_LEVELS = 8  # VHX_PREPASS_MAX_LEVELS in prepass.cu: levels a launch

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


class TraceOptions(ctypes.Structure):
    """Mirror of ``struct TraceOptions`` in traverse.cuh: the automaton
    options of the optioned instances."""

    _fields_ = [
        ("lateral_step", ctypes.c_int),
        ("parent_skip", ctypes.c_int),
        ("advance_substeps", ctypes.c_int),
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
    """Mirror of ``struct FrameCam`` in frame.cuh."""

    _fields_ = [
        ("origin", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("forward", ctypes.c_float * 3),
        ("scale", ctypes.c_float * 2),
    ]


class LodParams(ctypes.Structure):
    """Mirror of ``struct LodParams`` in frame.cu."""

    _fields_ = [
        ("mip", ctypes.c_void_p * MAX_LEVELS),
        ("mip_cells", ctypes.c_longlong * MAX_LEVELS),
        ("stop_sq", ctypes.c_float * MAX_LEVELS),
        ("n_mip", ctypes.c_int),
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


class FarLayer(ctypes.Structure):
    """Mirror of ``struct FarLayer`` in far.cu."""

    _fields_ = [
        ("trace", TraceParams),
        ("occ", ctypes.c_void_p),
        ("colors", ctypes.c_void_p),
        ("palette", ctypes.c_void_p),
        ("n_colors", ctypes.c_int),
        ("factor", ctypes.c_float),
        ("origin", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("forward", ctypes.c_float * 3),
        ("scale", ctypes.c_float * 2),
    ]


class FarParams(ctypes.Structure):
    """Mirror of ``struct FarParams`` in far.cu."""

    _fields_ = [
        ("cw", ctypes.c_float),
        ("ch", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("inside", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("layers", FarLayer * FAR_MAX_LAYERS),
    ]


class BeamGrid(ctypes.Structure):
    """Mirror of ``struct BeamGrid`` in beam.cu."""

    _fields_ = [
        ("trace", TraceParams),
        ("occ", ctypes.c_void_p),
        ("cell", ctypes.c_float),
        ("inv_cell", ctypes.c_float),
    ]


class BeamParams(ctypes.Structure):
    """Mirror of ``struct BeamParams`` in beam.cu."""

    _fields_ = [
        ("cw", ctypes.c_float),
        ("ch", ctypes.c_float),
        ("tw", ctypes.c_int),
        ("th", ctypes.c_int),
        ("n_frames", ctypes.c_int),
        ("n_grids", ctypes.c_int),
        ("grid_of", ctypes.c_int * KMAX),
        ("grids", BeamGrid * BEAM_MAX_GRIDS),
        ("cams", FrameCam * KMAX),
    ]


class SplatParams(ctypes.Structure):
    """Mirror of ``struct SplatParams`` in splat.cu."""

    _fields_ = [
        ("origin", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("forward", ctypes.c_float * 3),
        ("scale", ctypes.c_float * 2),
        ("margin", ctypes.c_float),
        ("w2", ctypes.c_int),
        ("h2", ctypes.c_int),
        ("n_points", ctypes.c_int),
    ]


class PrepassParams(ctypes.Structure):
    """Mirror of ``struct PrepassParams`` in prepass.cu."""

    _fields_ = [
        ("trace", TraceParams),
        ("cam", FrameCam),
        ("cw", ctypes.c_float),
        ("ch", ctypes.c_float),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
    ]


class FlatTreeParams(ctypes.Structure):
    """Mirror of ``struct FlatTreeParams`` in flat.cu."""

    _fields_ = [
        ("node_meta", ctypes.c_void_p),
        ("node_children", ctypes.c_void_p),
        ("node_ocbits", ctypes.c_void_p),
        ("bricks", ctypes.c_void_p),
        ("brick_ocbits", ctypes.c_void_p),
        ("start", ctypes.c_void_p),
        ("n_bricks", ctypes.c_int),
        ("brick_dim", ctypes.c_int),
        ("size", ctypes.c_float),
        ("root_meta", ctypes.c_int),
        ("limit", ctypes.c_int),
        ("max_restarts", ctypes.c_int),
        ("start_w", ctypes.c_int),
        ("half_h", ctypes.c_int),
        ("half_w", ctypes.c_int),
    ]


class FlatParams(ctypes.Structure):
    """Mirror of ``struct FlatParams`` in flat.cu."""

    _fields_ = [
        ("tree", FlatTreeParams),
        ("pow2", ctypes.c_int),
        ("tile_w", ctypes.c_int),
        ("tile_h", ctypes.c_int),
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
    ``vhx_composite_backward``, ``vhx_adam``, ``vhx_albedo_forward``,
    ``vhx_albedo_backward``, ``vhx_region_scatter``, ``vhx_coarse_rebuild``,
    ``vhx_window_shift``, ``vhx_render_far``, their forms with a start map
    ``vhx_render_frame_start``, ``vhx_render_frames_start`` and
    ``vhx_render_far_start``, ``vhx_beam``, ``vhx_splat``,
    ``vhx_splat_scratch_words``, ``vhx_prepass``, ``vhx_prepass_sync_words``,
    the skip tracer's instances ``vhx_traverse_skip``,
    ``vhx_render_frame_skip``, ``vhx_render_frames_skip``, ``vhx_render_far_skip``,
    the multi-hit march's start and skip forms ``vhx_multihit_start`` and
    ``vhx_multihit_skip``, the LOD frame ``vhx_render_frame_lod`` and its
    stopless instance ``vhx_render_frame_lod_stopless``, the skip
    rows' refresh ``vhx_skip_rows``, the depth prepass's chained form
    ``vhx_prepass_chain``, and the entries that take the automaton's options
    and the color grid's width, which the wrappers call: ``vhx_traverse_ex``,
    ``vhx_render_frame_ex``, ``vhx_render_frame_lod_ex``,
    ``vhx_render_frames_ex`` and ``vhx_prepass_ex``), and the flat-tree
    tracers ``vhx_flat_vmap``, ``vhx_flat_wavefront``, ``vhx_flat_fast`` and
    ``vhx_flat_fast_depth``, built first if needed."""
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
            opts_p, u = ctypes.POINTER(TraceOptions), ctypes.c_uint
            signatures = {
                "traverse.cu": {
                    "vhx_traverse": [p, p, p, p, trace_p, i, p, p, p, p, p, i, p],
                    "vhx_traverse_skip": [p, p, p, p, trace_p, i, i, p, p, p, p, p, i, p],
                    "vhx_traverse_ex": [p, p, p, p, trace_p, opts_p, i, i, i, p, p, p, p, p, i,
                                        p],
                },
                "shade.cu": {"vhx_shade": [p, p, p, p, i, f, f, f, i, p, p, i, p]},
                "frame.cu": {
                    "vhx_render_frame": [p, p, p, i, ctypes.POINTER(FrameParams), p, p, i, p],
                    "vhx_render_frame_start": [p, p, p, i, ctypes.POINTER(FrameParams), p, i, p,
                                               p, i, p],
                    "vhx_render_frame_skip": [p, p, p, i, ctypes.POINTER(FrameParams), i, p, i,
                                              p, p, i, p],
                    "vhx_render_frame_lod": [p, p, p, i, ctypes.POINTER(FrameParams),
                                             ctypes.POINTER(LodParams), p, i, p],
                    "vhx_render_frame_lod_stopless": [p, p, p, i, ctypes.POINTER(FrameParams),
                                                      ctypes.POINTER(LodParams), p, i, p],
                    "vhx_render_frame_ex": [p, p, p, i, ctypes.POINTER(FrameParams), opts_p, i,
                                            i, p, i, p, p, i, p],
                    "vhx_render_frame_lod_ex": [p, p, p, i, ctypes.POINTER(FrameParams),
                                                ctypes.POINTER(LodParams), i, i, p, i, p],
                },
                "frames.cu": {
                    "vhx_render_frames": [p, p, p, i, ctypes.POINTER(FramesParams), p, p, p, p,
                                          i, p],
                    "vhx_render_frames_start": [p, p, p, i, ctypes.POINTER(FramesParams), p, i,
                                                ctypes.c_uint, p, p, p, p, i, p],
                    "vhx_render_frames_skip": [p, p, p, i, ctypes.POINTER(FramesParams), i, p, i,
                                               ctypes.c_uint, p, p, p, p, i, p],
                    "vhx_render_frames_ex": [p, p, p, i, ctypes.POINTER(FramesParams), opts_p, i,
                                             i, p, i, u, p, p, p, p, i, p],
                },
                "multihit.cu": {
                    "vhx_multihit": [p, p, p, trace_p, i, i, p, p, p, i, p],
                    "vhx_multihit_start": [p, p, p, trace_p, i, i, p, i, i, p, p, p, i, p],
                    "vhx_multihit_skip": [p, p, p, trace_p, i, i, i, p, i, i, p, p, p, i, p],
                },
                "composite.cu": {
                    "vhx_composite_forward": [p, p, p, i, i, i, f3, p, i, p],
                    "vhx_composite_backward": [p, p, p, p, p, i, i, i, f3, p, p, i, p],
                },
                "adam.cu": {"vhx_adam": [p, p, p, p, ll, p, p, p, p, ll, p, p,
                                         ctypes.POINTER(AdamParams), i, p]},
                "albedo.cu": {
                    "vhx_albedo_forward": [p, p, p, p, p, i, i, i, f3, p, i, p],
                    "vhx_albedo_backward": [p, p, p, p, p, i, i, i, p, i, p],
                },
                "stream.cu": {
                    "vhx_region_scatter": [p, p, p, p, p, i, i, i, i, p],
                    "vhx_coarse_rebuild": [p, ctypes.POINTER(i), ctypes.POINTER(i), i, p, i, p],
                    "vhx_window_shift": [p, p, p, p, i, i, i, i, i, i, p],
                    "vhx_skip_rows": [p, p, ctypes.POINTER(i), ctypes.POINTER(i), i, i, p],
                },
                "far.cu": {
                    "vhx_render_far": [ctypes.POINTER(FarParams), p, p, i, p],
                    "vhx_render_far_start": [ctypes.POINTER(FarParams), p, i, p, p, i, p],
                    "vhx_render_far_skip": [ctypes.POINTER(FarParams), i, p, i, p, p, i, p],
                },
                "beam.cu": {"vhx_beam": [ctypes.POINTER(BeamParams), p, i, p]},
                "splat.cu": {
                    "vhx_splat": [p, ctypes.POINTER(SplatParams), p, i, p, i, p],
                },
                "prepass.cu": {
                    "vhx_prepass": [p, ctypes.POINTER(PrepassParams), i, i,
                                    ctypes.POINTER(p), p, p, i, i, p],
                    "vhx_prepass_chain": [p, ctypes.POINTER(PrepassParams), i, i,
                                          ctypes.POINTER(p), p, p, p, i, i, p],
                    "vhx_prepass_ex": [p, ctypes.POINTER(PrepassParams), i, i, opts_p,
                                       ctypes.POINTER(p), p, p, p, i, i, p],
                },
                "flat.cu": {
                    name: [ctypes.POINTER(FlatParams), p, p, i, p, p, p, p, p, p, i, p]
                    for name in ("vhx_flat_vmap", "vhx_flat_wavefront", "vhx_flat_fast")
                } | {"vhx_flat_fast_depth": [ctypes.POINTER(FlatParams), p, p, i, p, i, p]},
            }
            fns = {}
            for source, entries in signatures.items():
                for name, argtypes in entries.items():
                    fn = getattr(dlls[source], name)
                    fn.argtypes, fn.restype = argtypes, i
                    fns[name] = fn
            for source, name, struct in (("traverse.cu", "vhx_trace_params_size", TraceParams),
                                         ("traverse.cu", "vhx_trace_options_size",
                                          TraceOptions),
                                         ("multihit.cu", "vhx_multihit_params_size", TraceParams),
                                         ("frame.cu", "vhx_frame_params_size", FrameParams),
                                         ("frame.cu", "vhx_lod_params_size", LodParams),
                                         ("frames.cu", "vhx_frames_params_size", FramesParams),
                                         ("far.cu", "vhx_far_params_size", FarParams),
                                         ("beam.cu", "vhx_beam_params_size", BeamParams),
                                         ("splat.cu", "vhx_splat_params_size", SplatParams),
                                         ("prepass.cu", "vhx_prepass_params_size",
                                          PrepassParams),
                                         ("adam.cu", "vhx_adam_params_size", AdamParams),
                                         ("flat.cu", "vhx_flat_params_size", FlatParams)):
                fn = getattr(dlls[source], name)
                fn.argtypes, fn.restype = [], i
                if fn() != ctypes.sizeof(struct):
                    raise RuntimeError(f"{struct.__name__}: {fn()} B in C, "
                                       f"{ctypes.sizeof(struct)} B in ctypes")
            kmax = dlls["frames.cu"].vhx_frames_kmax
            kmax.argtypes, kmax.restype = [], i
            if kmax() != KMAX:
                raise RuntimeError(f"VHX_KMAX is {kmax()} in C, KMAX {KMAX} in ctypes")
            layers = dlls["far.cu"].vhx_far_max_layers
            layers.argtypes, layers.restype = [], i
            if layers() != FAR_MAX_LAYERS:
                raise RuntimeError(f"VHX_FAR_MAX_LAYERS is {layers()} in C, FAR_MAX_LAYERS "
                                   f"{FAR_MAX_LAYERS} in ctypes")
            for source, name, args in (("splat.cu", "vhx_splat_scratch_words", [i, i]),
                                       ("prepass.cu", "vhx_prepass_sync_words", [i, i, i])):
                fn = getattr(dlls[source], name)
                fn.argtypes, fn.restype = args, ll
                fns[name] = fn
            levels = dlls["prepass.cu"].vhx_prepass_max_levels
            levels.argtypes, levels.restype = [], i
            if levels() != PREPASS_MAX_LEVELS:
                raise RuntimeError(f"VHX_PREPASS_MAX_LEVELS is {levels()} in C, "
                                   f"PREPASS_MAX_LEVELS {PREPASS_MAX_LEVELS} in ctypes")
            grids = dlls["beam.cu"].vhx_beam_max_grids
            grids.argtypes, grids.restype = [], i
            if grids() != BEAM_MAX_GRIDS:
                raise RuntimeError(f"VHX_BEAM_MAX_GRIDS is {grids()} in C, BEAM_MAX_GRIDS "
                                   f"{BEAM_MAX_GRIDS} in ctypes")
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


class StreamScratch:
    """Int32 words on the card that a kernel keeps from launch to launch,
    one buffer a (device, stream), zero when made or grown, and each
    launch's epoch (1, 2, ...), which tags what the launch writes there, so
    that no launch clears them first.  :meth:`take` holds a lock until the
    launch is enqueued, so the epochs rise in the stream's order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buffers = {}

    @contextlib.contextmanager
    def take(self, dev, n_words):
        """``(words, epoch)`` for one launch on ``dev``'s current stream:
        at least ``n_words`` int32 words, 256 B aligned."""
        import torch

        key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        with self._lock:
            words, epoch = self._buffers.get(key, (None, 0))
            epoch += 1
            if words is None or words.numel() < n_words or epoch >= 2**31:
                n = n_words if words is None else max(n_words, words.numel())
                words, epoch = torch.zeros(n, dtype=torch.int32, device=dev), 1
            self._buffers[key] = (words, epoch)
            yield words, epoch


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
