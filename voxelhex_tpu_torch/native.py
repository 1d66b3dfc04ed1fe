"""The scene model's host library: ``host/rasterize.cpp`` built with g++
at first use and bound with ``ctypes``.

The library is ``build/voxelhex_tpu_torch/host-<hash>/librasterize.so``
beside the package, where the hash covers the source, the flags, the
compiler (path and version) and this module; it is compiled under a
temporary name and moved into place with ``os.replace``, so processes that
build it at once each leave a whole library.  A failed build raises: the
NumPy versions run only where a caller asks for them (``native=False``).
Importing this module builds nothing.
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

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "host", "rasterize.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "voxelhex_tpu_torch")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the scene model's host library cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def _compiler_id() -> bytes:
    cxx = _compiler()
    out = subprocess.run([cxx, "--version"], capture_output=True, timeout=60)
    return cxx.encode() + b"\0" + out.stdout


def library_path() -> str:
    """Where the library of this source, these flags, this compiler and this
    module lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_compiler_id())
    for path in (SOURCE, os.path.abspath(__file__)):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"host-{h.hexdigest()[:16]}", "librasterize.so")


def _build(so: str) -> None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    out = subprocess.run([_compiler(), *FLAGS, SOURCE, "-o", tmp], capture_output=True,
                         text=True, timeout=BUILD_TIMEOUT_S)
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ {os.path.basename(SOURCE)} failed ({out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)


def library() -> types.SimpleNamespace:
    """The library's entry points, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            dll = ctypes.CDLL(so)

            def ptr(dtype):
                return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

            i32, i64, u32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32
            signatures = {
                "rasterize_flat": [ptr(np.uint32), ptr(np.int32), ptr(np.int32), i32, i32, i32,
                                   i32, ptr(np.uint8), ptr(np.uint16)],
                "pack_level": [ptr(np.uint8), i32, ptr(np.uint32), ptr(np.uint32),
                               ptr(np.uint8)],
                "bulk_group_sort": [ptr(np.int64), i64, i32, i32, ptr(np.int64),
                                    ptr(np.int64), ptr(np.int64)],
                "bulk_group_fill": [ptr(np.uint32), ptr(np.int64), ptr(np.int64), i64, i32, u32,
                                    ptr(np.int64), ptr(np.uint32), ptr(np.uint64),
                                    ptr(np.uint8)],
                "rasterize_window": [ptr(np.uint32), ptr(np.int32), ptr(np.int32), i32, i32,
                                     i32, i32, i32, i32, i32, i32, ptr(np.uint8),
                                     ptr(np.uint16)],
                "rasterize_regions": [ptr(np.uint32), ptr(np.int32), ptr(np.int32), i32, i32,
                                      i32, i32, ptr(np.int32), i32, i32, ptr(np.uint8),
                                      ptr(np.uint16), ptr(np.uint32), ptr(np.uint32)],
            }
            fns = {}
            for name, argtypes in signatures.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int32 if name.startswith("rasterize") else None
                fns[name] = fn
            _lib = types.SimpleNamespace(dll=dll, **fns)
        return _lib


def bulk_group(positions: np.ndarray, packed: np.ndarray, size: int, d: int,
               empty_voxel: int):
    """Point voxels grouped into bricks of edge ``d``:
    ``(uniq_cells int64 [M], bricks uint32 [M, d^3], occ uint64 [M], solid
    bool [M])``, the bricks in ascending cell id, the last of equal
    positions winning."""
    lib = library()
    pos = np.ascontiguousarray(positions, dtype=np.int64).reshape(-1, 3)
    pk = np.ascontiguousarray(packed, dtype=np.uint32).reshape(-1)
    n = pos.shape[0]
    if pk.shape[0] != n:
        raise ValueError(f"{n} positions, {pk.shape[0]} packed voxels")
    if n and (pos.min() < 0 or pos.max() >= size):
        raise ValueError("voxel positions out of bounds")
    if size % d:
        raise ValueError(f"size {size} is not a multiple of the brick edge {d}")
    keys = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    m_out = np.zeros(1, dtype=np.int64)
    lib.bulk_group_sort(pos, n, size, d, keys, order, m_out)
    m = int(m_out[0])
    uniq_cells = np.empty(m, dtype=np.int64)
    bricks = np.full((m, d**3), np.uint32(empty_voxel), dtype=np.uint32)
    occ = np.zeros(m, dtype=np.uint64)
    solid = np.zeros(m, dtype=np.uint8)
    lib.bulk_group_fill(pk, keys, order, n, d, int(empty_voxel), uniq_cells,
                        bricks.reshape(-1), occ, solid)
    return uniq_cells, bricks, occ, solid.astype(bool)


# the rasterizers' faults, by the codes host/rasterize.cpp returns
RASTER_FAULTS = {1: "a node key out of range", 2: "a brick descriptor out of range",
                 3: "a node below the voxel level"}


def _flat_arrays(flat):
    """A FlatTree's ``(meta, children, bricks)`` as the library reads them."""
    meta = np.ascontiguousarray(flat.node_meta, dtype=np.uint32)
    children = np.ascontiguousarray(flat.node_children, dtype=np.int32)
    bricks = np.ascontiguousarray(flat.bricks, dtype=np.int32)
    d = int(flat.brick_dim)
    if children.shape != (meta.shape[0], 64) or bricks.shape[1:] != (d**3,):
        raise ValueError(f"FlatTree arrays of shapes {meta.shape}, {children.shape}, "
                         f"{bricks.shape} for brick_dim {d}")
    return meta, children, bricks


def _check_fault(fault: int) -> None:
    if fault:
        raise ValueError(f"malformed FlatTree: {RASTER_FAULTS[fault]}")


def rasterize_flat(flat):
    """A FlatTree's dense ``(occ u8 [S^3], colors u16 [S^3])`` grids, x
    fastest; an empty voxel has color 0xFFFF.  A malformed FlatTree raises
    ``ValueError``, as ``render.bitgrid._dense_from_flat`` does."""
    lib = library()
    S = int(flat.size)
    meta, children, bricks = _flat_arrays(flat)
    occ = np.zeros(S * S * S, dtype=np.uint8)
    colors = np.full(S * S * S, 0xFFFF, dtype=np.uint16)
    _check_fault(lib.rasterize_flat(meta, children, bricks, meta.shape[0], bricks.shape[0],
                                    int(flat.brick_dim), S, occ, colors))
    return occ, colors


def rasterize_window(flat, wx: int, wy: int, wz: int, wsize: int):
    """The dense ``(occ u8 [wsize^3], colors u16 [wsize^3])`` grids, x
    fastest, of the world window ``[wx, wx + wsize) x [wy, ..) x [wz, ..)``
    of a FlatTree, walking only the nodes that overlap it; an empty voxel
    has color 0xFFFF.  A malformed FlatTree raises ``ValueError``."""
    lib = library()
    meta, children, bricks = _flat_arrays(flat)
    n = int(wsize) ** 3
    occ = np.zeros(n, dtype=np.uint8)
    colors = np.full(n, 0xFFFF, dtype=np.uint16)
    _check_fault(lib.rasterize_window(meta, children, bricks, meta.shape[0], bricks.shape[0],
                                      int(flat.brick_dim), int(flat.size), int(wx), int(wy),
                                      int(wz), int(wsize), occ, colors))
    return occ, colors


def rasterize_regions(flat, corners: np.ndarray, rsize: int):
    """K windows of ``rsize^3`` at ``corners`` (int [K, 3] world voxels),
    each painted and packed into its 4^3 blocks' occupancy words in one
    call: ``(occ u8 [K, r^3], colors u16 [K, r^3], lo u32 [K, (r/4)^3],
    hi u32 [K, (r/4)^3])``, the grids x fastest, the words those of
    ``render.bitgrid._pack_bits`` (blocks x fastest).  A malformed FlatTree
    raises ``ValueError``."""
    lib = library()
    meta, children, bricks = _flat_arrays(flat)
    corners = np.ascontiguousarray(corners, dtype=np.int32).reshape(-1, 3)
    K = corners.shape[0]
    r3 = int(rsize) ** 3
    n3 = (int(rsize) // 4) ** 3
    occ = np.empty(K * r3, dtype=np.uint8)
    colors = np.empty(K * r3, dtype=np.uint16)
    lo = np.empty(K * n3, dtype=np.uint32)
    hi = np.empty(K * n3, dtype=np.uint32)
    _check_fault(lib.rasterize_regions(meta, children, bricks, meta.shape[0], bricks.shape[0],
                                       int(flat.brick_dim), int(flat.size),
                                       corners.reshape(-1), K, int(rsize), occ, colors, lo, hi))
    return occ.reshape(K, r3), colors.reshape(K, r3), lo.reshape(K, n3), hi.reshape(K, n3)


def pack_pyramid(occ_flat: np.ndarray, S: int):
    """Every pyramid level of a dense x-fastest u8 occupancy grid of edge
    ``S``: ``(levels_lo, levels_hi)``, lists of u32 arrays; a level of fewer
    than 4 cells an axis is padded to one block."""
    lib = library()
    levels_lo, levels_hi = [], []
    grid = np.ascontiguousarray(occ_flat, dtype=np.uint8).reshape(-1)
    if grid.size != S**3:
        raise ValueError(f"{grid.size} cells, want {S}^3")
    c = S
    while c > 1:
        if c % 4 != 0:
            target = ((c + 3) // 4) * 4
            padded = np.zeros((target, target, target), dtype=np.uint8)
            padded[:c, :c, :c] = grid.reshape(c, c, c)
            grid, c = padded.reshape(-1), target
        n = c // 4
        lo = np.empty(n**3, dtype=np.uint32)
        hi = np.empty(n**3, dtype=np.uint32)
        coarse = np.empty(n**3, dtype=np.uint8)
        lib.pack_level(grid, c, lo, hi, coarse)
        levels_lo.append(lo)
        levels_hi.append(hi)
        grid, c = coarse, n
    return levels_lo, levels_hi
