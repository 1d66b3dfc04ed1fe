"""The LOD frame, the skip far frame, the skip rows' refresh and the chained
depth prepass: their CUDA sources compiled for the host and run on the
CPU, against their plain PyTorch versions.

As ``tests/test_torch_kernels_host.py`` does (whose stand-in header for the
CUDA names this file shares), each source is built with the host compiler
and each C entry's launch is rewritten into a loop over the grid: the
frame kernels', the refresh's and the skip far frame's threads in turn,
the depth prepass's blocks all at once, later tickets first, so that every
wait polls.  The outputs
equal the plain versions bit for bit.  Skips where there is no C++
compiler.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_kernels_host import CSRC, SHIM

HARNESS = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local VhxWarp* vhx_warp = nullptr;
thread_local VhxBlock* vhx_block = nullptr;
std::mutex vhx_host_atomic_lock;
long long vhx_host_atomics = 0;
std::condition_variable vhx_flag_cv;
long long vhx_host_polls = 0;
#include "frame_host.cu"
namespace strm {
#include "stream_host.cu"
}
namespace farn {
#include "far_host.cu"
}
namespace pre {
#include "prepass_host.cu"
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host_lod_skip")
    (d / "cuda_runtime.h").write_text(SHIM)
    for header in ("traverse.cuh", "frame.cuh", "skip.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    # each launch in a C entry becomes a call of the launcher over the grid
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
    launchers = {"prepass_frame_kernel": "vhx_host_grid_launch"}
    shared = re.compile(r"__shared__ ([\w:]+) (\w+)((?:\[[^\]]+\])*);")

    def sub(m):
        launcher = launchers.get(m.group(1).split("<")[0], "vhx_host_launch")
        return f"{launcher}({m.group(2)}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    for name in ("frame", "stream", "far", "prepass"):
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src = entry.sub(sub, f.read())
        if name == "prepass":  # blocks at once: each its own shared variables
            src = shared.sub(r"auto& \2 = vhx_block_shared<\1\3>(__LINE__);", src)
        (d / f"{name}_host.cu").write_text(src)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libkernels_host_lod_skip.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
         "-fPIC", "-shared", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    from voxelhex_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vhx_render_frame_lod.argtypes = [p, p, p, i, ctypes.POINTER(_build.FrameParams),
                                         ctypes.POINTER(_build.LodParams), p, i, p]
    lib.vhx_render_far_skip.argtypes = [ctypes.POINTER(_build.FarParams), i, p, i, p, p, i, p]
    lib.vhx_skip_rows.argtypes = [p, p, ctypes.POINTER(i), ctypes.POINTER(i), i, i, p]
    lib.vhx_prepass_chain.argtypes = [p, ctypes.POINTER(_build.PrepassParams), i, i,
                                      ctypes.POINTER(p), p, p, p, i, i, p]
    lib.vhx_prepass_sync_words.argtypes = [i, i, i]
    lib.vhx_prepass_sync_words.restype = ctypes.c_longlong
    for name in ("vhx_render_frame_lod", "vhx_render_far_skip", "vhx_skip_rows",
                 "vhx_prepass_chain", "vhx_lod_params_size", "vhx_far_params_size"):
        getattr(lib, name).restype = i
    return lib


def _equal(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def _grid(size, density, seed, n_colors=6, skip=False, mip=False, block=True):
    """A random grid of single voxels and, with ``block``, a solid block;
    with ``skip`` its skip rows, with ``mip`` its MIP colors."""
    from voxelhex_tpu_torch.render.bitgrid import (bitgrid_from_grids, build_mip_colors,
                                                   device_bitgrid)

    rng = np.random.default_rng(seed)
    occ = rng.random((size, size, size)) < density
    b = max(size // 8, 1)
    occ[b:3 * b, :2 * b, b:4 * b] = block  # a solid block the coarse levels see
    colors = np.where(occ, rng.integers(0, n_colors, occ.shape), 0xFFFF).astype(np.uint16)
    colors[occ & (rng.random(occ.shape) < 0.05)] = 0xFFFE  # voxels with no color
    bg = bitgrid_from_grids(occ, np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel(),
                            rng.random((n_colors, 4)).astype(np.float32))
    if mip:
        build_mip_colors(bg)
    return device_bitgrid(bg, "cpu", skip_rows=skip)


# ---- the LOD frame


@pytest.mark.parametrize("scale", [0.0, 0.04, 0.3])
def test_lod_kernel_source_equals_plain(host_lib, scale):
    """frame_lod_kernel through its C entry on a ragged 43 x 29 frame of a
    64^3 grid (3 levels) against render_lod_plain, bit for bit; at the
    positive scales the hits stop at more than one level, and rays cross a
    stop-level threshold between their entry and their hit."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import frame_params, lod_params, lod_tracer, render_lod_plain
    from voxelhex_tpu_torch.render.bitgrid import lod_stop_level
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera

    assert host_lib.vhx_lod_params_size() == ctypes.sizeof(_build.LodParams)
    tree = _grid(64, 0.02, 3, mip=True)
    cam = orbit_camera(64.0, yaw_deg=30.0, distance_factor=1.3, resolution=(43, 29))
    bg = (0.1, 0.2, 0.3)
    out = torch.full((29, 43, 3), 7.0)
    assert host_lib.vhx_render_frame_lod(
        tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
        tree["palette"].shape[0], frame_params(tree, cam, bg), lod_params(tree, scale),
        out.data_ptr(), 0, None) == 0
    want = render_lod_plain(tree, cam, scale, bg)
    assert _equal(out, want)
    # what the frame exercised, from the plain march
    o, d = device_rays(cam, "cpu")
    trace = lod_tracer(tree, scale)
    st0 = trace.init(tree, o, d)
    st = trace.run(tree, trace.init(tree, o, d), 2048)
    assert int(st["hit"].sum()) > 200
    if scale > 0:
        assert len(set(st["hlev"][st["hit"]].tolist())) > 1

        def stop(point):
            x = point - o
            dist = torch.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])
            return lod_stop_level(dist * np.float32(scale), 2)

        crossed = st["hit"] & (stop(st["point"]) > stop(st0["point"]))
        assert int(crossed.sum()) > 0


def test_lod_kernel_entry_rejects_bad_params(host_lib):
    from voxelhex_tpu_torch.ops.frame import frame_params, lod_params
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _grid(16, 0.05, 1, mip=True)
    cam = orbit_camera(16.0, resolution=(8, 8))
    out = torch.empty((8, 8, 3))
    args = (tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
            tree["palette"].shape[0])
    lod = lod_params(tree, 0.3)
    lod.mip[0] = None
    assert host_lib.vhx_render_frame_lod(*args, frame_params(tree, cam), lod, out.data_ptr(), 0,
                                         None) != 0
    assert host_lib.vhx_render_frame_lod(*args, frame_params(tree, cam), lod_params(tree, 0.3),
                                         None, 0, None) != 0


# ---- the skip far frame


def _far_case(depths, inside, res=(37, 21)):
    """A window and rings of the given pyramid depths (16 cells: 2 levels,
    64: 3), random content, one world camera seen from each layer's frame."""
    from dataclasses import replace

    from voxelhex_tpu_torch.render.camera import Camera

    eye = np.array([8.5, 9.0, 7.5] if inside else [-20.0, 30.0, -25.0], dtype=np.float32)
    target = np.array([40.0, 4.0, 50.0], dtype=np.float32)
    cam = Camera(origin=eye, target=target, resolution=res, fov_y_deg=55.0)
    layers = []
    for i, (factor, origin) in enumerate([(1, (0, 0, 0)), (2, (0, 0, 0)),
                                          (8, (-128, 0, -128))][:len(depths)]):
        size = {2: 16, 3: 64, 1: 4}[depths[i]]
        o = np.asarray(origin, dtype=np.float32)
        c = replace(cam, origin=(eye - o) / np.float32(factor),
                    target=(target - o) / np.float32(factor))
        layers.append((_grid(size, 0.03 if size < 64 else 0.01, 10 + i, skip=True,
                             block=i > 0), c, factor))
    return layers


@pytest.mark.parametrize("depths", [(2,), (3, 3), (3, 2), (3, 3, 2), (2, 1)])
@pytest.mark.parametrize("inside", [True, False])
def test_far_skip_kernel_source_equals_plain(host_lib, depths, inside):
    """far.cu's skip instance through its C entry against the plain skip far
    frame, u8 and f32, with and without a window start map, over layers of
    one depth and of the window's depth and one less in one frame."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, far_params

    layers = _far_case(depths, inside)
    bg = (0.1, 0.2, 0.3)
    rng = np.random.default_rng(5)
    start = torch.from_numpy(rng.uniform(0, 30, (6, 10)).astype(np.float32))
    frames = []
    for out_u8, st in ((True, None), (False, None), (True, start)):
        out = torch.full((21, 37, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
        assert host_lib.vhx_render_far_skip(
            far_params(layers, inside, bg, skip=True), 3, None if st is None else st.data_ptr(),
            4, None if out_u8 else out.data_ptr(), out.data_ptr() if out_u8 else None, 0,
            None) == 0
        want = far_frame_plain(layers, inside, bg, out_u8, start=st, start_tile=4,
                               skip_substeps=3)
        assert _equal(out, want)
        frames.append(want)
    assert len(torch.unique(frames[0].reshape(-1, 3), dim=0)) >= 3
    if len(depths) > 1 and depths[1] > 1:  # a ring's hits show where the window misses
        assert not _equal(frames[0], far_frame_plain(layers[:1], inside, bg, True,
                                                     skip_substeps=3))


def test_far_skip_kernel_entry_rejects_bad_layers(host_lib):
    """A ring two levels shallower than the window, no substeps, or rows off
    16 B: the entry refuses the frame."""
    from voxelhex_tpu_torch.ops.far import far_params

    out = torch.empty((21, 37, 3), dtype=torch.uint8)
    layers = _far_case((3, 2), True)
    deep = _far_case((3, 1), True)
    assert host_lib.vhx_render_far_skip(far_params(deep, True, skip=True), 3, None, 1, None,
                                        out.data_ptr(), 0, None) != 0
    assert host_lib.vhx_render_far_skip(far_params(layers, True, skip=True), 0, None, 1, None,
                                        out.data_ptr(), 0, None) != 0
    p = far_params(layers, True, skip=True)
    p.layers[1].occ += 8
    assert host_lib.vhx_render_far_skip(p, 3, None, 1, None, out.data_ptr(), 0, None) != 0
    assert host_lib.vhx_render_far_skip(far_params(layers, True, skip=True), 3, None, 1, None,
                                        out.data_ptr(), 0, None) == 0


# ---- the skip rows' refresh


@pytest.mark.parametrize("S", [4, 16, 48, 64])
def test_skip_rows_kernel_source_equals_plain(host_lib, S):
    """stream.cu's refresh through its C entry on random word pairs (1 to 4
    levels, 48 a side padding its top levels) against the reference's
    gather, skip_rows_plain, and the host build of the same grid."""
    from voxelhex_tpu_torch.ops.stream import _ints, skip_rows_plain
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, build_skip_rows

    tree = _grid(S, 0.05, S, skip=True)
    rng = np.random.default_rng(S)
    tree["occ_pairs"] = torch.from_numpy(
        rng.integers(-2**31, 2**31, tree["occ_pairs"].shape, dtype=np.int64).astype(np.int32))
    n = len(tree["bases"])
    rows = torch.full((tree["dims"][0] ** 3, 2 * n), 7, dtype=torch.int32)
    assert host_lib.vhx_skip_rows(tree["occ_pairs"].data_ptr(), rows.data_ptr(),
                                  _ints(tree["bases"]), _ints(tree["dims"]), n, 0, None) == 0
    assert _equal(rows, skip_rows_plain(tree["occ_pairs"], tree["bases"], tree["dims"], S))
    occ = np.random.default_rng(1).random((S, S, S)) < 0.1
    bg = bitgrid_from_occupancy(occ)
    pairs = torch.from_numpy(np.stack([bg.occ_lo, bg.occ_hi], 1).astype(np.uint32).view(np.int32))
    assert host_lib.vhx_skip_rows(pairs.data_ptr(), rows.data_ptr(), _ints(tree["bases"]),
                                  _ints(tree["dims"]), n, 0, None) == 0
    assert np.array_equal(rows.numpy().view(np.uint32), build_skip_rows(bg))


def test_skip_rows_kernel_entry_rejects_bad_pyramids(host_lib):
    from voxelhex_tpu_torch.ops.stream import _ints

    rows = torch.empty((64, 4), dtype=torch.int32)
    pairs = torch.zeros((65, 2), dtype=torch.int32)
    for bases, dims, n in (([0, 64], [4, 2], 2), ([0, 64], [4, 1], 0), ([0, 64], [0, 1], 2)):
        assert host_lib.vhx_skip_rows(pairs.data_ptr(), rows.data_ptr(), _ints(bases),
                                      _ints(dims), n, 0, None) != 0
    assert host_lib.vhx_skip_rows(pairs.data_ptr(), rows.data_ptr() + 8, _ints([0, 64]),
                                  _ints([4, 1]), 2, 0, None) != 0


# ---- the chained depth prepass


@pytest.mark.parametrize("levels,most", [(3, 2), (3, 1), (4, 2)])
@pytest.mark.parametrize("tracer", ["stack", "skip"])
def test_prepass_chain_kernel_source_equals_plain(host_lib, levels, most, tracer):
    """prepass.cu's chained form through its C entry, launches of at most
    ``most`` levels as the wrapper cuts them (prepass_chunks), each started
    from the start map of the one before: every level's depths and the
    frame's start map equal the plain depth prepass bit for bit; the
    chain's first launch is the one-launch form."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.prepass import (level_camera, prepass_chunks, prepass_params,
                                                prepass_start)
    from voxelhex_tpu_torch.render.camera import orbit_camera

    substeps = 3 if tracer == "skip" else 0
    tree = _grid(64, 0.02, 7, skip=bool(substeps))
    res = (64 * 2**(levels - 3), 48 * 2**(levels - 3))
    cam = orbit_camera(64.0, yaw_deg=25.0, resolution=res)
    want = []
    want_start = prepass_start(tree, cam, levels, skip_substeps=substeps or None, depths=want)
    cams = [level_camera(cam, i) for i in range(1, levels + 1)]
    outs = [torch.full((c.resolution[1], c.resolution[0]), 7.0) for c in cams]
    start = torch.full_like(outs[0], 7.0)
    words = tree["skip_rows"] if substeps else tree["occ_pairs"]
    chunks = prepass_chunks(levels, most)
    assert len(chunks) > 1
    coarse = None
    for epoch, (lo, n) in enumerate(chunks, 1):
        out = start if lo == 1 else torch.full_like(outs[lo - 1], 7.0)
        params = (_build.PrepassParams * n)(*(prepass_params(tree, c) for c in cams[lo - 1:
                                                                                   lo - 1 + n]))
        ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs[lo - 1: lo - 1 + n]))
        w1, h1 = cams[lo - 1].resolution
        sync = torch.zeros(host_lib.vhx_prepass_sync_words(w1, h1, n), dtype=torch.int32)
        assert host_lib.vhx_prepass_chain(words.data_ptr(), params, n, substeps, ptrs,
                                          out.data_ptr(),
                                          None if coarse is None else coarse.data_ptr(),
                                          sync.data_ptr(), epoch, 0, None) == 0
        coarse = out
    for g, w in zip(outs[::-1], want):
        assert _equal(g, w)
    assert _equal(start, want_start)
    assert (want[-1] == 1e8).any() and (want[-1] < 1e8).any()


def test_prepass_chain_entry_rejects_an_odd_coarsest_level(host_lib):
    """A chained launch whose coarsest level has an odd side cannot take a
    start map of half its size: the entry refuses it."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.prepass import prepass_params
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _grid(16, 0.05, 2)
    cam = orbit_camera(16.0, resolution=(15, 8))
    params = (_build.PrepassParams * 1)(prepass_params(tree, cam))
    depth, start, coarse = torch.empty((8, 15)), torch.empty((8, 15)), torch.zeros((4, 7))
    sync = torch.zeros(host_lib.vhx_prepass_sync_words(15, 8, 1), dtype=torch.int32)
    ptrs = (ctypes.c_void_p * 1)(depth.data_ptr())
    assert host_lib.vhx_prepass_chain(tree["occ_pairs"].data_ptr(), params, 1, 0, ptrs,
                                      start.data_ptr(), coarse.data_ptr(), sync.data_ptr(), 1,
                                      0, None) != 0
