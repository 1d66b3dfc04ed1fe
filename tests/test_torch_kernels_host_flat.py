"""The flat-tree kernels (``csrc/flat.cu``: ``flat_vmap_kernel``,
``flat_wavefront_kernel`` and every form of ``flat_fast_kernel``)
compiled for the host and run on the CPU through their C entries, against
the plain tracers, bit for bit.

As ``tests/test_torch_kernels_host.py`` does (whose stand-in header for the
CUDA names this file shares), the source is built with the host compiler
and each C entry's launch is rewritten into a loop over the grid, the
threads in turn.  The rays are seeded: from outside the world and from
inside it, over trees of bricks of 2, 4 and 8 with a uniform node, and an
all-solid tree; at the default caps and at caps that cut rays.  Skips where
there is no C++ compiler.
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
#include "flat_host.cu"
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host_flat")
    (d / "cuda_runtime.h").write_text(SHIM)
    shutil.copy(os.path.join(CSRC, "traverse.cuh"), d)
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
    with open(os.path.join(CSRC, "flat.cu")) as f:
        src = entry.sub(lambda m: f"vhx_host_launch({m.group(2)}, [&] {{ "
                                  f"{m.group(1)}({m.group(3)}); }});", f.read())
    (d / "flat_host.cu").write_text(src)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libkernels_host_flat.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
         "-fPIC", "-shared", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    from voxelhex_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    params = ctypes.POINTER(_build.FlatParams)
    for name in ("vhx_flat_vmap", "vhx_flat_wavefront", "vhx_flat_fast"):
        getattr(lib, name).argtypes = [params, p, p, i, p, p, p, p, p, p, i, p]
        getattr(lib, name).restype = i
    lib.vhx_flat_fast_depth.argtypes = [params, p, p, i, p, i, p]
    lib.vhx_flat_fast_depth.restype = i
    lib.vhx_flat_params_size.restype = i
    assert lib.vhx_flat_params_size() == ctypes.sizeof(_build.FlatParams)
    return lib


def make_flat(size, brick_dim, n, seed, lod=True, solid=False):
    """A port FlatTree: ``n`` random voxels of three colors and a uniform
    node of edge 4 (``lod``), or (``solid``) only uniform nodes."""
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree
    from voxelhex_tpu_torch.tree.flat import flatten

    cols = [Albedo.from_u32(v) for v in (0xFF0000FF, 0x00FF00FF, 0x0000FFFF)]
    tree = BoxTree(size, brick_dim, auto_simplify=False)
    rng = np.random.default_rng(seed)
    if solid:
        for k, (p, e) in enumerate((((8, 8, 8), 4), ((32, 16, 32), 16), ((40, 48, 4), 4))):
            tree.insert_at_lod(p, e, cols[k])
        return flatten(tree)
    for _ in range(n):
        tree.insert(tuple(int(v) for v in rng.integers(0, size, 3)), cols[rng.integers(0, 3)])
    if lod:
        tree.insert_at_lod((8, 8, 8), 4, cols[0])
    return flatten(tree)


def make_rays(n, size, seed):
    """``n`` rays aimed at the world from outside it, then ``n`` from
    inside, f32 [2n, 3]."""
    rng = np.random.default_rng(seed)
    t = rng.random((n, 3)) * size
    d1 = rng.normal(size=(n, 3))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    o1 = t - d1 * size * 2.5
    o2 = rng.random((n, 3)) * size * 0.8 + size * 0.1
    d2 = rng.normal(size=(n, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = torch.from_numpy(np.concatenate([o1, o2]).astype(np.float32))
    d = torch.from_numpy(np.concatenate([d1, d2]).astype(np.float32))
    return o, d


SCENES = {
    "d4": (64, 4, 1500, 1),
    "d2": (32, 2, 300, 2),
    "d8": (32, 8, 300, 3),
    "solid": (64, 4, 0, 4),
}


@pytest.fixture(scope="module")
def scenes():
    return {k: make_flat(s, d, n, seed, solid=k == "solid") for k, (s, d, n, seed) in SCENES.items()}


def _same(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()
                    and (torch.signbit(a) == torch.signbit(b)).all())
    return bool((a == b).all())


def _run(lib, name, params, o, d, depth=False):
    R = o.shape[0]
    if depth:
        out = torch.full((R,), 7.0)
        assert lib.vhx_flat_fast_depth(ctypes.byref(params), o.data_ptr(), d.data_ptr(), R,
                                       out.data_ptr(), 0, None) == 0
        return out
    outs = (torch.zeros(R, dtype=torch.bool), torch.full((R,), 7, dtype=torch.int32),
            torch.full((R,), 7, dtype=torch.int32), torch.full((R,), 7, dtype=torch.int32),
            torch.full((R, 3), 7.0), torch.full((R, 3), 7.0))
    assert getattr(lib, name)(ctypes.byref(params), o.data_ptr(), d.data_ptr(), R,
                              *(t.data_ptr() for t in outs), 0, None) == 0
    return outs


def _equal_all(got, want):
    names = ("hit", "voxel", "brick", "cell", "point", "normal")
    bad = [n for n, a, b in zip(names, got, want) if not _same(a, b)]
    assert not bad, f"outputs differ: {bad}"


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("limit", [2048, 7])
def test_vmap_kernel_equals_plain(host_lib, scenes, scene, limit):
    """flat_vmap_kernel against make_trace_ray at max_inner ``limit``."""
    from voxelhex_tpu_torch.ops.flat import MAX_RESTARTS, flat_params
    from voxelhex_tpu_torch.render.jax_renderer import device_tree, make_trace_ray

    flat = scenes[scene]
    tree = device_tree(flat, "cpu")
    o, d = make_rays(96, flat.size, 11)
    want = make_trace_ray(flat.brick_dim, MAX_RESTARTS, limit)(tree, o, d)
    got = _run(host_lib, "vhx_flat_vmap", flat_params(tree, flat.brick_dim, limit), o, d)
    _equal_all(got, want)
    if limit == 2048:
        assert int(want[0].sum()) > 20


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("limit", [4096, 9])
def test_wavefront_kernel_equals_plain(host_lib, scenes, scene, limit):
    """flat_wavefront_kernel against make_wavefront_tracer at max_iters
    ``limit``."""
    from voxelhex_tpu_torch.ops.flat import flat_params
    from voxelhex_tpu_torch.render.jax_renderer import device_tree
    from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer

    flat = scenes[scene]
    tree = device_tree(flat, "cpu")
    o, d = make_rays(96, flat.size, 12)
    want = make_wavefront_tracer(flat.brick_dim, limit)(tree, o, d)
    got = _run(host_lib, "vhx_flat_wavefront", flat_params(tree, flat.brick_dim, limit), o, d)
    _equal_all(got, want)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("limit", [4096, 9])
def test_fast_kernel_equals_plain(host_lib, scenes, scene, limit):
    """flat_fast_kernel (bitmap bricks at brick_dim 2 and 4, voxel reads at
    8) against make_fast_tracer, from the entry point and from a start a
    ray, and its depth form against the prepass depth."""
    from voxelhex_tpu_torch.ops.flat import flat_params
    from voxelhex_tpu_torch.render.fast import make_fast_tracer, pack_device_tree, prepass_depth

    flat = scenes[scene]
    tree = pack_device_tree(flat, "cpu")
    o, d = make_rays(96, flat.size, 13)
    trace = make_fast_tracer(flat.brick_dim, limit)
    want = trace(tree, o, d)
    _equal_all(_run(host_lib, "vhx_flat_fast", flat_params(tree, flat.brick_dim, limit), o, d),
               want)
    depth = _run(host_lib, "", flat_params(tree, flat.brick_dim, limit), o, d, depth=True)
    assert _same(depth, prepass_depth(want[0], want[4], o))
    start = torch.from_numpy(np.random.default_rng(14).random(o.shape[0]).astype(np.float32)
                             * np.float32(flat.size))
    want = trace(tree, o, d, start)
    got = _run(host_lib, "vhx_flat_fast", flat_params(tree, flat.brick_dim, limit, start), o, d)
    _equal_all(got, want)


@pytest.mark.parametrize("res", [(32, 20), (30, 18)])
def test_fast_kernel_pools_the_half_res_depths(host_lib, scenes, res):
    """The full-res launch of a prepassed frame reads the half-res depth
    map: its rays equal the plain tracer's from start_from_depth (its entry
    point fused on all three axes, as in the reference's prepass program),
    at a size whose half is even and at one whose half is odd."""
    from voxelhex_tpu_torch.ops.flat import flat_params
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.fast import (
        PREPASS_ENTRY_FMA,
        make_fast_tracer,
        pack_device_tree,
        prepass_depth,
        start_from_depth,
    )
    from voxelhex_tpu_torch.render.jax_renderer import rays_on

    flat = scenes["d4"]
    tree = pack_device_tree(flat, "cpu")
    w, h = res
    cam = orbit_camera(float(flat.size), yaw_deg=30.0, resolution=res)
    half = orbit_camera(float(flat.size), yaw_deg=30.0, resolution=(w // 2, h // 2))
    trace = make_fast_tracer(flat.brick_dim)
    po, pd = rays_on(*half.rays(), "cpu")
    p = trace(tree, po, pd)
    dmap = prepass_depth(p[0], p[4], po)
    assert int((dmap > 0).sum()) > 5
    o, d = rays_on(*cam.rays(), "cpu")
    want = make_fast_tracer(flat.brick_dim, entry_fma=PREPASS_ENTRY_FMA)(tree, o, d,
                                                           start_from_depth(dmap, h // 2, w // 2))
    params = flat_params(tree, flat.brick_dim, 4096, dmap, w, (h // 2, w // 2))
    _equal_all(_run(host_lib, "vhx_flat_fast", params, o, d), want)
