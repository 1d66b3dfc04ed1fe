"""The CUDA kernels' sources, compiled for the host and run on the CPU,
against their plain PyTorch versions.

A CUDA kernel cannot run without a card, but its arithmetic can: the host
compiler builds every source of ``csrc/`` against a small header that
stands in for the CUDA names they use (``__fmaf_rn`` is the correctly
rounded ``fmaf``, ``__fdiv_rn`` an IEEE division, ``atomicAdd`` a plain
add, ...; no contraction of multiply-adds), and a loop runs every thread of
every block in turn.  That checks the kernels' logic (pixel tiles, ragged
edges, the level table, the reciprocal multiplications, ray generation,
shading, the batched kernel's frames, chunks and row digests, the
multi-hit march's one loop per ray, the composite's recurrence, the
optimizer's order of operations) on grids of 2, 3 and 4 pyramid levels,
and the automaton's step count where ``max_iters`` cuts rays at their
first steps or inside an ADVANCE, on rays built to take every move.
The outputs equal the plain versions bit for bit, except where a sigmoid's
``expf`` enters: the host's libm and PyTorch's vectorized ``exp`` may
differ by an ulp, so those outputs are held within a stated tolerance.
What this cannot check (the nvcc build, the launch, the card's own
arithmetic) ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``
check on the card.  Skips where there is no C++ compiler.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "voxelhex_tpu_torch", "csrc")

# the CUDA names the kernels use, for the host
SHIM = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#include <math.h>
struct uint2 { uint32_t x, y; };
struct int2 { int x, y; };
struct float4 { float x, y, z, w; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
#define __grid_constant__
inline float atomicAdd(float* p, float v) { float old = *p; *p = old + v; return old; }
inline int atomicAdd(int* p, int v) { int old = *p; *p = old + v; return old; }
inline int atomicOr(int* p, int v) { int old = *p; *p = old | v; return old; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncthreads() {}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
    std::memset(p, v, n);
    return cudaSuccess;
}
using std::signbit;
// a launch that the test rewrites into this call: every thread of every
// block of the 2-D grid in turn
template <class F>
inline void vhx_host_launch(dim3 grid, unsigned threads, int, cudaStream_t, F kernel) {
    blockDim = dim3(threads);
    gridDim = grid;
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx)
            for (unsigned t = 0; t < threads; ++t) {
                blockIdx = dim3(bx, by);
                threadIdx = dim3(t);
                kernel();
            }
}
"""

# every thread of every block in turn; __syncthreads is a no-op, which is
# right for kernels whose threads share only what thread 0 writes before it
HARNESS = r"""
#include "cuda_runtime.h"
dim3 threadIdx, blockIdx, blockDim, gridDim;
#include "frame_host.cu"
namespace trav {
#include "traverse_host.cu"
}
namespace shd {
#include "shade_host.cu"
}
namespace mh {
#include "multihit_host.cu"
}
namespace comp {
#include "composite_host.cu"
}
namespace adm {
#include "adam_host.cu"
}
namespace frm {
#include "frames_host.cu"
}

// run `kernel` for every thread of `blocks` blocks of `threads`
template <class F>
static void each_thread(unsigned blocks, unsigned threads, F kernel) {
    blockDim = dim3(threads);
    gridDim = dim3(blocks);
    for (unsigned b = 0; b < blocks; ++b)
        for (unsigned t = 0; t < threads; ++t) {
            blockIdx = dim3(b);
            threadIdx = dim3(t);
            kernel();
        }
}

extern "C" long long host_voxel_addr(int x, int y, int z, int size) {
    return vhx::voxel_addr(x, y, z, size);
}
extern "C" void host_shade(const void* hit, const int* voxel, const float* normal,
                           const float* palette, int n_colors, float bg0, float bg1, float bg2,
                           int R, float* rgb, unsigned char* u8) {
    each_thread((R + 255) / 256, 256, [&] {
        shd::shade_kernel((const unsigned char*)hit, voxel, normal, (const float4*)palette,
                          n_colors, bg0, bg1, bg2, R, rgb, u8);
    });
}
extern "C" void host_multihit(const float* o, const float* d, const void* occ,
                              const TraceParams* P, int R, int K, int* count, int* voxels,
                              float* dists) {
    each_thread((R + mh::THREADS - 1) / mh::THREADS, mh::THREADS, [&] {
        mh::multihit_kernel(o, d, (const uint2*)occ, *P, R, K, count, voxels, dists);
    });
}
template <int K>
static void composite_k(int backward, const float* grad, const float* albedo,
                        const float* logits, const int* voxels, int R, int size, const float* bg,
                        float* out, float* g_albedo, float* g_logits) {
    const float b0 = bg ? bg[0] : 0.f, b1 = bg ? bg[1] : 0.f, b2 = bg ? bg[2] : 0.f;
    each_thread((R + comp::THREADS - 1) / comp::THREADS, comp::THREADS, [&] {
        if (backward)
            comp::composite_bwd_kernel<K>(grad, albedo, logits, voxels, R, size, b0, b1, b2,
                                          bg ? 1 : 0, g_albedo, g_logits);
        else
            comp::composite_fwd_kernel<K>(albedo, logits, voxels, R, size, b0, b1, b2,
                                          bg ? 1 : 0, out);
    });
}
extern "C" int host_composite(int backward, const float* grad, const float* albedo,
                              const float* logits, const int* voxels, int R, int K, int size,
                              const float* bg, float* out, float* g_albedo, float* g_logits) {
    switch (K) {
        case 1: composite_k<1>(backward, grad, albedo, logits, voxels, R, size, bg, out, g_albedo, g_logits); return 0;
        case 2: composite_k<2>(backward, grad, albedo, logits, voxels, R, size, bg, out, g_albedo, g_logits); return 0;
        case 3: composite_k<3>(backward, grad, albedo, logits, voxels, R, size, bg, out, g_albedo, g_logits); return 0;
        case 4: composite_k<4>(backward, grad, albedo, logits, voxels, R, size, bg, out, g_albedo, g_logits); return 0;
    }
    return 1;
}
extern "C" void host_adam(float* p0, const float* g0, float* mu0, float* nu0, long long n0,
                          float* p1, const float* g1, float* mu1, float* nu1, long long n1,
                          const int* count_in, int* count_out, const adm::AdamParams* A,
                          int blocks) {
    each_thread(blocks, adm::THREADS, [&] {
        adm::adam_kernel(p0, g0, mu0, nu0, n0, p1, g1, mu1, nu1, n1, count_in, count_out, *A);
    });
}
extern "C" void host_frame(const void* occ, const void* colors, const float* palette,
                           int n_colors, const FrameParams* P, float* rgb, unsigned char* u8) {
    blockDim = dim3(THREADS);
    for (unsigned by = 0; by < (unsigned)(P->h + WARP_H - 1) / WARP_H; ++by)
        for (unsigned bx = 0; bx < (unsigned)(P->w + BLOCK_W - 1) / BLOCK_W; ++bx)
            for (unsigned t = 0; t < (unsigned)THREADS; ++t) {
                blockIdx = dim3(bx, by);
                threadIdx = dim3(t);
                frame_kernel((const uint2*)occ, (const unsigned short*)colors,
                             (const float4*)palette, n_colors, *P, rgb, u8);
            }
}
extern "C" void host_traverse(const float* o, const float* d, const void* occ,
                              const void* colors, const TraceParams* P, int R, void* hit,
                              int* voxel, int* hvox, float* point, float* hnormal) {
    blockDim = dim3(128);
    for (unsigned b = 0; b < (unsigned)(R + 127) / 128; ++b)
        for (unsigned t = 0; t < 128; ++t) {
            blockIdx = dim3(b);
            threadIdx = dim3(t);
            trav::traverse_kernel(o, d, (const uint2*)occ, (const unsigned short*)colors, *P, R,
                                  (unsigned char*)hit, voxel, hvox, point, hnormal);
        }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("kernels_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    for header in ("traverse.cuh", "frame.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    launch = re.compile(r"<<<[^>]*>>>")  # a launch becomes a call of one thread
    with open(os.path.join(CSRC, "frame.cu")) as f:
        (d / "frame_host.cu").write_text(launch.sub("", f.read()))
    # the batched kernel runs through its C entry, whose launch becomes a
    # loop over the grid (vhx_host_launch): the test drives the entry, its
    # checks and its memset as the wrapper does
    with open(os.path.join(CSRC, "frames.cu")) as f:
        src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"vhx_host_launch(\2, [&] { \1(\3); });",
                         f.read(), flags=re.S)
    assert n == 1
    (d / "frames_host.cu").write_text(src)
    for name in ("traverse", "shade", "multihit", "composite", "adam"):
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            (d / f"{name}_host.cu").write_text(
                launch.sub("", f.read()).replace('extern "C" ', ""))
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libkernels_host.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", f"-I{d}",
         "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    from voxelhex_tpu_torch.ops import _build

    p = ctypes.c_void_p
    lib.host_frame.argtypes = [p, p, p, ctypes.c_int, ctypes.POINTER(_build.FrameParams), p, p]
    i, f = ctypes.c_int, ctypes.c_float
    lib.vhx_render_frames.argtypes = [p, p, p, i, ctypes.POINTER(_build.FramesParams), p, p, p,
                                      p, i, p]
    lib.vhx_render_frames.restype = i
    lib.vhx_frames_params_size.restype = i
    lib.vhx_frames_kmax.restype = i
    lib.host_traverse.argtypes = [p, p, p, p, ctypes.POINTER(_build.TraceParams), i,
                                  p, p, p, p, p]
    lib.host_voxel_addr.argtypes = [i, i, i, i]
    lib.host_voxel_addr.restype = ctypes.c_longlong
    lib.host_shade.argtypes = [p, p, p, p, i, f, f, f, i, p, p]
    lib.host_multihit.argtypes = [p, p, p, ctypes.POINTER(_build.TraceParams), i, i, p, p, p]
    lib.host_composite.argtypes = [i, p, p, p, p, i, i, i, ctypes.POINTER(f), p, p, p]
    lib.host_adam.argtypes = [p, p, p, p, ctypes.c_longlong, p, p, p, p, ctypes.c_longlong, p,
                              p, ctypes.POINTER(_build.AdamParams), i]
    return lib


def _tree(size, density, half=False):
    """A random grid; with ``half``, the voxels at x >= size / 2 are empty,
    so that rays there ascend past the top level."""
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    rng = np.random.default_rng(size)
    occ = rng.random((size, size, size)) < density
    if half:
        occ[size // 2:] = False
    colors = np.where(occ, rng.integers(0, 5, occ.shape), 0xFFFF).astype(np.uint16)
    bg = bitgrid_from_occupancy(occ, palette=rng.random((5, 4)))
    bg.colors = np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel()
    return device_bitgrid(bg, "cpu")


def _equal(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


# grids of 2, 3 and 4 pyramid levels
GRIDS = [(16, 0.05), (64, 0.02), (128, 0.01)]


@pytest.mark.parametrize("size,density", GRIDS)
@pytest.mark.parametrize("out_u8", [True, False])
def test_frame_kernel_source_equals_plain(host_lib, size, density, out_u8):
    """At 67x41 the pixel tiles are ragged on the right and at the bottom."""
    from voxelhex_tpu_torch.ops.frame import frame_params, render_frame_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _tree(size, density)
    cam = orbit_camera(float(size), yaw_deg=130.0, resolution=(67, 41))
    bg = (0.1, 0.2, 0.3)
    out = torch.full((41, 67, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
    host_lib.host_frame(tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(),
                        tree["palette"].data_ptr(), tree["palette"].shape[0],
                        frame_params(tree, cam, bg), None if out_u8 else out.data_ptr(),
                        out.data_ptr() if out_u8 else None)
    want = render_frame_plain(tree, cam, bg, out_u8)
    assert len(torch.unique(want.reshape(-1, 3), dim=0)) >= 3  # misses and hits
    assert _equal(out, want)


def test_frames_struct_layout(host_lib):
    from voxelhex_tpu_torch.ops import _build

    assert host_lib.vhx_frames_params_size() == ctypes.sizeof(_build.FramesParams)
    assert host_lib.vhx_frames_kmax() == _build.KMAX


def _frames_case(K, res, seed=0):
    """K cameras cycling through three poses, each pose held for a frame or
    two, so that some frames repeat the one before and some do not."""
    from voxelhex_tpu_torch.render.camera import orbit_camera

    yaws = [130.0, 130.0, 40.0, 250.0, 250.0, 40.0, 40.0]
    return [orbit_camera(64.0, yaw_deg=yaws[(k + seed) % len(yaws)], resolution=res)
            for k in range(K)]


# K = 1 and 3, and KMAX + 1: two launches, the second's baseline the first's
# last frame; 160 x 90 fills its pixel tiles, 37 x 21 leaves them ragged
@pytest.mark.parametrize("K,res", [(1, (160, 90)), (3, (37, 21)), (33, (37, 21))])
def test_frames_kernel_source_equals_plain(host_lib, K, res):
    """Frames and digests bit for bit, frame 0's against a baseline that
    differs from its own frame in one row only."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import render_frame_plain
    from voxelhex_tpu_torch.ops.frames import launch_frames, render_frames_plain
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS

    assert _build.KMAX == 32
    tree = _tree(64, 0.02)
    cams = _frames_case(K, res)
    bg = (0.1, 0.2, 0.3)
    w, h = res
    prev = render_frame_plain(tree, cams[0], bg, True).clone()
    prev[h // 2, w // 3, 1] ^= 1
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames, tree, cams, bg, True,
                                             MAX_ITERS, prev)
    assert launches == -(-K // _build.KMAX)
    want, nrows, flags = render_frames_plain(tree, cams, bg, True, MAX_ITERS, prev)
    assert int(nrows[0]) == 1 and int(flags[0].count_nonzero()) == 1
    if K > 1:  # a repeated pose changes no row, a new pose many
        assert int(nrows[1]) == 0 and int(nrows[2]) > h // 4
    assert _equal(frames, want)
    assert _equal(digest[:, 0], nrows) and _equal(digest[:, 1:], flags)


def test_frames_kernel_source_f32_without_digest(host_lib):
    from voxelhex_tpu_torch.ops.frames import launch_frames, render_frames_plain
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS

    tree = _tree(16, 0.05)
    cams = _frames_case(3, (37, 21))
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames, tree, cams,
                                             (0.1, 0.2, 0.3), False, MAX_ITERS, None)
    assert digest is None and launches == 1 and frames.dtype == torch.float32
    assert _equal(frames, render_frames_plain(tree, cams, (0.1, 0.2, 0.3), False)[0])


def test_frames_kernel_entry_rejects_bad_params(host_lib):
    """The C entry refuses a batch it cannot launch: no frames, more than
    KMAX, a digest of f32 frames or a digest with no baseline."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frames import frames_params

    tree = _tree(16, 0.05)
    p = frames_params(tree, _frames_case(2, (37, 21)))[0]
    out = torch.zeros((2, 21, 37, 3))
    u8 = torch.zeros((2, 21, 37, 3), dtype=torch.uint8)
    digest = torch.zeros((2, 4), dtype=torch.int32)
    args = (tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(),
            tree["palette"].data_ptr(), tree["palette"].shape[0])

    def call(params, rgb, frames_u8, prev, dig):
        return host_lib.vhx_render_frames(*args, params, rgb, frames_u8, prev, dig, 0, None)

    assert call(p, None, u8.data_ptr(), u8[0].data_ptr(), digest.data_ptr()) == 0
    for n in (0, _build.KMAX + 1):
        bad = _build.FramesParams.from_buffer_copy(p)
        bad.n_frames = n
        assert call(bad, None, u8.data_ptr(), None, None) != 0
    assert call(p, out.data_ptr(), None, u8[0].data_ptr(), digest.data_ptr()) != 0
    assert call(p, None, u8.data_ptr(), None, digest.data_ptr()) != 0
    assert call(p, out.data_ptr(), u8.data_ptr(), None, None) != 0


@pytest.mark.parametrize("size,density", GRIDS)
def test_traverse_kernel_source_equals_plain(host_lib, size, density):
    from voxelhex_tpu_torch.ops.traverse import trace_params, traverse_plain

    tree = _tree(size, density)
    rng = np.random.default_rng(1)
    n = 1500
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))
    out = [torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
           torch.zeros((n, 3), dtype=torch.int32), torch.zeros((n, 3)), torch.zeros((n, 3))]
    host_lib.host_traverse(o.data_ptr(), d.data_ptr(), tree["occ_pairs"].data_ptr(),
                           tree["colors"].data_ptr(), trace_params(tree), n,
                           *[t.data_ptr() for t in out])
    want = traverse_plain(tree, o, d)
    assert int(want[0].sum()) > n // 10
    for a, b in zip(out, want):
        assert _equal(a, b)


def _occupied_voxels(tree):
    """The (x, y, z) of every occupied voxel of a ``_tree`` grid."""
    size = int(tree["size"])
    flat = np.flatnonzero(tree["colors"].numpy() != -1)  # 0xFFFF as int16: empty
    return np.stack([flat % size, flat // size % size, flat // (size * size)], axis=1)


def _every_move_rays(tree, seed=5):
    """Rays that take every move of the automaton on a ``_tree(...,
    half=True)`` grid: random rays from inside
    and outside the world, rays along an axis (two components of d zero,
    some -0.0, the DDA's d == 0 path) and in a plane (one zero), from
    outside and inside; rays that start inside an occupied voxel; and rays
    that start in the world and leave it, sideways (a lateral step out) or
    past the top level (an ascend past it)."""
    size = int(tree["size"])
    rng = np.random.default_rng(seed)
    o_rand, d_rand = _rays_into(size, 300, seed)
    n = 120
    rows = np.arange(n)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    o_axis = rng.uniform(0, size, (n, 3))
    outside = rows < n // 2  # half start outside, before the face they enter by
    o_axis[rows[outside], axis[outside]] = size / 2 - sign[outside] * 0.8 * size
    d_axis = np.where(rng.random((n, 3)) < 0.5, 0.0, -0.0)
    d_axis[rows, axis] = sign
    d_plane = rng.normal(size=(n, 3))
    d_plane[rows, axis] = 0.0
    o_plane = rng.uniform(-0.5 * size, 1.5 * size, (n, 3))
    o_plane[rows, axis] = rng.uniform(0, size, n)  # in the world's slab along the zero axis
    vox = _occupied_voxels(tree)
    o_vox = vox[rng.choice(len(vox), n)] + rng.uniform(0.05, 0.95, (n, 3))
    d_vox = rng.normal(size=(n, 3))
    o_in = rng.uniform(0, size, (n, 3))
    d_in = rng.normal(size=(n, 3))
    d = np.concatenate([d_plane, d_vox, d_in])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.concatenate([o_axis, o_plane, o_vox, o_in]).astype(np.float32)
    d = np.concatenate([d_axis, d]).astype(np.float32)
    return torch.cat([o_rand, torch.from_numpy(o)]), torch.cat([d_rand, torch.from_numpy(d)])


@pytest.mark.parametrize("size,density", GRIDS)
def test_every_move_rays_take_every_move(size, density):
    """The ray set of the kernels' cut-step cases takes every move (the
    plain tracer's move record), ADVANCE with each substep count, and
    holds rays along an axis, rays that start in an occupied voxel and
    rays that leave the world by a lateral step."""
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS
    from voxelhex_tpu_torch.render import bitgrid as bgm

    tree = _tree(size, density, half=True)
    o, d = _every_move_rays(tree)
    trace = bgm.make_bitgrid_tracer(len(tree["bases"]), size, MAX_ITERS, **KERNEL_CONFIG)
    moves = []
    st = trace.run(tree, trace.init(tree, o, d), MAX_ITERS, moves)
    moves = torch.stack(moves)
    subs = KERNEL_CONFIG["advance_substeps"]
    want = {bgm.MOVE_HIT, bgm.MOVE_DESCEND, bgm.MOVE_ASCEND, bgm.MOVE_LATERAL, bgm.MOVE_RESTART}
    want |= {bgm.MOVE_ADVANCE + k for k in range(1, subs + 1)}
    assert want <= set(torch.unique(moves).tolist())
    assert int(((d == 0).sum(dim=1) == 2).sum()) > 50
    last = moves.gather(0, (st["iters"].long() - 1).clamp(min=0)[None])[0]
    assert int(((last == bgm.MOVE_LATERAL) & ~st["hit"]).sum()) > 10  # left sideways
    starts_in = (st["hvox"] == torch.floor(o).int()).all(dim=1) & st["hit"]
    assert int(starts_in.sum()) > 50


def _host_traverse(host_lib, tree, o, d, max_iters):
    from voxelhex_tpu_torch.ops.traverse import trace_params

    n = o.shape[0]
    out = [torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
           torch.zeros((n, 3), dtype=torch.int32), torch.zeros((n, 3)), torch.zeros((n, 3))]
    host_lib.host_traverse(o.data_ptr(), d.data_ptr(), tree["occ_pairs"].data_ptr(),
                           tree["colors"].data_ptr(), trace_params(tree, max_iters), n,
                           *[t.data_ptr() for t in out])
    return out


# budgets that cut rays at their first steps and inside an ADVANCE step
CUT_STEPS = [1, 2, 3, 7]


@pytest.mark.parametrize("size,density", GRIDS)
@pytest.mark.parametrize("max_iters", CUT_STEPS + [2048])
def test_traverse_kernel_source_every_move(host_lib, size, density, max_iters):
    """Bit for bit on the every-move rays, also where max_iters cuts them."""
    from voxelhex_tpu_torch.ops.traverse import traverse_plain

    tree = _tree(size, density, half=True)
    o, d = _every_move_rays(tree)
    out = _host_traverse(host_lib, tree, o, d, max_iters)
    want = traverse_plain(tree, o, d, max_iters)
    for a, b in zip(out, want):
        assert _equal(a, b)


def _cut_cameras(tree, res):
    """Cameras whose rays take every kind of start: from outside the world
    (orbit), from inside an occupied voxel, from an empty point inside, and
    along the z axis, whose rays have d.y = 0 at a resolution of one row."""
    from voxelhex_tpu_torch.render.camera import Camera, orbit_camera

    size = float(tree["size"])
    vox = _occupied_voxels(tree)[7] + 0.5
    mid = np.array([size / 2 + 0.25] * 3, dtype=np.float32)
    axis_from = mid - np.array([0.0, 0.0, 0.9 * size], dtype=np.float32)
    return [orbit_camera(size, yaw_deg=130.0, resolution=res),
            Camera(origin=vox.astype(np.float32), target=vox + np.float32([3.0, 1.0, 2.0]),
                   resolution=res),
            Camera(origin=mid, target=mid + np.float32([-1.0, 2.0, 1.5]), resolution=res),
            Camera(origin=axis_from, target=mid, resolution=res)]


@pytest.mark.parametrize("max_iters", CUT_STEPS)
@pytest.mark.parametrize("res", [(37, 21), (37, 1)])
def test_frame_kernel_source_cut_steps(host_lib, max_iters, res):
    from voxelhex_tpu_torch.ops.frame import frame_params, render_frame_plain

    tree = _tree(64, 0.02)
    bg = (0.1, 0.2, 0.3)
    w, h = res
    for cam in _cut_cameras(tree, res):
        out = torch.full((h, w, 3), 7.0)
        host_lib.host_frame(tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(),
                            tree["palette"].data_ptr(), tree["palette"].shape[0],
                            frame_params(tree, cam, bg, max_iters), out.data_ptr(), None)
        assert _equal(out, render_frame_plain(tree, cam, bg, False, max_iters))


@pytest.mark.parametrize("max_iters", CUT_STEPS)
@pytest.mark.parametrize("res", [(37, 21), (37, 1)])
def test_frames_kernel_source_cut_steps(host_lib, max_iters, res):
    """The four cameras of ``_cut_cameras`` as one batch, u8 with digests."""
    from voxelhex_tpu_torch.ops.frame import render_frame_plain
    from voxelhex_tpu_torch.ops.frames import launch_frames, render_frames_plain

    tree = _tree(64, 0.02)
    cams = _cut_cameras(tree, res)
    bg = (0.1, 0.2, 0.3)
    prev = render_frame_plain(tree, cams[-1], bg, True, max_iters)
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames, tree, cams, bg, True,
                                             max_iters, prev)
    want, nrows, flags = render_frames_plain(tree, cams, bg, True, max_iters, prev)
    assert launches == 1 and _equal(frames, want)
    assert _equal(digest[:, 0], nrows) and _equal(digest[:, 1:], flags)


@pytest.mark.parametrize("size,density", GRIDS)
def test_multihit_kernel_source_every_move(host_lib, size, density):
    """The multi-hit march of the every-move rays with one step a hit
    (a budget of 2): rays cut at their first steps and after a hit."""
    from voxelhex_tpu_torch.ops.multihit import multihit_plain

    tree = _tree(size, density, half=True)
    o, d = _every_move_rays(tree)
    for max_iters in (1, 2048):
        out = _host_multihit(host_lib, tree, o, d, 2, max_iters)
        want = multihit_plain(tree, o, d, 2, max_iters)
        for a, b in zip(out, want):
            assert _equal(a, b)


def test_voxel_addr_is_64_bit(host_lib):
    """The address of the last voxel of a 2048^3 world (8,589,934,591) and a
    few others: in 32 bits they would wrap."""
    for x, y, z, size in ((2047, 2047, 2047, 2048), (0, 0, 1291, 1291), (5, 1290, 1290, 1291),
                          (3, 2, 1, 16)):
        assert host_lib.host_voxel_addr(x, y, z, size) == x + y * size + z * size * size


def test_shade_kernel_source_equals_plain(host_lib):
    from voxelhex_tpu_torch.ops.shade import shade_plain

    rng = np.random.default_rng(3)
    R, P = 1999, 37
    hit = torch.from_numpy(rng.random(R) < 0.7)
    voxel = torch.from_numpy(rng.integers(-1, P + 3, R).astype(np.int32))
    voxel[rng.random(R) < 0.1] = 0x3FFFFFFE  # NO_COLOR_HIT
    normal = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    palette = torch.from_numpy(rng.random((P, 4)).astype(np.float32))
    bg = (0.1, 0.2, 0.3)
    for out_u8 in (True, False):
        out = torch.zeros((R, 3), dtype=torch.uint8 if out_u8 else torch.float32)
        host_lib.host_shade(hit.data_ptr(), voxel.data_ptr(), normal.data_ptr(),
                            palette.data_ptr(), P, *bg, R, None if out_u8 else out.data_ptr(),
                            out.data_ptr() if out_u8 else None)
        assert _equal(out, shade_plain(hit, voxel, normal, palette, bg, out_u8))


def _rays_into(size, n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def _host_multihit(host_lib, tree, o, d, max_hits, max_iters=2048):
    """The multi-hit kernel on the host, into outputs that start as garbage,
    so that a slot the kernel does not write shows."""
    from voxelhex_tpu_torch.ops.traverse import trace_params

    n = o.shape[0]
    out = [torch.full((n,), 7, dtype=torch.int32),
           torch.full((n, max_hits, 3), 7, dtype=torch.int32),
           torch.full((n, max_hits), 7.0)]
    host_lib.host_multihit(o.data_ptr(), d.data_ptr(), tree["occ_pairs"].data_ptr(),
                           trace_params(tree, max_iters), n, max_hits,
                           *[t.data_ptr() for t in out])
    return out


@pytest.mark.parametrize("size,density", GRIDS)
@pytest.mark.parametrize("max_hits,max_iters", [(3, 2048), (2, 6)])
def test_multihit_kernel_source_equals_plain(host_lib, size, density, max_hits, max_iters):
    """Bit for bit, also when the step budget (max_hits * max_iters) cuts rays."""
    from voxelhex_tpu_torch.ops.multihit import multihit_plain

    tree = _tree(size, density)
    o, d = _rays_into(size, 1500, 1)
    out = _host_multihit(host_lib, tree, o, d, max_hits, max_iters)
    want = multihit_plain(tree, o, d, max_hits, max_iters)
    assert int((want[0] >= 2).sum()) > 10  # rays that march on after a hit
    for a, b in zip(out, want):
        assert _equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 33, 769, 2000])
def test_multihit_kernel_source_ray_counts(host_lib, n):
    """Ray counts below a warp, ragged ones (not a multiple of 32 or of the
    128-thread block) and several blocks: every ray's slots are written, and
    the threads past the last ray write nothing."""
    from voxelhex_tpu_torch.ops.multihit import multihit_plain

    tree = _tree(64, 0.02)
    o, d = _rays_into(64, n, 3)
    out = _host_multihit(host_lib, tree, o, d, 2)
    want = multihit_plain(tree, o, d, 2)
    for a, b in zip(out, want):
        assert a.shape == b.shape and _equal(a, b)


def _soft_inputs(size, K, seed):
    """Params and recorded voxels for the composite: random flat params and
    the multi-hit march of random rays (with duplicate voxels across rays)."""
    from voxelhex_tpu_torch.ops.multihit import multihit_plain

    rng = np.random.default_rng(seed)
    n = size**3
    albedo = torch.from_numpy(rng.random(3 * n).astype(np.float32))
    logits = torch.from_numpy(rng.normal(0, 3, n).astype(np.float32))
    tree = _tree(size, 0.05)
    o, d = _rays_into(size, 1200, seed)
    _count, voxels, _dists = multihit_plain(tree, o, d, K)
    grad = torch.from_numpy(rng.normal(0, 1e-3, (o.shape[0], 3)).astype(np.float32))
    return albedo, logits, voxels, grad


# The composite's sigmoid calls expf: the host's libm and PyTorch's vectorized
# exp may round an alpha differently by an ulp, which moves an rgb value by
# about as much (atol 1e-6) and a gradient by a few ulps of its terms.
@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("bg", [None, (0.25, 0.5, 0.75)])
@pytest.mark.parametrize("packed", [True, False])
def test_composite_kernel_sources_equal_plain(host_lib, K, bg, packed):
    from voxelhex_tpu_torch.ops.composite import composite_backward_plain, composite_forward_plain

    size = 16
    albedo, logits, voxels, grad = _soft_inputs(size, K, 7 + K)
    if not packed:  # empty slots first: each slot is valid or not on its own
        voxels = voxels.flip(1).contiguous()
        assert K == 1 or bool(((voxels[:, 0, 0] < 0) & (voxels[:, -1, 0] >= 0)).any())
    R = voxels.shape[0]
    bg_arg = None if bg is None else (ctypes.c_float * 3)(*bg)
    rgb = torch.full((R, 3), 7.0)
    assert host_lib.host_composite(0, None, albedo.data_ptr(), logits.data_ptr(),
                                   voxels.data_ptr(), R, K, size, bg_arg, rgb.data_ptr(),
                                   None, None) == 0
    want = composite_forward_plain(albedo, logits, voxels, size, bg)
    np.testing.assert_allclose(rgb.numpy(), want.numpy(), rtol=0, atol=1e-6)

    g_albedo, g_logits = torch.zeros_like(albedo), torch.zeros_like(logits)
    assert host_lib.host_composite(1, grad.data_ptr(), albedo.data_ptr(), logits.data_ptr(),
                                   voxels.data_ptr(), R, K, size, bg_arg, None,
                                   g_albedo.data_ptr(), g_logits.data_ptr()) == 0
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, size, bg)
    assert int((wl != 0).sum()) > 100
    for got, ref in ((g_albedo, wa), (g_logits, wl)):
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-6 * scale)
        assert bool(((got == 0) == (ref == 0)).all())  # the same voxels receive gradient


@pytest.mark.parametrize("fit_albedo,opacity_l1", [(True, 0.0), (False, 0.0), (True, 0.3)])
def test_adam_kernel_source_equals_plain(host_lib, fit_albedo, opacity_l1):
    """Two steps; bit for bit without the L1 term, whose sigmoid calls expf."""
    from voxelhex_tpu_torch.ops.adam import AdamConfig, adam_params, adam_plain

    rng = np.random.default_rng(11)
    n = 3000
    cfg = AdamConfig(0.05)
    extra = (opacity_l1, ((0.0, 1.0), (-12.0, 12.0)))

    def state():
        return {"albedo": torch.from_numpy(rng.random(3 * n).astype(np.float32)),
                "logits": torch.from_numpy(rng.normal(0, 6, n).astype(np.float32))}

    params = state()
    moments = {"count": torch.tensor(6, dtype=torch.int32),
               "mu": {k: v * 1e-3 for k, v in state().items()},
               "nu": {k: v * v * 1e-6 for k, v in state().items()}}
    kp = {k: v.clone() for k, v in params.items()}
    km = {"count": moments["count"].clone(),
          "mu": {k: v.clone() for k, v in moments["mu"].items()},
          "nu": {k: v.clone() for k, v in moments["nu"].items()}}
    for step in range(2):
        grads = {k: torch.from_numpy(rng.normal(0, 1e-3, v.shape).astype(np.float32))
                 for k, v in params.items()}
        if not fit_albedo:
            grads["albedo"] = None
        moments = adam_plain(params, grads, moments, cfg, *extra)
        new_count = torch.zeros((), dtype=torch.int32)
        ga = grads["albedo"]
        host_lib.host_adam(kp["albedo"].data_ptr(), None if ga is None else ga.data_ptr(),
                           km["mu"]["albedo"].data_ptr(), km["nu"]["albedo"].data_ptr(), 3 * n,
                           kp["logits"].data_ptr(), grads["logits"].data_ptr(),
                           km["mu"]["logits"].data_ptr(), km["nu"]["logits"].data_ptr(), n,
                           km["count"].data_ptr(), new_count.data_ptr(),
                           adam_params(cfg, n, *extra), 3)  # 3 blocks: the grid-stride loop wraps
        km["count"] = new_count
        assert int(new_count) == int(moments["count"]) == 7 + step
        for got, ref in ((kp, params), (km["mu"], moments["mu"]), (km["nu"], moments["nu"])):
            for k in got:
                if opacity_l1 and k == "logits":
                    np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6,
                                               atol=1e-9)
                else:
                    assert _equal(got[k], ref[k]), (step, k)
