"""The CUDA kernels' sources, compiled for the host and run on the CPU,
against their plain PyTorch versions, bit for bit.

A CUDA kernel cannot run without a card, but its arithmetic can: the host
compiler builds ``csrc/frame.cu`` and ``csrc/traverse.cu`` against a small
header that stands in for the CUDA names they use (``__fmaf_rn`` is the
correctly rounded ``fmaf``, ``__fdiv_rn`` an IEEE division, ...; no
contraction of multiply-adds), and a loop runs every thread of every block
in turn.  That checks the kernels' logic (pixel tiles, ragged edges, the
level table, the reciprocal multiplications, ray generation, shading) on
grids of 2, 3 and 4 pyramid levels.  What it cannot check (the nvcc build,
the launch, the card's own arithmetic) ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py`` check on the card.  Skips where there is no C++
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
struct uint2 { uint32_t x, y; };
struct int2 { int x, y; };
struct float4 { float x, y, z, w; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim;
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
using std::signbit;
"""

# every thread of every block in turn; __syncthreads is a no-op, which is
# right for kernels whose threads share only what thread 0 writes before it
HARNESS = r"""
#include "cuda_runtime.h"
dim3 threadIdx, blockIdx, blockDim;
#include "frame_host.cu"
namespace trav {
#include "traverse_host.cu"
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
    shutil.copy(os.path.join(CSRC, "traverse.cuh"), d)
    launch = re.compile(r"<<<[^>]*>>>")  # a launch becomes a call of one thread
    with open(os.path.join(CSRC, "frame.cu")) as f:
        (d / "frame_host.cu").write_text(launch.sub("", f.read()))
    with open(os.path.join(CSRC, "traverse.cu")) as f:
        (d / "traverse_host.cu").write_text(
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
    lib.host_traverse.argtypes = [p, p, p, p, ctypes.POINTER(_build.TraceParams), ctypes.c_int,
                                  p, p, p, p, p]
    return lib


def _tree(size, density):
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    rng = np.random.default_rng(size)
    occ = rng.random((size, size, size)) < density
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
