"""The CUDA kernels' sources, compiled for the host and run on the CPU,
against their plain PyTorch versions.

A CUDA kernel cannot run without a card, but its arithmetic can: the host
compiler builds every source of ``csrc/`` against a small header that
stands in for the CUDA names they use (``__fmaf_rn`` is the correctly
rounded ``fmaf``, ``__fdiv_rn`` an IEEE division, ``atomicAdd`` a plain
add, ...; no contraction of multiply-adds), and a loop runs every thread of
every block in turn; for the albedo kernels, whose backward merges runs in
a warp, each warp's 32 lanes run as threads that meet in each warp
intrinsic (``__shfl_sync``, ``__match_any_sync``, ...), so the merging
runs as on the card, with atomics taken one at a time; and for the region
scatter, the coarse rebuild and the far frame, whose threads share shared
memory, a block's threads run as threads that meet at each
``__syncthreads`` (the blocks in turn, the last first), each warp's lanes
in its intrinsics.  That
checks the kernels' logic (pixel tiles, ragged edges, the level table, the
reciprocal multiplications, ray generation, shading, the batched kernel's
frames, chunks and row digests, the multi-hit march's one loop per ray,
the composite's recurrence, the optimizer's order of operations, the
albedo gather and shading, the albedo backward's chunks, runs and warp
merging at any input alignment, the rebuild's ballots and its last block's
ticket, the far frame's layers) on grids of 2, 3 and 4 pyramid levels,
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
import functools
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
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#include <math.h>
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// thread_local: the lanes of a warp run as threads (vhx_host_warp_launch)
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
#define __grid_constant__
// the f32 atomics the kernels issue, counted (vhx_host_atomics); one at a
// time, as the lanes of a warp may run at once
extern long long vhx_host_atomics;
extern std::mutex vhx_host_atomic_lock;
inline float atomicAdd(float* p, float v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    ++vhx_host_atomics;
    float old = *p;
    *p = old + v;
    return old;
}
inline float2 atomicAdd(float2* p, float2 v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    ++vhx_host_atomics;
    float2 old = *p;
    p->x = old.x + v.x;
    p->y = old.y + v.y;
    return old;
}
inline float2 make_float2(float a, float b) { return {a, b}; }
// a warp: vhx_host_warp_launch runs its 32 lanes as threads, which meet in
// each warp intrinsic: every lane puts its value in a slot, waits for the
// other 31, reads what it needs, and waits again before a slot is reused.
// Every lane of the warp must take part (the mask is full), as on the card.
struct VhxWarp {
    std::mutex m;
    std::condition_variable cv;
    int arrived = 0;
    unsigned long long generation = 0;
    uint64_t slot[32];
    void sync() {
        std::unique_lock<std::mutex> hold(m);
        const unsigned long long g = generation;
        if (++arrived == 32) {
            arrived = 0;
            ++generation;
            cv.notify_all();
        } else {
            cv.wait(hold, [&] { return generation != g; });
        }
    }
    // every lane's value as 64 bits: put yours, then f(slots) once all have
    template <class T, class F>
    auto meet(T v, F f) {
        static_assert(sizeof(T) <= 8, "a lane's value is at most 8 B");
        uint64_t bits = 0;
        std::memcpy(&bits, &v, sizeof(T));
        slot[threadIdx.x & 31] = bits;
        sync();
        auto out = f(slot);
        sync();
        return out;
    }
};
// the warp of this thread (vhx_host_warp_launch, vhx_host_block_launch)
extern thread_local VhxWarp* vhx_warp;
template <class T>
inline T vhx_lane_value(T v, int src) {
    const uint64_t bits = vhx_warp->meet(v, [&](const uint64_t* s) { return s[src]; });
    T out;
    std::memcpy(&out, &bits, sizeof(T));
    return out;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
    return vhx_lane_value(v, src & 31);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
    const int lane = threadIdx.x & 31;
    return vhx_lane_value(v, lane >= (int)d ? lane - (int)d : lane);
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
    const int lane = threadIdx.x & 31;
    return vhx_lane_value(v, lane + (int)d < 32 ? lane + (int)d : lane);
}
inline unsigned __any_sync(unsigned, int pred) {
    return vhx_warp->meet(pred != 0, [](const uint64_t* s) {
        unsigned any = 0;
        for (int i = 0; i < 32; ++i) any |= (unsigned)s[i];
        return any;
    });
}
template <class T> inline unsigned __match_any_sync(unsigned, T v) {
    const int lane = threadIdx.x & 31;
    return vhx_warp->meet(v, [&](const uint64_t* s) {
        unsigned mask = 0;
        for (int i = 0; i < 32; ++i) mask |= (unsigned)(s[i] == s[lane]) << i;
        return mask;
    });
}
inline unsigned __ballot_sync(unsigned, int pred) {
    return vhx_warp->meet(pred != 0, [](const uint64_t* s) {
        unsigned ballot = 0;
        for (int i = 0; i < 32; ++i) ballot |= (unsigned)(s[i] != 0) << i;
        return ballot;
    });
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    int old = *p;
    *p = old + v;
    return old;
}
inline int atomicOr(int* p, int v) { int old = *p; *p = old | v; return old; }
// the flags that blocks poll are set by atomicExch, which wakes the
// pollers (__nanosleep)
extern std::condition_variable vhx_flag_cv;
inline int atomicExch(int* p, int v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    int old = *p;
    *p = v;
    vhx_flag_cv.notify_all();
    return old;
}
inline void __trap() { std::abort(); }
// the int min and max of the splat prepass: one at a time, counted
inline int atomicMin(int* p, int v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    ++vhx_host_atomics;
    int old = *p;
    *p = v < old ? v : old;
    return old;
}
inline int atomicMax(int* p, int v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    ++vhx_host_atomics;
    int old = *p;
    *p = v > old ? v : old;
    return old;
}
inline unsigned long long atomicMax(unsigned long long* p, unsigned long long v) {
    std::lock_guard<std::mutex> hold(vhx_host_atomic_lock);
    ++vhx_host_atomics;
    unsigned long long old = *p;
    *p = v > old ? v : old;
    return old;
}
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
// a block: vhx_host_block_launch runs its threads as threads, which meet at
// each __syncthreads.  A thread that leaves the kernel while others wait at
// a barrier, or before one, aborts: on the card every thread of the block
// has to reach each barrier.
struct VhxBlock {
    std::mutex m;
    std::condition_variable cv;
    int n, arrived = 0, exited = 0;
    unsigned long long generation = 0;
    explicit VhxBlock(int threads) : n(threads) {}
    void sync() {
        std::unique_lock<std::mutex> hold(m);
        if (exited) std::abort();
        const unsigned long long g = generation;
        if (++arrived == n) {
            if (gated && !open) {
                at_gate = true;
                cv.notify_all();
                cv.wait(hold, [&] { return open; });
            }
            arrived = 0;
            ++generation;
            cv.notify_all();
        } else {
            cv.wait(hold, [&] { return generation != g || exited; });
            if (generation == g) std::abort();
        }
    }
    void exit() {
        std::lock_guard<std::mutex> hold(m);
        ++exited;
        cv.notify_all();
    }
    // under vhx_host_grid_launch: the block waits at its first barrier
    // until the launch opens it, and says when a thread first polls
    bool gated = false, at_gate = false, open = false, polled = false;
    void poll() {
        std::lock_guard<std::mutex> hold(m);
        polled = true;
        cv.notify_all();
    }
    // the block's own shared variables (vhx_block_shared), zeroed
    std::map<int, std::unique_ptr<unsigned char[]>> shared;
    template <class T>
    T& shared_var(int key) {
        std::lock_guard<std::mutex> hold(m);
        auto& bytes = shared[key];
        if (!bytes) bytes.reset(new unsigned char[sizeof(T)]());
        return *reinterpret_cast<T*>(bytes.get());
    }
};
extern thread_local VhxBlock* vhx_block;
// a __shared__ variable of a kernel under vhx_host_grid_launch, whose
// blocks run at once: the test rewrites `__shared__ T name[N];` into
// `auto& name = vhx_block_shared<T[N]>(__LINE__);`
template <class T>
inline T& vhx_block_shared(int key) { return vhx_block->shared_var<T>(key); }
// a thread polling a flag: its block is marked as polling, and it sleeps
// until a flag is set or 1 ms passes; a wait of two minutes aborts, as the
// card's kernel traps (a new wait: over 100 ms since this thread last slept)
extern long long vhx_host_polls;
inline void __nanosleep(unsigned) {
    using clock = std::chrono::steady_clock;
    thread_local clock::time_point since, last;
    const clock::time_point now = clock::now();
    if (now - last > std::chrono::milliseconds(100)) since = now;
    if (now - since > std::chrono::seconds(120)) std::abort();
    if (vhx_block) vhx_block->poll();
    std::unique_lock<std::mutex> hold(vhx_host_atomic_lock);
    ++vhx_host_polls;
    vhx_flag_cv.wait_for(hold, std::chrono::milliseconds(1));
    last = clock::now();
}
inline int2 make_int2(int a, int b) { return {a, b}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    return {a, b, c, d};
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stwb(T* p, T v) { *p = v; }
// a barrier of the block under vhx_host_block_launch; elsewhere the threads
// run one after another and share only what thread 0 writes before it
inline void __syncthreads() {
    if (vhx_block) vhx_block->sync();
}
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
// block of the 3-D grid in turn
template <class F>
inline void vhx_host_launch(dim3 grid, unsigned threads, int, cudaStream_t, F kernel) {
    blockDim = dim3(threads);
    gridDim = grid;
    for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
            for (unsigned bx = 0; bx < grid.x; ++bx)
                for (unsigned t = 0; t < threads; ++t) {
                    blockIdx = dim3(bx, by, bz);
                    threadIdx = dim3(t);
                    kernel();
                }
}
// a launch of a kernel with warp intrinsics, rewritten into this call: the
// blocks in turn and their warps in turn, a warp's 32 lanes as threads
// (VhxWarp); blocks of whole warps only
template <class F>
inline void vhx_host_warp_launch(dim3 grid, unsigned threads, int, cudaStream_t, F kernel) {
    if (threads % 32) std::abort();
    blockDim = dim3(threads);
    gridDim = grid;
    for (unsigned bx = 0; bx < grid.x; ++bx)
        for (unsigned w = 0; w < threads; w += 32) {
            VhxWarp warp;
            vhx_warp = &warp;
            std::vector<std::thread> lanes;
            for (unsigned t = w; t < w + 32; ++t)
                lanes.emplace_back([&, t] {
                    blockIdx = dim3(bx);
                    threadIdx = dim3(t);
                    vhx_warp = &warp;
                    kernel();
                });
            for (auto& lane : lanes) lane.join();
        }
}
// a launch of a kernel whose threads meet at __syncthreads, rewritten into
// this call: the blocks of the 2-D grid in turn, last block first (a kernel
// must not depend on the order of its blocks), each block's threads as
// threads (VhxBlock), each warp's lanes meeting in the warp intrinsics
// (VhxWarp); blocks of whole warps only
template <class F>
inline void vhx_host_block_launch(dim3 grid, unsigned threads, int, cudaStream_t, F kernel) {
    if (threads % 32) std::abort();
    blockDim = dim3(threads);
    gridDim = grid;
    const unsigned n = grid.x * grid.y;
    for (unsigned i = 0; i < n; ++i) {
        const unsigned b = n - 1 - i;
        VhxBlock block(threads);
        std::vector<VhxWarp> warps(threads / 32);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < threads; ++t)
            ts.emplace_back([&, t] {
                blockIdx = dim3(b % grid.x, b / grid.x);
                threadIdx = dim3(t);
                vhx_warp = &warps[t / 32];
                vhx_block = &block;
                kernel();
                block.exit();
                vhx_block = nullptr;
            });
        for (auto& t : ts) t.join();
    }
}
// a launch of a kernel whose blocks wait for each other's flags, rewritten
// into this call: every block at once, its threads as threads (VhxBlock),
// its shared variables its own (vhx_block_shared).  The blocks start one
// at a time, block 0 first, each held at its first barrier, so that what
// a block takes before it (a ticket) follows the block's index; then they
// go on from there in the reverse order, each once the block before has
// ended or has begun to poll (__nanosleep).  So a later block runs as far
// as it can before an earlier one starts: each of its waits polls, and a
// missing wait reads what the earlier block has not yet written.
template <class F>
inline void vhx_host_grid_launch(dim3 grid, unsigned threads, int, cudaStream_t, F kernel) {
    if (threads % 32) std::abort();
    blockDim = dim3(threads);
    gridDim = grid;
    const unsigned n = grid.x * grid.y;
    std::vector<std::unique_ptr<VhxBlock>> blocks;
    std::vector<std::unique_ptr<VhxWarp[]>> warps;
    std::vector<std::thread> ts;
    const auto done = [&](VhxBlock& block) { return block.exited == (int)threads; };
    for (unsigned b = 0; b < n; ++b) {
        blocks.emplace_back(new VhxBlock(threads));
        warps.emplace_back(new VhxWarp[threads / 32]);
        VhxBlock& block = *blocks.back();
        VhxWarp* ws = warps.back().get();
        block.gated = true;
        for (unsigned t = 0; t < threads; ++t)
            ts.emplace_back([&, b, t, ws] {
                blockIdx = dim3(b % grid.x, b / grid.x);
                threadIdx = dim3(t);
                vhx_warp = &ws[t / 32];
                vhx_block = &block;
                kernel();
                block.exit();
                vhx_block = nullptr;
            });
        std::unique_lock<std::mutex> hold(block.m);
        block.cv.wait(hold, [&] { return block.at_gate || done(block); });
    }
    for (unsigned b = n; b-- > 0;) {
        VhxBlock& block = *blocks[b];
        std::unique_lock<std::mutex> hold(block.m);
        block.open = true;
        block.cv.notify_all();
        block.cv.wait(hold, [&] { return block.polled || done(block); });
    }
    for (auto& t : ts) t.join();
}
"""

# the kernels and the host's entries to them
HARNESS = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local VhxWarp* vhx_warp = nullptr;
thread_local VhxBlock* vhx_block = nullptr;
std::mutex vhx_host_atomic_lock;
long long vhx_host_atomics = 0;
extern "C" long long host_atomics() { return vhx_host_atomics; }
std::condition_variable vhx_flag_cv;
long long vhx_host_polls = 0;
extern "C" long long host_polls() { return vhx_host_polls; }
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
namespace alb {
#include "albedo_host.cu"
}
namespace frm {
#include "frames_host.cu"
}
namespace strm {
#include "stream_host.cu"
}
namespace farn {
#include "far_host.cu"
}
namespace bm {
#include "beam_host.cu"
}
namespace spl {
#include "splat_host.cu"
}
namespace pre {
#include "prepass_host.cu"
}
// prepass.cu with two of its waits cut when vhx_host_fault says so: bit 1
// the left neighbour's (thread 0), bit 2 the first coarser tile's (thread
// 3); a test shows that the launch's output then differs
int vhx_host_fault = 0;
extern "C" void host_set_fault(int fault) { vhx_host_fault = fault; }
namespace prefault {
#include "prepass_fault_host.cu"
}
extern "C" int host_prepass_fault(const void* words, const void* params, int n, int substeps,
                                  float* const* depths, float* start, int* sync, int epoch) {
    return prefault::vhx_prepass(words, static_cast<const prefault::PrepassParams*>(params), n,
                                 substeps, depths, start, sync, epoch, 0, nullptr);
}

// frame.cu's frame from a start map, every thread of every block in turn
extern "C" void host_frame_start(const void* occ, const void* colors, const float* palette,
                                 int n_colors, const FrameParams* P, const float* start,
                                 int tile, float* rgb, unsigned char* u8) {
    blockDim = dim3(THREADS);
    for (unsigned by = 0; by < (unsigned)(P->h + WARP_H - 1) / WARP_H; ++by)
        for (unsigned bx = 0; bx < (unsigned)(P->w + BLOCK_W - 1) / BLOCK_W; ++bx)
            for (unsigned t = 0; t < (unsigned)THREADS; ++t) {
                blockIdx = dim3(bx, by);
                threadIdx = dim3(t);
                frame_start_kernel((const uint2*)occ, (const unsigned short*)colors,
                                   (const float4*)palette, n_colors, *P, start, tile,
                                   (P->w + tile - 1) / tile, rgb, u8);
            }
}


// traverse.cu's and multihit.cu's C entries, their launches loops over the
// grid
extern "C" int host_traverse_skip(const float* o, const float* d, const void* rows,
                                  const void* colors, const TraceParams* P, int R, int substeps,
                                  void* hit, int* voxel, int* hvox, float* point,
                                  float* hnormal) {
    return trav::vhx_traverse_skip(o, d, rows, colors, P, R, substeps, hit, voxel, hvox, point,
                                   hnormal, 0, nullptr);
}
extern "C" int host_multihit_start(const float* o, const float* d, const void* words,
                                   const TraceParams* P, int R, int K, const float* start,
                                   int tile, int w, int substeps, int* count, int* voxels,
                                   float* dists) {
    if (substeps)
        return mh::vhx_multihit_skip(o, d, words, P, R, K, substeps, start, tile, w, count,
                                     voxels, dists, 0, nullptr);
    return mh::vhx_multihit_start(o, d, words, P, R, K, start, tile, w, count, voxels, dists, 0,
                                  nullptr);
}

// traverse.cuh's init of each ray, from `start` (kStart) or without it
extern "C" void host_init(const float* o, const float* d, const void* occ, const TraceParams* P,
                          const float* start, int R, float* point, int* active, int* tsect) {
    int2 levels[VHX_MAX_LEVELS];
    for (int i = 0; i < VHX_MAX_LEVELS; ++i) levels[i] = make_int2(P->bases[i], P->dims[i]);
    const vhx::Grid g{(const uint2*)occ, levels, P->n_levels, P->size, P->n_blocks};
    for (int r = 0; r < R; ++r) {
        vhx::March m;
        if (start) vhx::init<true>(m, o + 3 * r, d + 3 * r, g, start[r]);
        else vhx::init(m, o + 3 * r, d + 3 * r, g);
        for (int c = 0; c < 3; ++c) point[3 * r + c] = m.p[c];
        active[r] = m.active;
        tsect[r] = m.tsect;
    }
}

// the warp stand-ins on their own: each lane's key from the lane above, the
// lane below and lane 7 l mod 32, the lanes of equal keys, whether any key
// is 3, the lowest of those lanes + 1, and an f32 from three lanes below
static void warp_probe(const long long* keys, long long* out) {
    constexpr unsigned FULL = 0xffffffffu;
    const int t = blockIdx.x * blockDim.x + threadIdx.x, lane = threadIdx.x & 31;
    const long long k = keys[t];
    long long* o = out + 7 * t;
    o[0] = __shfl_up_sync(FULL, k, 1);
    o[1] = __shfl_down_sync(FULL, k, 1);
    o[2] = __shfl_sync(FULL, k, (7 * lane) & 31);
    const unsigned group = __match_any_sync(FULL, k);
    o[3] = group;
    o[4] = __any_sync(FULL, k == 3);
    o[5] = __ffs(group);
    o[6] = (long long)(4 * __shfl_down_sync(FULL, 0.25f * (float)k, 3));
}
extern "C" void host_warp_probe(const long long* keys, long long* out, int n) {
    vhx_host_warp_launch(dim3(1), n, 0, nullptr, [&] { warp_probe(keys, out); });
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
    const unsigned blocks = (R + comp::THREADS - 1) / comp::THREADS;
    if (backward)  // its lanes merge their adds: a warp's lanes as threads
        vhx_host_warp_launch(dim3(blocks), comp::THREADS, 0, nullptr, [&] {
            comp::composite_bwd_kernel<K>(grad, albedo, logits, voxels, nullptr, R, size, b0, b1,
                                          b2, bg ? 1 : 0, g_albedo, g_logits);
        });
    else
        each_thread(blocks, comp::THREADS, [&] {
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
        case 6: composite_k<6>(backward, grad, albedo, logits, voxels, R, size, bg, out, g_albedo, g_logits); return 0;
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
    for header in ("traverse.cuh", "frame.cuh", "skip.cuh"):
        shutil.copy(os.path.join(CSRC, header), d)
    launch = re.compile(r"<<<[^>]*>>>")  # a launch becomes a call of one thread
    # the batched kernel runs through its C entry, whose launch becomes a
    # loop over the grid (vhx_host_launch): the test drives the entry, its
    # checks and its memset as the wrapper does; and so do the albedo
    # kernels', whose launches run a warp's lanes as threads
    # (vhx_host_warp_launch) for the backward's warp intrinsics, and the
    # region scatter's, the coarse rebuild's and the far frame's, whose
    # launches run a block's threads as threads that meet at its barriers
    # (vhx_host_block_launch)
    entry = re.compile(r"(\w+(?:<[\w ,]+>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
    block_kernels = ("coarse_kernel", "far_kernel", "far_start_kernel", "region_scatter_kernel",
                     "splat_texel_kernel")
    # and the depth prepass's, whose blocks wait for each other's flags: all
    # its blocks at once, a later one running before an earlier one
    # (vhx_host_grid_launch), each with shared variables of its own
    grid_kernels = ("prepass_frame_kernel",)
    shared = re.compile(r"__shared__ ([\w:]+) (\w+)((?:\[[^\]]+\])*);")

    def launcher_of(default):
        def sub(m):
            kernel = m.group(1).split("<")[0]
            launcher = ("vhx_host_block_launch" if kernel in block_kernels else
                        "vhx_host_grid_launch" if kernel in grid_kernels else default)
            return f"{launcher}({m.group(2)}, [&] {{ {m.group(1)}({m.group(3)}); }});"
        return sub

    for name, launcher, n_launches in (("frame", "vhx_host_launch", 6),
                                       ("traverse", "vhx_host_launch", 4),
                                       ("multihit", "vhx_host_launch", 2),
                                       ("frames", "vhx_host_launch", 5),
                                       ("albedo", "vhx_host_warp_launch", 2),
                                       ("stream", "vhx_host_launch", 6),
                                       ("far", "vhx_host_launch", 4),
                                       ("beam", "vhx_host_launch", 1),
                                       ("splat", "vhx_host_launch", 2),
                                       ("prepass", "vhx_host_launch", 2)):
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src, n = entry.subn(launcher_of(launcher), f.read())
        assert n == n_launches
        if name in ("traverse", "multihit"):  # included in a namespace of the harness
            src = src.replace('extern "C" ', "")
        if name == "prepass":
            src = shared.sub(r"auto& \2 = vhx_block_shared<\1\3>(__LINE__);", src)
            fault = src.replace('extern "C" ', "")
            # the stack instance alone: the copy refuses the skip tracer
            skip = fault.index("    if (substeps)\n        return vhx::skip_depth(F.trace")
            fault = (fault[:skip] + "    if (substeps) return cudaErrorInvalidValue;\n"
                     + fault[fault.index("    return launch_frame<0>(", skip):])
            for cut in ("if (tid == 0 && tx > 0", "if (tid >= 3 && tid < 7"):
                assert fault.count(cut) == 1
            fault = fault.replace("if (tid == 0 && tx > 0",
                                  "if (tid == 0 && tx > 0 && !(vhx_host_fault & 1)")
            fault = fault.replace("if (tid >= 3 && tid < 7",
                                  "if (tid >= 3 && tid < 7 && !(vhx_host_fault & 2 && tid == 3)")
            (d / "prepass_fault_host.cu").write_text(fault)
        (d / f"{name}_host.cu").write_text(src)
    for name in ("shade", "composite", "adam"):
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            (d / f"{name}_host.cu").write_text(
                launch.sub("", f.read()).replace('extern "C" ', ""))
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libkernels_host.so"
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
         "-fPIC", "-shared", f"-I{d}",
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
    lib.vhx_albedo_forward.argtypes = [p, p, p, p, p, i, i, i, ctypes.POINTER(f), p, i, p]
    lib.vhx_albedo_backward.argtypes = [p, p, p, p, p, i, i, i, p, i, p]
    lib.host_atomics.restype = ctypes.c_longlong
    lib.host_polls.restype = ctypes.c_longlong
    lib.host_set_fault.argtypes = [i]
    lib.host_prepass_fault.argtypes = [p, ctypes.POINTER(_build.PrepassParams), i, i,
                                       ctypes.POINTER(p), p, p, i]
    lib.host_prepass_fault.restype = i
    lib.vhx_region_scatter.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.vhx_coarse_rebuild.argtypes = [p, ctypes.POINTER(i), ctypes.POINTER(i), i, p, i, p]
    lib.vhx_window_shift.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.vhx_render_far.argtypes = [ctypes.POINTER(_build.FarParams), p, p, i, p]
    lib.vhx_render_far_start.argtypes = [ctypes.POINTER(_build.FarParams), p, i, p, p, i, p]
    lib.vhx_render_frames_start.argtypes = [p, p, p, i, ctypes.POINTER(_build.FramesParams),
                                            p, i, ctypes.c_uint, p, p, p, p, i, p]
    lib.host_frame_start.argtypes = [p, p, p, i, ctypes.POINTER(_build.FrameParams), p, i, p,
                                     p]
    lib.vhx_beam.argtypes = [ctypes.POINTER(_build.BeamParams), p, i, p]
    lib.vhx_splat.argtypes = [p, ctypes.POINTER(_build.SplatParams), p, i, p, i, p]
    lib.vhx_splat_block_words.argtypes = [i, i]
    lib.vhx_splat_scratch_words.argtypes = [i, i]
    lib.vhx_prepass.argtypes = [p, ctypes.POINTER(_build.PrepassParams), i, i,
                                ctypes.POINTER(p), p, p, i, i, p]
    lib.vhx_prepass_sync_words.argtypes = [i, i, i]
    for name in ("vhx_splat_scratch_words", "vhx_prepass_sync_words"):
        getattr(lib, name).restype = ctypes.c_longlong
    for name in ("vhx_beam_params_size", "vhx_beam_max_grids", "vhx_splat_params_size",
                 "vhx_prepass_params_size", "vhx_prepass_max_levels"):
        getattr(lib, name).restype = i
    lib.vhx_far_params_size.restype = i
    lib.vhx_far_max_layers.restype = i
    for name in ("vhx_region_scatter", "vhx_coarse_rebuild", "vhx_window_shift",
                 "vhx_render_far", "vhx_render_far_start", "vhx_render_frames_start",
                 "vhx_beam", "vhx_splat", "vhx_splat_block_words", "vhx_prepass"):
        getattr(lib, name).restype = i
    lib.host_init.argtypes = [p, p, p, ctypes.POINTER(_build.TraceParams), p, i, p, p, p]
    lib.vhx_render_frame_skip.argtypes = [p, p, p, i, ctypes.POINTER(_build.FrameParams), i, p,
                                          i, p, p, i, p]
    lib.host_traverse_skip.argtypes = [p, p, p, p, ctypes.POINTER(_build.TraceParams), i, i,
                                       p, p, p, p, p]
    lib.host_multihit_start.argtypes = [p, p, p, ctypes.POINTER(_build.TraceParams), i, i, p,
                                        i, i, i, p, p, p]
    lib.vhx_render_frames_skip.argtypes = [p, p, p, i, ctypes.POINTER(_build.FramesParams), i,
                                           p, i, ctypes.c_uint, p, p, p, p, i, p]
    for name in ("host_traverse_skip", "host_multihit_start", "vhx_render_frames_skip",
                 "vhx_render_frame_skip"):
        getattr(lib, name).restype = i
    lib.host_warp_probe.argtypes = [p, p, i]
    lib.host_adam.argtypes = [p, p, p, p, ctypes.c_longlong, p, p, p, p, ctypes.c_longlong, p,
                              p, ctypes.POINTER(_build.AdamParams), i]
    return lib


def _tree(size, density, half=False, skip=False):
    """A random grid; with ``half``, the voxels at x >= size / 2 are empty,
    so that rays there ascend past the top level; with ``skip``, with its
    skip rows."""
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    rng = np.random.default_rng(size)
    occ = rng.random((size, size, size)) < density
    if half:
        occ[size // 2:] = False
    colors = np.where(occ, rng.integers(0, 5, occ.shape), 0xFFFF).astype(np.uint16)
    bg = bitgrid_from_occupancy(occ, palette=rng.random((5, 4)))
    bg.colors = np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel()
    return device_bitgrid(bg, "cpu", skip_rows=skip)


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
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames_start, tree, cams, bg, True,
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
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames_start, tree, cams,
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
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames_start, tree, cams, bg, True,
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
@pytest.mark.parametrize("K", [1, 2, 4, 6])
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


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_stand_ins(host_lib, seed):
    """The harness's warp (its 32 lanes run as threads that meet in each
    intrinsic) gives the card's shuffles, votes and matches, on two warps
    of random keys."""
    keys = np.random.default_rng(seed).integers(0, 6, 64)
    out = np.zeros((64, 7), np.int64)
    host_lib.host_warp_probe(keys.ctypes.data, out.ctypes.data, 64)
    for w in range(2):
        k = keys[32 * w:32 * w + 32]
        for lane in range(32):
            group = sum(1 << j for j in range(32) if k[j] == k[lane])
            want = [k[max(lane - 1, 0) if lane else lane], k[lane + 1] if lane < 31 else k[lane],
                    k[7 * lane % 32], group, int((k == 3).any()), (group & -group).bit_length(),
                    k[lane + 3] if lane < 29 else k[lane]]
            assert list(out[32 * w + lane]) == want, (w, lane)


def _albedo_rays(case, R, rng, B, d3):
    """hit, brick, cell of R rays.  "random": rows drawn at random (few
    runs), misses, hits with no params, rows clipped into range.  "runs":
    image-ordered runs of 1-64 rays on one row, and some of 600-1100 rays
    that cross warps' chunks (a warp takes 32 x 4 rays), all contributing.
    "broken": those runs with misses and hits with brick < 0 inside them.
    "miss": no ray hits."""
    if case == "miss":
        return np.zeros(R, bool), rng.integers(0, B, R), rng.integers(0, d3, R)
    if case == "random":
        return (rng.random(R) < 0.8, rng.integers(-1, B + 1, R), rng.integers(-1, d3 + 1, R))
    lengths = np.where(rng.random(R) < 0.03, rng.integers(600, 1100, R), rng.integers(1, 65, R))
    row = np.repeat(rng.integers(0, B * d3, R), lengths)[:R]
    hit, brick, cell = np.ones(R, bool), row // d3, row % d3
    if case == "broken":
        hit &= rng.random(R) > 0.1
        brick[rng.random(R) < 0.1] = -1
    return hit, brick, cell


def _host_view(t, offset):
    """``t`` as a view that starts ``offset`` bytes into a larger buffer."""
    n = offset // t.element_size()
    buf = torch.zeros(t.numel() + n, dtype=t.dtype)
    v = buf[n:].view(t.shape)
    v.copy_(t)
    return v


# R = 1, 300 and 1027 random rays; long runs, and runs broken by misses and
# by brick < 0, of 16 k and 16 k + 7 rays (a ragged last chunk); inputs at
# unaligned offsets in bytes (hit, brick and cell, normal, dL/drgb); no
# ray that hits (every warp leaves at once; the gradient is the entry's fill)
ALBEDO_CASES = [pytest.param(1, "random", None, id="1"),
                pytest.param(300, "random", None, id="300"),
                pytest.param(1027, "random", None, id="1027"),
                pytest.param(4096, "runs", None, id="runs"),
                pytest.param(4103, "runs", None, id="runs-ragged"),
                pytest.param(4096, "broken", None, id="broken"),
                pytest.param(4103, "broken", None, id="broken-ragged"),
                pytest.param(4103, "broken", (1, 4, 12, 4), id="broken-offset-1-4-12-4"),
                pytest.param(4100, "runs", (5, 8, 4, 8), id="runs-offset-5-8-4-8"),
                pytest.param(1027, "random", (15, 12, 8, 4), id="random-offset-15-12-8-4"),
                pytest.param(1027, "miss", (3, 4, 4, 4), id="miss-offset-3-4-4-4")]


@pytest.mark.parametrize("R,case,offsets", ALBEDO_CASES)
def test_albedo_kernel_sources_equal_plain(host_lib, R, case, offsets):
    """Through the C entries, as the wrappers call them: the forward bit for
    bit (misses, hits with no params, rows clipped into range, random
    normals); the backward against ``index_add_``, with the zero pattern
    equal, and its atomics as many as ``backward_adds`` counts from the
    data.  The backward sums a run of rays on one row in another order than
    ``index_add_``'s sequential adds: recursive f32 summation of n terms is
    within (n - 1) u sum|x| (u = 2^-24) of the exact sum, so the two are
    within 2 (n - 1) u sum|x| of each other, for each element of n terms;
    the random cases keep their earlier tolerance too."""
    from voxelhex_tpu_torch.ops.albedo import (albedo_backward_plain, albedo_forward_plain,
                                               backward_adds, lambert)

    rng = np.random.default_rng(R)
    B, d3 = 7, 64
    params = torch.from_numpy(rng.random((B, d3, 3)).astype(np.float32))
    h, b, c = _albedo_rays(case, R, rng, B, d3)
    hit = torch.from_numpy(h)
    brick = torch.from_numpy(b.astype(np.int32))
    cell = torch.from_numpy(c.astype(np.int32))
    normal = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    if offsets is not None:
        o_hit, o_idx, o_normal, o_grad = offsets
        hit, brick, cell = _host_view(hit, o_hit), _host_view(brick, o_idx), _host_view(cell, o_idx)
        normal, g_rgb = _host_view(normal, o_normal), _host_view(g_rgb, o_grad)
        assert hit.data_ptr() % 16 == o_hit and normal.data_ptr() % 16 == o_normal
    bg = (0.25, 0.5, 0.75)
    rgb = torch.full((R, 3), 7.0)
    assert host_lib.vhx_albedo_forward(params.data_ptr(), hit.data_ptr(), brick.data_ptr(),
                                       cell.data_ptr(), normal.data_ptr(), R, B, d3,
                                       (ctypes.c_float * 3)(*bg), rgb.data_ptr(), 0, None) == 0
    want = albedo_forward_plain(params, hit, brick, cell, normal, bg)
    assert _equal(rgb, want) and bool((torch.signbit(rgb) == torch.signbit(want)).all())
    g = torch.full((B * d3 * 3,), 7.0)  # the entry zeroes it
    n0 = host_lib.host_atomics()
    assert host_lib.vhx_albedo_backward(g_rgb.data_ptr(), hit.data_ptr(), brick.data_ptr(),
                                        cell.data_ptr(), normal.data_ptr(), R, B, d3,
                                        g.data_ptr(), 0, None) == 0
    assert host_lib.host_atomics() - n0 == backward_adds(hit, brick, cell, (B, d3))[0]
    ref = albedo_backward_plain(g_rgb, hit, brick, cell, normal, (B, d3)).reshape(-1)
    ok = (hit & (brick >= 0)).numpy()
    row = np.clip(brick.numpy(), 0, B - 1)[ok] * d3 + np.clip(cell.numpy(), 0, d3 - 1)[ok]
    terms = np.abs(g_rgb.numpy()[ok].astype(np.float64)
                   * lambert(normal[ok]).numpy()[:, None])
    n = np.bincount(row, minlength=B * d3)[:, None]
    abs_sum = np.stack([np.bincount(row, terms[:, ch], B * d3) for ch in range(3)], 1)
    tol = torch.from_numpy((2 * np.maximum(n - 1, 0) * 2.0 ** -24 * abs_sum).reshape(-1))
    assert bool(((g.double() - ref.double()).abs() <= tol).all())
    if case == "random":
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert bool(((g == 0) == (ref == 0)).all())


# ---- the streaming view's kernels (csrc/stream.cu) and its far-field frame
# (csrc/far.cu), through their C entries

def _window(S, density, seed=0):
    """A random window of edge S on the CPU (``device_bitgrid``)."""
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    rng = np.random.default_rng(seed)
    occ = rng.random((S, S, S)) < density
    bg = bitgrid_from_occupancy(occ, palette=rng.random((300, 4)))
    colors = np.where(occ, rng.integers(0, 300, occ.shape), 0xFFFF).astype(np.uint16)
    bg.colors = np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel()
    return device_bitgrid(bg, "cpu")


def _clone(tree):
    return dict(tree, colors=tree["colors"].clone(), occ_pairs=tree["occ_pairs"].clone())


@pytest.mark.parametrize("wide", [False, True])
def test_region_scatter_kernel_source_equals_plain(host_lib, wide):
    """Regions at corners all over a 64 window, both wires: u8 with its two
    sentinels, and u16 (past 254 palette colors)."""
    from voxelhex_tpu_torch.ops.stream import region_scatter_plain

    S = 64
    tree = _window(S, 0.05)
    rng = np.random.default_rng(3)
    n = S // 16
    picks = rng.choice(n**3, 9, replace=False)
    corners = torch.from_numpy(np.stack([picks % n, picks // n % n, picks // (n * n)], 1)
                               .astype(np.int32) * 16)
    if wide:
        vals = torch.from_numpy(rng.integers(0, 2**16, (9, 4096)).astype(np.uint16).view(np.int16))
    else:
        vals = torch.from_numpy(rng.integers(0, 256, (9, 4096)).astype(np.uint8))
        vals[0, :8] = 255
        vals[1, :8] = 254
    blk = torch.from_numpy(rng.integers(0, 2**32, (9, 64, 2), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32))
    want = _clone(tree)
    region_scatter_plain(want["colors"], want["occ_pairs"], corners, vals, blk, S)
    got = _clone(tree)
    assert host_lib.vhx_region_scatter(got["colors"].data_ptr(), got["occ_pairs"].data_ptr(),
                                       corners.data_ptr(), vals.data_ptr(), blk.data_ptr(), 9,
                                       S, int(wide), 0, None) == 0
    assert not _equal(want["colors"], tree["colors"])
    assert _equal(got["colors"], want["colors"]) and _equal(got["occ_pairs"], want["occ_pairs"])
    assert host_lib.vhx_region_scatter(got["colors"].data_ptr(), got["occ_pairs"].data_ptr(),
                                       corners.data_ptr(), vals.data_ptr(), blk.data_ptr(), 9,
                                       S + 8, int(wide), 0, None) != 0


def _wire(rng, K, wide):
    """K regions' wire colors with both sentinels in every (y, z) row."""
    if wide:
        vals = rng.integers(0, 2**16, (K, 16, 256)).astype(np.uint16)
        sentinels = (0xFFFF, 0xFFFE)
    else:
        vals = rng.integers(0, 254, (K, 16, 256)).astype(np.uint8)
        sentinels = (255, 254)
    rows = np.arange(256)
    for k in range(K):
        x = rng.permutation(16)
        vals[k, x[rows % 16], rows] = sentinels[0]  # the wire is [x, (y, z)]
        vals[k, x[(rows + 5) % 16], rows] = sentinels[1]
    vals = vals.reshape(K, 4096)
    return torch.from_numpy(vals.view(np.int16) if wide else vals)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("case", ["far corner", "far x", "far y", "far z", "one region",
                                  "every region"])
def test_region_scatter_kernel_source_edges(host_lib, wide, case):
    """A window of 48 (a multiple of 16, not a power of two): one region at
    the far corner, at the far edge S - 16 of one axis, or anywhere, and
    every region of the window (27 blocks); both wires, sentinels in every
    row.  The regions' voxels and pairs equal the plain scatter's and every
    other voxel and pair of the window is left as it was."""
    from voxelhex_tpu_torch.ops.stream import region_scatter_plain

    S = 48
    tree = _window(S, 0.05, seed=11)
    rng = np.random.default_rng(len(case) + wide)
    n = S // 16
    far = S - 16
    corners = {"far corner": [[far, far, far]], "far x": [[far, 16, 0]],
               "far y": [[0, far, 16]], "far z": [[16, 0, far]],
               "one region": [[16, 16, 16]],
               "every region": [[x, y, z] for x, y, z in
                                rng.permutation(np.stack(np.meshgrid(*[np.arange(n) * 16] * 3,
                                                                     indexing="ij"), -1)
                                                .reshape(-1, 3))]}[case]
    corners = torch.tensor(corners, dtype=torch.int32)
    K = corners.shape[0]
    vals = _wire(rng, K, wide)
    blk = torch.from_numpy(rng.integers(0, 2**32, (K, 64, 2), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32))
    want = _clone(tree)
    region_scatter_plain(want["colors"], want["occ_pairs"], corners, vals, blk, S)
    got = _clone(tree)
    assert host_lib.vhx_region_scatter(got["colors"].data_ptr(), got["occ_pairs"].data_ptr(),
                                       corners.data_ptr(), vals.data_ptr(), blk.data_ptr(), K,
                                       S, int(wide), 0, None) == 0
    assert _equal(got["colors"], want["colors"]) and _equal(got["occ_pairs"], want["occ_pairs"])
    # the regions' voxels and pairs hold the wire; the rest is as it was
    inside = torch.zeros((S, S, S), dtype=torch.bool)  # [z, y, x]
    inside_pairs = torch.zeros(got["occ_pairs"].shape[0], dtype=torch.bool)
    nb = S // 4
    for x, y, z in corners.tolist():
        inside[z:z + 16, y:y + 16, x:x + 16] = True
        blocks = torch.zeros((nb, nb, nb), dtype=torch.bool)
        blocks[z // 4:z // 4 + 4, y // 4:y // 4 + 4, x // 4:x // 4 + 4] = True
        inside_pairs[: nb**3] |= blocks.reshape(-1)
    inside = inside.reshape(-1)
    assert _equal(got["colors"][~inside], tree["colors"][~inside])
    assert _equal(got["occ_pairs"][~inside_pairs], tree["occ_pairs"][~inside_pairs])
    assert int(inside.sum()) == K * 4096 and int(inside_pairs.sum()) == K * 64
    u16 = got["colors"][inside].numpy().view(np.uint16)
    assert (u16 == 0xFFFF).sum() >= K * 256 and (u16 == 0xFFFE).sum() >= K * 256


def test_region_scatter_kernel_entry_rejects_misaligned(host_lib):
    """The C entry refuses grids, wire or pairs that are not 16 B aligned
    (its 16 B stores and loads), and a window whose edge is not a multiple
    of 16."""
    S = 32
    tree = _window(S, 0.05)
    corners = torch.zeros((1, 3), dtype=torch.int32)
    vals = torch.zeros(2 * 4096 + 16, dtype=torch.uint8)
    blk = torch.zeros(2 * 128 + 4, dtype=torch.int32)
    colors, pairs = tree["colors"], tree["occ_pairs"]

    def call(c, p, v, b, size=S):
        return host_lib.vhx_region_scatter(c, p, corners.data_ptr(), v, b, 1, size, 0, 0, None)

    args = [colors.data_ptr(), pairs.data_ptr(), vals.data_ptr(), blk.data_ptr()]
    assert all(a % 16 == 0 for a in args) and call(*args) == 0
    for i, step in enumerate((2, 8, 1, 4)):
        bad = list(args)
        bad[i] += step
        assert call(*bad) != 0
    assert call(*args, size=40) != 0


@pytest.mark.parametrize("S", [48, 64, 128])
def test_coarse_rebuild_kernel_source_equals_plain(host_lib, S):
    """Levels above 0 from a level 0 that the upper levels do not match; at
    48 and 128 a level's blocks an axis are not a multiple of 4 (3, 2)."""
    from voxelhex_tpu_torch.ops.stream import _ints, coarse_rebuild_plain

    tree = _window(S, 0.002, seed=S)
    nb = S // 4
    rng = np.random.default_rng(S)
    tree["occ_pairs"][: nb**3] = torch.from_numpy(
        (rng.random((nb**3, 2)) < 0.02).astype(np.int32) * rng.integers(1, 2**31, (nb**3, 2))
        .astype(np.int32))
    want = coarse_rebuild_plain(tree["occ_pairs"].clone(), tree["bases"], tree["dims"])
    got = tree["occ_pairs"].clone()
    tickets = torch.zeros(1, dtype=torch.int32)
    assert host_lib.vhx_coarse_rebuild(got.data_ptr(), _ints(tree["bases"]),
                                       _ints(tree["dims"]), len(tree["bases"]),
                                       tickets.data_ptr(), 0, None) == 0
    assert not _equal(want, tree["occ_pairs"])
    assert _equal(got, want)


def _random_level0(tree, rng, share):
    """Level 0 of ``tree`` set to random words, ``share`` of them not zero."""
    nb = int(tree["dims"][0])
    tree["occ_pairs"][: nb**3] = torch.from_numpy(
        (rng.random((nb**3, 2)) < share).astype(np.int32)
        * rng.integers(1, 2**31, (nb**3, 2)).astype(np.int32))


@pytest.mark.parametrize("S", [16, 128])
def test_coarse_rebuild_kernel_source_twice_in_a_row(host_lib, S):
    """Two rebuilds through one ticket counter, level 0 changed between
    them: the last block of the first sets the counter back to 0, so the
    second's last block is found again (at 128: 8 blocks, level 3 made by
    the last; at 16 a pyramid of two levels, one block, no ticket)."""
    from voxelhex_tpu_torch.ops.stream import _ints, coarse_rebuild_plain

    tree = _window(S, 0.002, seed=S + 1)
    rng = np.random.default_rng(S + 1)
    tickets = torch.zeros(1, dtype=torch.int32)
    got = tree["occ_pairs"].clone()
    for share in (0.02, 0.3):
        _random_level0(tree, rng, share)
        got[: int(tree["dims"][0]) ** 3] = tree["occ_pairs"][: int(tree["dims"][0]) ** 3]
        want = coarse_rebuild_plain(tree["occ_pairs"].clone(), tree["bases"], tree["dims"])
        assert host_lib.vhx_coarse_rebuild(got.data_ptr(), _ints(tree["bases"]),
                                           _ints(tree["dims"]), len(tree["bases"]),
                                           tickets.data_ptr(), 0, None) == 0
        assert _equal(got, want) and int(tickets) == 0


def test_coarse_rebuild_kernel_entry_rejects_bad_levels(host_lib):
    """The C entry refuses a level table whose dims are not each a quarter
    of the level's below, rounded up, and more levels than the table holds;
    a pyramid of one level has nothing to rebuild."""
    from voxelhex_tpu_torch.ops.stream import _ints

    pairs = torch.zeros((64 + 1, 2), dtype=torch.int32)
    tickets = torch.zeros(1, dtype=torch.int32)

    def call(bases, dims):
        return host_lib.vhx_coarse_rebuild(pairs.data_ptr(), _ints(bases), _ints(dims),
                                           len(bases), tickets.data_ptr(), 0, None)

    assert call([0, 64], [4, 1]) == 0
    assert call([0], [4]) == 0
    assert call([0, 64], [4, 2]) != 0
    assert call([0] * 13, [1] * 13) != 0


@pytest.mark.parametrize("shift", [(16, 0, 32), (-16, -48, 0), (32, -16, 16), (64, 0, 0),
                                   (0, 0, 0), (-80, 16, 0), (4, 8, -4), (-12, 0, 0)])
def test_window_shift_kernel_source_equals_plain(host_lib, shift):
    """Positive, negative and mixed moves, a move by the whole window and
    past it, and none; moves along x by a multiple of 8 move 8 colors a
    thread, the others one."""
    from voxelhex_tpu_torch.ops.stream import window_shift_plain

    S = 64
    tree = _window(S, 0.05, seed=7)
    want = window_shift_plain(tree["colors"], tree["occ_pairs"], S, shift)
    got = (torch.zeros_like(tree["colors"]), torch.zeros_like(tree["occ_pairs"]))
    assert host_lib.vhx_window_shift(tree["colors"].data_ptr(), got[0].data_ptr(),
                                     tree["occ_pairs"].data_ptr(), got[1].data_ptr(),
                                     tree["occ_pairs"].shape[0], S, *shift, 0, None) == 0
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])
    assert host_lib.vhx_window_shift(tree["colors"].data_ptr(), got[0].data_ptr(),
                                     tree["occ_pairs"].data_ptr(), got[1].data_ptr(),
                                     tree["occ_pairs"].shape[0], S, 2, 0, 0, 0, None) != 0


def _far_case(n_layers, inside, res=(37, 21)):
    """A window of 16 and rings of 32 cells at factor 2 and 64 at factor 4,
    random content, one world camera seen from each layer's frame."""
    from dataclasses import replace

    from voxelhex_tpu_torch.render.camera import Camera

    eye = np.array([8.5, 9.0, 7.5] if inside else [-20.0, 30.0, -25.0], dtype=np.float32)
    target = np.array([40.0, 4.0, 50.0], dtype=np.float32)
    cam = Camera(origin=eye, target=target, resolution=res, fov_y_deg=55.0)
    layers = []
    for i, (size, density, factor, origin) in enumerate(
            [(16, 0.02, 1, (0, 0, 0)), (32, 0.03, 2, (0, 0, 0)), (64, 0.01, 4, (-64, 0, -64))]
            [:n_layers]):
        o = np.asarray(origin, dtype=np.float32)
        c = replace(cam, origin=(eye - o) / np.float32(factor),
                    target=(target - o) / np.float32(factor))
        layers.append((_tree(size, density), c, factor))
    return layers


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("inside", [True, False])
@pytest.mark.parametrize("out_u8", [True, False])
def test_far_kernel_source_equals_plain(host_lib, n_layers, inside, out_u8):
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.far import far_frame_plain, far_params

    assert host_lib.vhx_far_params_size() == ctypes.sizeof(_build.FarParams)
    assert host_lib.vhx_far_max_layers() == _build.FAR_MAX_LAYERS
    layers = _far_case(n_layers, inside)
    bg = (0.1, 0.2, 0.3)
    out = torch.full((21, 37, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
    assert host_lib.vhx_render_far(far_params(layers, inside, bg),
                                   None if out_u8 else out.data_ptr(),
                                   out.data_ptr() if out_u8 else None, 0, None) == 0
    want = far_frame_plain(layers, inside, bg, out_u8)
    assert len(torch.unique(want.reshape(-1, 3), dim=0)) >= 3
    assert _equal(out, want)
    if n_layers > 1:  # a ring's hits show where the window misses
        assert not _equal(want, far_frame_plain(layers[:1], inside, bg, out_u8))


def _floor_case(res):
    """The camera inside a 16 window whose voxels are a floor (y < 5) and a
    ring of 32 cells at factor 2 around it, looking level: the frame's upper
    rows see the sky in the window and go on to the ring, its lower rows hit
    the floor, and the rows between mix."""
    from dataclasses import replace

    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.camera import Camera

    rng = np.random.default_rng(4)
    occ = rng.random((16, 16, 16)) < 0.6
    occ[:, 5:] = False
    window = bitgrid_from_occupancy(occ, palette=rng.random((5, 4)))
    window.colors = np.ascontiguousarray(np.where(occ, rng.integers(0, 5, occ.shape), 0xFFFF)
                                         .astype(np.uint16).transpose(2, 1, 0)).ravel()
    eye = np.array([8.0, 7.0, 2.5], dtype=np.float32)
    target = np.array([9.0, 6.0, 40.0], dtype=np.float32)
    cam = Camera(origin=eye, target=target, resolution=res, fov_y_deg=70.0)
    ring_cam = replace(cam, origin=eye / np.float32(2), target=target / np.float32(2))
    return [(device_bitgrid(window, "cpu"), cam, 1), (_tree(32, 0.03), ring_cam, 2)]


@pytest.mark.parametrize("out_u8", [True, False])
def test_far_kernel_source_blocks_that_go_on_to_the_ring(host_lib, out_u8):
    """With the camera inside, blocks where none, some and all of the pixels
    go on to the ring, and a ragged edge that cuts blocks and warps (61 x
    43), equal to the plain version bit for bit."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, far_params

    w, h = 61, 43
    layers = _floor_case((w, h))
    stats = []
    want = far_frame_plain(layers, True, (0.1, 0.2, 0.3), out_u8, stats=stats)
    go = np.zeros((-(-h // 8) * 8, -(-w // 16) * 16), bool)
    go[:h, :w] = ~stats[0]["hit"].reshape(h, w).numpy()
    per_block = go.reshape(go.shape[0] // 8, 8, go.shape[1] // 16, 16).sum(axis=(1, 3))
    inner = per_block[:h // 8, :w // 16]
    assert (inner == 0).any() and (inner == 128).any() and ((inner > 0) & (inner < 128)).any()
    assert stats[1]["rays"] == int(go.sum())
    out = torch.full((h, w, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
    assert host_lib.vhx_render_far(far_params(layers, True, (0.1, 0.2, 0.3)),
                                   None if out_u8 else out.data_ptr(),
                                   out.data_ptr() if out_u8 else None, 0, None) == 0
    assert _equal(out, want)
    assert not _equal(want, far_frame_plain(layers[:1], True, (0.1, 0.2, 0.3), out_u8))


def _grazing_rays(size, n, seed):
    """Rays from outside and inside the box [0, size)^3 with starts about
    their exit distance: up to 2e-3 before it (where the clip to tmax - 1e-3
    binds), at it and past it, and zero; rays that skim a face."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4, 1] = rng.uniform(-1e-4, 1e-4, n // 4).astype(np.float32)  # skim y faces
    o[: n // 4, 1] = np.float32(size) * rng.choice([0.0, 1.0], n // 4).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    S = np.float32(size)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo, t_hi = (np.float32(0) - o) / d, (S - o) / d
    tmax = np.fmin(np.fmin(np.fmax(t_lo, t_hi)[:, 0], np.fmax(t_lo, t_hi)[:, 1]),
                   np.fmax(t_lo, t_hi)[:, 2])
    k = rng.integers(0, 4, n)
    u = rng.uniform(0, 2e-3, n).astype(np.float32)
    start = np.where(k == 0, tmax - u, np.where(k == 1, tmax, np.where(k == 2, tmax + u, 0)))
    start = np.nan_to_num(start.astype(np.float32), posinf=1e9, neginf=0)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(start.astype(np.float32))


@pytest.mark.parametrize("size,density", GRIDS)
@pytest.mark.parametrize("with_start", [True, False])
def test_init_source_equals_plain_at_the_start_clip(host_lib, size, density, with_start):
    """traverse.cuh's init from start_t, and without it, on rays whose
    start sits at their exit: point, active and sectant bit for bit."""
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, trace_params
    from voxelhex_tpu_torch.render.bitgrid import make_bitgrid_tracer

    tree = _tree(size, density)
    o, d, start = _grazing_rays(size, 4000, seed=size)
    trace = make_bitgrid_tracer(len(tree["bases"]), size, **KERNEL_CONFIG)
    want = trace.init(tree, o, d, start if with_start else None)
    n = o.shape[0]
    point, active, tsect = torch.zeros((n, 3)), torch.zeros(n, dtype=torch.int32), \
        torch.zeros(n, dtype=torch.int32)
    host_lib.host_init(o.data_ptr(), d.data_ptr(), tree["occ_pairs"].data_ptr(),
                       trace_params(tree), start.data_ptr() if with_start else None, n,
                       point.data_ptr(), active.data_ptr(), tsect.data_ptr())
    assert _equal(point, want["point"])
    assert _equal(active.bool(), want["active"]) and _equal(tsect, want["tsect"])
    if with_start:
        assert 0 < int(want["active"].sum()) < n


# ---- the start prepasses: beam.cu, splat.cu, prepass.cu, and the frame
# kernels' start maps


def _beam_world(size):
    """A random grid whose beam world at L = 1 has size / 4 + 2 cells a
    side (66 at size 256: not a power of 4, its top block padded), packed
    by the renderer's own steps."""
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.starts import beam_occupancy

    rng = np.random.default_rng(size)
    occ = np.zeros((size, size, size), dtype=bool)
    occ[:, : size // 8] = rng.random((size, size // 8, size)) < 0.02  # a sparse floor
    occ[size // 4: size // 2, : size // 2, size // 4: size // 2] |= (
        rng.random((size // 4, size // 2, size // 4)) < 0.01)
    bg = bitgrid_from_occupancy(occ)
    return bg, device_bitgrid(bitgrid_from_occupancy(beam_occupancy(bg, 1)), "cpu")


def _beam_world_258():
    """A random dilated grid of 258^3 cells built directly (the beam world of
    a 1024 world at L = 1): 279,672 word pairs, 2.2 MB."""
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    rng = np.random.default_rng(258)
    occ = np.zeros((258, 258, 258), dtype=bool)
    occ[:, :24] = rng.random((258, 24, 258)) < 0.02
    occ[64:128, :128, 64:128] |= rng.random((64, 128, 64)) < 0.01
    return device_bitgrid(bitgrid_from_occupancy(occ), "cpu")


@pytest.mark.parametrize("size", [64, 256, 1024])
def test_beam_kernel_source_equals_plain(host_lib, size):
    """beam.cu's C entry against the plain beams, bit for bit, over a beam
    world of size / 4 + 2 cells (18 and 66 at 64 and 256, beside the L = 2
    world of 6 and 18 cells), and at 1024 over a 258^3 world (2.2 MB of word
    pairs): four cameras in one launch, in grid order L = 1, none (0s),
    L = 2, L = 1 (at 1024: L = 1, none, L = 1), at a beam resolution of 33 x
    25 whose 4 x 8 warp patches are ragged on the right and at the bottom,
    with beams that hit, leave the world and run out of steps."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.beam import beam_params, beam_tiles_plain
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.camera import Camera, orbit_camera
    from voxelhex_tpu_torch.render.starts import beam_occupancy

    assert host_lib.vhx_beam_params_size() == ctypes.sizeof(_build.BeamParams)
    assert host_lib.vhx_beam_max_grids() == _build.BEAM_MAX_GRIDS
    res = (264, 200)
    cams = [orbit_camera(float(size), yaw_deg=30.0, resolution=res),
            Camera(origin=np.array([0.3, 0.2, 0.4]) * size, target=np.array([0.9, 0.1, 0.8]) * size,
                   resolution=res, fov_y_deg=70.0),
            orbit_camera(float(size), yaw_deg=200.0, resolution=res)]
    if size == 1024:
        grid = _beam_world_258()
        beams = [(grid, 4.0, cams[0]), (None, 1.0, cams[2]), (grid, 4.0, cams[1])]
    else:
        bg, grid = _beam_world(size)
        assert grid["size"] == size // 4 + 2
        grid2 = device_bitgrid(bitgrid_from_occupancy(beam_occupancy(bg, 2)), "cpu")
        beams = [(grid, 4.0, cams[0]), (None, 1.0, cams[2]), (grid2, 16.0, cams[1]),
                 (grid, 4.0, cams[1])]
    out = torch.full((len(beams), 25, 33), 7.0)
    assert host_lib.vhx_beam(beam_params(beams, 8), out.data_ptr(), 0, None) == 0
    stats = {}
    for k, (g, cell, cam) in enumerate(beams):
        if g is None:
            assert not out[k].any()
            continue
        want = beam_tiles_plain(g, cell, cam, 8, stats if k == 0 else None)
        assert _equal(out[k], want)
        if k == 0:
            assert (want == 1e8).any() and ((want > 0) & (want < 1e8)).any()
    assert stats["hit"].any() and not stats["hit"].all()


def _splat_case(camera_kind):
    from voxelhex_tpu_torch.render.camera import Camera, orbit_camera
    from voxelhex_tpu_torch.render.starts import splat_points

    bg = _beam_world(64)[0]
    pts = torch.from_numpy(splat_points(bg))
    res = (62, 46)
    if camera_kind == "far":
        cam = orbit_camera(64.0, distance_factor=3.0, resolution=res)
    elif camera_kind == "near":  # the floor's nearest voxels 5 to 12 away
        cam = Camera(origin=np.array([32.0, 5.0, -5.0]), target=np.array([32.0, 3.0, 30.0]),
                     resolution=res)
    elif camera_kind == "behind":  # the far camera and one more center 1 behind its eye
        cam = orbit_camera(64.0, distance_factor=3.0, resolution=res)
        forward = cam.basis()[0]
        behind = np.asarray(cam.origin, dtype=np.float32) - forward.astype(np.float32)
        pts = torch.cat([pts, torch.from_numpy(behind.astype(np.float32))[None]])
    else:
        cam = Camera(origin=np.array([20.0, 6.0, 22.0]), target=np.array([50.0, 2.0, 40.0]),
                     resolution=res)
    return pts, cam


@pytest.mark.parametrize("camera_kind", ["far", "near", "inside", "behind"])
def test_splat_kernel_source_equals_plain(host_lib, camera_kind):
    """splat.cu's two passes through its C entry against the plain splat
    starts, bit for bit, with their atomics counted: one a reliable
    center, and one a blocker or global flag that a center sets; behind
    the eye, a center sets the global flag alone."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.splat import project, splat_params, splat_tiles_plain

    assert host_lib.vhx_splat_params_size() == ctypes.sizeof(_build.SplatParams)
    pts, cam = _splat_case(camera_kind)
    w2, h2 = cam.resolution[0] // 2, cam.resolution[1] // 2
    scratch = torch.zeros(host_lib.vhx_splat_scratch_words(w2, h2), dtype=torch.int32)
    out = torch.full((h2, w2), 7.0)
    before = host_lib.host_atomics()
    assert host_lib.vhx_splat(pts.data_ptr(), splat_params(cam, pts.shape[0]),
                              scratch.data_ptr(), 1, out.data_ptr(), 0, None) == 0
    want = splat_tiles_plain(pts, cam)
    assert _equal(out, want)
    z, u, v, d, f_tex, sref = project(pts, cam, w2, h2)
    reliable = ((z > 0.0) & (f_tex <= 2.0) & (u >= -3.0) & (u < w2 + 3.0) & (v >= -3.0)
                & (v < h2 + 3.0))
    near = (z > 0.0) & (f_tex > 2.0) & (f_tex <= 64.0)
    eye = ((z > 0.0) & (f_tex > 64.0)) | (d < torch.clamp(sref / 64.0, min=3.0))
    in_grid = torch.ones_like(near)
    for c in (4, 16, 64):
        band = (f_tex > {4: 2.0, 16: 3.0, 64: 16.0}[c]) & (f_tex <= {4: 3.0, 16: 16.0, 64: 64.0}[c])
        gu, gv = torch.floor(u / c) + 2, torch.floor(v / c) + 2
        ok = (gu >= 0) & (gu < (w2 + c - 1) // c + 4) & (gv >= 0) & (gv < (h2 + c - 1) // c + 4)
        in_grid = torch.where(band, ok, in_grid)
    n = int(reliable.sum()) + int((near & in_grid).sum()) + int(eye.sum())
    assert host_lib.host_atomics() - before == n
    if camera_kind == "far":  # splats, and texels that start past the entry
        assert reliable.any() and (want > 0).any() and (want == 0).any()
        assert not near.any() and not eye.any()
    elif camera_kind == "near":  # blocker flags, no global one
        assert near.any() and not eye.any()
    else:  # voxels at the eye block the whole frame
        assert eye.any() and not want.any()
    if camera_kind == "behind":  # no blocker flag: the global flag alone zeroes the map
        assert not (near & in_grid).any() and reliable.any() and int(eye.sum()) == 1


@pytest.mark.parametrize("levels", [1, 2])
def test_prepass_kernel_sources_equal_plain(host_lib, levels):
    """prepass.cu's one launch through its C entry against the plain depth
    prepass, level by level (each from the plain level before) and the
    start map, and the frame from that start map (frame.cu's
    frame_start_kernel) against the plain frame from it, bit for bit, at a
    resolution whose coarse levels are ragged in the 4 x 8 warp tiles."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frame import frame_params, render_frame_plain
    from voxelhex_tpu_torch.ops.prepass import (depth_start_plain, level_camera,
                                                level_depth_plain)
    from voxelhex_tpu_torch.render.camera import orbit_camera

    assert host_lib.vhx_prepass_params_size() == ctypes.sizeof(_build.PrepassParams)
    tree = _tree(64, 0.02)
    cam = orbit_camera(64.0, yaw_deg=25.0, resolution=(100, 44))
    sync = torch.zeros(host_lib.vhx_prepass_sync_words(50, 22, levels), dtype=torch.int32)
    got, start = _host_prepass(host_lib, tree, cam, levels, 0, sync, 1)
    want = None
    for i, depth in zip(range(levels, 0, -1), got):
        want = level_depth_plain(tree, level_camera(cam, i), want)
        assert _equal(depth, want)
        assert (want == 1e8).any() and (want < 1e8).any()
    assert _equal(start, depth_start_plain(want))
    out = torch.full((44, 100, 3), 7, dtype=torch.uint8)
    host_lib.host_frame_start(tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(),
                              tree["palette"].data_ptr(), tree["palette"].shape[0],
                              frame_params(tree, cam), start.data_ptr(), 2, None,
                              out.data_ptr())
    assert _equal(out, render_frame_plain(tree, cam, start=start, start_tile=2))


def _host_prepass(host_lib, tree, cam, levels, substeps, sync, epoch, fill=7.0, fault=False):
    """prepass.cu's one launch through its C entry (with ``fault``, the
    copy whose waits ``host_set_fault`` cuts): each level's depths, the
    coarsest first, and the start map, their buffers filled with ``fill``
    before the launch."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.prepass import level_camera, prepass_params

    cams = [level_camera(cam, i) for i in range(1, levels + 1)]
    outs = [torch.full((c.resolution[1], c.resolution[0]), fill) for c in cams]
    start = torch.full_like(outs[0], fill)
    words = tree["skip_rows"] if substeps else tree["occ_pairs"]
    params = (_build.PrepassParams * levels)(*(prepass_params(tree, c) for c in cams))
    ptrs = (ctypes.c_void_p * levels)(*(t.data_ptr() for t in outs))
    args = (words.data_ptr(), params, levels, substeps, ptrs, start.data_ptr(), sync.data_ptr(),
            epoch)
    if fault:
        assert host_lib.host_prepass_fault(*args) == 0
    else:
        assert host_lib.vhx_prepass(*args, 0, None) == 0
    return outs[::-1], start


# (levels, resolution): level 1 of 50 x 22 and 52 x 28 pixels, ragged in
# the 16 x 8 level tiles and the 32 x 16 start tiles, its coarser levels
# (25 x 11; 26 x 14, 13 x 7) ragged too, so that halo reads meet the
# clamped edges of every level
PREPASS_FRAMES = [(1, (100, 44)), (2, (100, 44)), (3, (104, 56))]


@pytest.mark.parametrize("tracer", ["stack", "skip"])
@pytest.mark.parametrize("levels,res", PREPASS_FRAMES)
def test_prepass_frame_kernel_source_equals_plain(host_lib, levels, res, tracer):
    """prepass.cu's whole prepass in one launch (prepass_frame_kernel, its
    blocks all at once, a later ticket's block running before an earlier
    one's, so that its waits poll; each block's threads meeting at its
    barriers) through its C entry against the plain depth prepass: every
    level's depths and the start map bit for bit, twice on one sync buffer
    (epochs 1 and 2: the second launch starts from the first's flags and
    its ticket counter, which the last ticket put back to 0)."""
    from voxelhex_tpu_torch.ops.prepass import depth_start_plain, prepass_start
    from voxelhex_tpu_torch.render.camera import orbit_camera

    substeps = 3 if tracer == "skip" else 0
    tree = _skip_tree(64) if substeps else _tree(64, 0.02)
    cam = orbit_camera(64.0, yaw_deg=25.0, resolution=res)
    want = []
    start = prepass_start(tree, cam, levels, skip_substeps=substeps or None, depths=want)
    assert _equal(start, depth_start_plain(want[-1]))
    w1, h1 = res[0] // 2, res[1] // 2
    sync = torch.zeros(host_lib.vhx_prepass_sync_words(w1, h1, levels), dtype=torch.int32)
    for epoch in (1, 2):
        got, got_start = _host_prepass(host_lib, tree, cam, levels, substeps, sync, epoch)
        assert len(got) == levels
        for g, w in zip(got, want):
            assert _equal(g, w)
        assert _equal(got_start, start)
        assert int(sync[0]) == 0 and bool((sync[1:] == epoch).all())
    assert (want[-1] == 1e8).any() and (want[-1] < 1e8).any()


def test_prepass_frame_kernel_entry_rejects_bad_params(host_lib):
    """vhx_prepass refuses levels out of 1..8, a level that is not twice
    the next coarser one, levels of other trace params, epoch 0."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.prepass import level_camera, prepass_params
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _tree(16, 0.05)
    cam = orbit_camera(16.0, resolution=(64, 32))
    assert host_lib.vhx_prepass_max_levels() == _build.PREPASS_MAX_LEVELS
    assert host_lib.vhx_prepass_sync_words(32, 16, 0) == -1
    assert host_lib.vhx_prepass_sync_words(32, 16, 9) == -1
    assert host_lib.vhx_prepass_sync_words(32, 16, 2) == 2 * 2 + 1 * 1 + 1
    sync = torch.zeros(16, dtype=torch.int32)
    out = [torch.zeros(16, 32), torch.zeros(8, 16)]
    ptrs = (ctypes.c_void_p * 2)(*(t.data_ptr() for t in out))

    def entry(params, n=2, epoch=1):
        return host_lib.vhx_prepass(tree["occ_pairs"].data_ptr(), params, n, 0, ptrs,
                                    out[0].data_ptr(), sync.data_ptr(), epoch, 0, None)

    good = [prepass_params(tree, level_camera(cam, i)) for i in (1, 2)]
    assert entry((_build.PrepassParams * 2)(*good)) == 0
    assert entry((_build.PrepassParams * 2)(*good), epoch=0) != 0
    assert entry((_build.PrepassParams * 2)(*good), n=0) != 0
    assert entry((_build.PrepassParams * 2)(*good), n=9) != 0
    odd = prepass_params(tree, level_camera(orbit_camera(16.0, resolution=(64, 36)), 2))
    assert entry((_build.PrepassParams * 2)(good[0], odd)) != 0
    other = prepass_params(tree, level_camera(cam, 2), max_iters=7)
    assert entry((_build.PrepassParams * 2)(good[0], other)) != 0
    assert int(sync[0]) == 0


def test_prepass_frame_kernel_source_sync_reused(host_lib):
    """One sync buffer through frames of other sizes and levels in turn, as
    the wrapper keeps it on a stream: each launch's tiles and flags lie
    elsewhere in it than the last's, whose flags hold older epochs; every
    level and start map bit for bit."""
    from voxelhex_tpu_torch.ops.prepass import prepass_start
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _tree(64, 0.02)
    sync = torch.zeros(host_lib.vhx_prepass_sync_words(52, 28, 3), dtype=torch.int32)
    for epoch, (levels, res) in enumerate([(3, (104, 56)), (2, (100, 44)), (1, (100, 44)),
                                           (3, (104, 56))], start=1):
        cam = orbit_camera(64.0, yaw_deg=25.0 + 10 * epoch, resolution=res)
        want = []
        start = prepass_start(tree, cam, levels, depths=want)
        got, got_start = _host_prepass(host_lib, tree, cam, levels, 0, sync, epoch)
        for g, w in zip(got, want):
            assert _equal(g, w)
        assert _equal(got_start, start) and int(sync[0]) == 0


@pytest.mark.parametrize("fault,levels", [(0, 1), (0, 2), (1, 1), (2, 2)],
                         ids=["every-wait-1", "every-wait-2", "no-left-wait", "no-coarser-wait"])
def test_prepass_frame_kernel_source_waits(host_lib, fault, levels):
    """prepass.cu's flag waits, on a copy of the source whose waits a switch
    cuts, its blocks all at once and a later ticket's block running as far
    as it can before an earlier one's: with every wait, the waits poll and
    every level and the start map equal the plain versions; without the
    left neighbour's wait (1 level: a tile of the top row takes its start
    cells by atomicMin before its left neighbour sets them to +inf) or the
    first coarser tile's (2 levels: a tile reads the coarser level's
    depths before they are written, 1e8 there), some differ."""
    from voxelhex_tpu_torch.ops.prepass import prepass_start
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _tree(64, 0.02)
    cam = orbit_camera(64.0, yaw_deg=25.0, resolution=(100, 44))
    want = []
    start = prepass_start(tree, cam, levels, depths=want)
    sync = torch.zeros(host_lib.vhx_prepass_sync_words(50, 22, levels), dtype=torch.int32)
    polls = host_lib.host_polls()
    host_lib.host_set_fault(fault)
    try:
        got, got_start = _host_prepass(host_lib, tree, cam, levels, 0, sync, 1, fill=1e8,
                                       fault=True)
    finally:
        host_lib.host_set_fault(0)
    equal = all(_equal(g, w) for g, w in zip(got, want)) and _equal(got_start, start)
    assert equal == (fault == 0)
    if fault == 0:
        assert host_lib.host_polls() > polls
    assert int(sync[0]) == 0 and bool((sync[1:] == 1).all())


def _splat_border_case(kind):
    """The far camera of ``_splat_case`` at 90 x 42 (a 45 x 21 buffer:
    one whole 32 x 16 texel tile, ragged tiles right and below) and its
    centers, with centers built at the corner of the texel tiles' border
    (u, v) = (31.5, 15.5) and (32.5, 16.5): of footprint 2.5 texels (the
    grid of 4-texel cells), 8 (16), 32 (64), 100 (the global flag), or
    none."""
    from voxelhex_tpu_torch.render.camera import camera_params, orbit_camera
    from voxelhex_tpu_torch.render.starts import splat_points

    pts = torch.from_numpy(splat_points(_beam_world(64)[0]))
    cam = orbit_camera(64.0, distance_factor=3.0, resolution=(90, 42))
    if kind == "none":
        return pts, cam
    f_tex = {"4": 2.5, "16": 8.0, "64": 32.0, "global": 100.0}[kind]
    origin, right, up, forward, scale = (a.astype(np.float64) for a in camera_params(cam))
    w2, h2 = 45, 21
    sref = max(w2 / 2 / scale[0], h2 / 2 / scale[1])
    z = sref / f_tex
    extra = []
    for u, v in ((31.5, 15.5), (32.5, 16.5)):
        x = (u / w2 * 2 - 1) * z * scale[0]
        y = (1 - v / h2 * 2) * z * scale[1]
        extra.append(origin + forward * z + right * x + up * y)
    return torch.cat([pts, torch.from_numpy(np.array(extra, dtype=np.float32))]), cam


@pytest.mark.parametrize("kind", ["none", "4", "16", "64", "global"])
def test_splat_kernel_source_tile_borders(host_lib, kind):
    """splat.cu through its C entry against the plain splat starts, bit
    for bit, on a buffer whose width and height are not multiples of the
    texel pass's tile, with centers that flag a cell of each blocker grid,
    or the global flag, at the corner where four tiles meet; then a second
    call on the same scratch (epoch 2), whose words of the first call
    count as empty."""
    from voxelhex_tpu_torch.ops.splat import project, splat_params, splat_tiles_plain

    pts, cam = _splat_border_case(kind)
    w2, h2 = 45, 21
    want = splat_tiles_plain(pts, cam)
    scratch = torch.zeros(host_lib.vhx_splat_scratch_words(w2, h2), dtype=torch.int32)
    out = torch.full((h2, w2), 7.0)
    assert host_lib.vhx_splat(pts.data_ptr(), splat_params(cam, pts.shape[0]),
                              scratch.data_ptr(), 1, out.data_ptr(), 0, None) == 0
    assert _equal(out, want)
    z, u, v, d, f_tex, sref = project(pts, cam, w2, h2)
    if kind == "none":  # splats and texels past the entry, no flag
        assert (want > 0).any() and (want == 0).any() and not (f_tex > 2.0).any()
    elif kind == "global":
        assert not want.any()
    else:  # the flagged cells, dilated, cover the border's texels and not the frame
        assert (want[15:18, 31:34] == 0).all() and (f_tex[-2:] > 2.0).all()
        if kind == "4":
            assert (want > 0).any()
    other = splat_tiles_plain(pts[: pts.shape[0] // 2], cam)
    assert host_lib.vhx_splat(pts.data_ptr(), splat_params(cam, pts.shape[0] // 2),
                              scratch.data_ptr(), 2, out.data_ptr(), 0, None) == 0
    assert _equal(out, other)


@pytest.mark.parametrize("res", [(256, 160), (330, 118)])
def test_splat_kernel_source_tiles_no_center_reached(host_lib, res):
    """splat.cu through its C entry against the plain splat starts, bit for
    bit, on buffers of 4 x 5 and 6 x 4 texel tiles (the second ragged)
    where reliable centers reach some tiles and leave others, and tiles
    next to none of them, which the texel pass fills without reading the
    distances or the blocker grids."""
    from voxelhex_tpu_torch.ops.splat import project, splat_params, splat_tiles_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.starts import splat_points

    pts = torch.from_numpy(splat_points(_beam_world(64)[0]))
    cam = orbit_camera(64.0, distance_factor=3.0, resolution=res)
    w2, h2 = res[0] // 2, res[1] // 2
    want = splat_tiles_plain(pts, cam)
    scratch = torch.zeros(host_lib.vhx_splat_scratch_words(w2, h2), dtype=torch.int32)
    out = torch.full((h2, w2), 7.0)
    assert host_lib.vhx_splat(pts.data_ptr(), splat_params(cam, pts.shape[0]),
                              scratch.data_ptr(), 3, out.data_ptr(), 0, None) == 0
    assert _equal(out, want)
    z, u, v, d, f_tex, _sref = project(pts, cam, w2, h2)
    reliable = ((z > 0.0) & (f_tex <= 2.0) & (u >= -3.0) & (u < w2 + 3.0) & (v >= -3.0)
                & (v < h2 + 3.0))
    tiles = torch.zeros(-(-h2 // 16), -(-w2 // 32), dtype=torch.bool)
    ui = u[reliable].clamp(0, w2 - 1).long() // 32
    vi = v[reliable].clamp(0, h2 - 1).long() // 16
    tiles[vi, ui] = True
    near = torch.nn.functional.max_pool2d(tiles[None].float(), 3, 1, 1)[0] > 0
    assert tiles.any() and not near.all()


def _start_map(w, h, tile, seed):
    """A start map of every kind a prepass gives: 0, dead (1e8), and starts
    inside the world, some past the nearest voxels."""
    rng = np.random.default_rng(seed)
    shape = (-(-h // tile), -(-w // tile))
    k = rng.integers(0, 3, shape)
    vals = np.where(k == 0, 0.0, np.where(k == 1, 1e8, rng.uniform(0, 60, shape)))
    return torch.from_numpy(vals.astype(np.float32))


@pytest.mark.parametrize("tile", [1, 2, 8])
@pytest.mark.parametrize("out_u8", [True, False])
def test_frame_kernel_source_from_a_start_map(host_lib, tile, out_u8):
    """frame.cu's frame_start_kernel against the plain frame from the same
    start map, bit for bit, at a ragged 67 x 41 (the map's last tile cut);
    the map changes the frame."""
    from voxelhex_tpu_torch.ops.frame import frame_params, render_frame_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _tree(64, 0.02)
    cam = orbit_camera(64.0, yaw_deg=35.0, resolution=(67, 41))
    start = _start_map(67, 41, tile, seed=tile)
    out = torch.full((41, 67, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
    host_lib.host_frame_start(tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(),
                              tree["palette"].data_ptr(), tree["palette"].shape[0],
                              frame_params(tree, cam), start.data_ptr(), tile,
                              None if out_u8 else out.data_ptr(), out.data_ptr() if out_u8 else None)
    want = render_frame_plain(tree, cam, out_u8=out_u8, start=start, start_tile=tile)
    assert _equal(out, want)
    assert not _equal(want, render_frame_plain(tree, cam, out_u8=out_u8))


def test_frames_kernel_source_from_start_maps(host_lib):
    """frames.cu's frames_start_kernel through its C entry, as the wrapper
    calls it, against the plain frames and digests: 35 cameras (two
    launches), each frame from its start map where its flag is set and
    from its entry where not."""
    from voxelhex_tpu_torch.ops.frames import launch_frames, render_frames_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _tree(16, 0.05)
    res = (24, 16)
    cams = [orbit_camera(16.0, yaw_deg=10.0 * k, resolution=res) for k in range(35)]
    maps = torch.stack([_start_map(*res, 8, seed=k) for k in range(35)])
    use = [k % 3 != 1 for k in range(35)]
    prev = torch.zeros((16, 24, 3), dtype=torch.uint8)
    frames, digest, launches = launch_frames(host_lib.vhx_render_frames_start, tree, cams,
                                             (0.1, 0.2, 0.3), True, 2048, prev,
                                             starts=(maps, 8, use))
    want, nrows, flags = render_frames_plain(tree, cams, (0.1, 0.2, 0.3), True, 2048, prev,
                                             starts=(maps, 8, use))
    assert launches == 2 and _equal(frames, want)
    assert _equal(digest[:, 0], nrows) and _equal(digest[:, 1:], flags)
    plain = render_frames_plain(tree, cams, (0.1, 0.2, 0.3), True)[0]
    differs = [not _equal(want[k], plain[k]) for k in range(35)]
    assert any(differs) and not any(d for d, u in zip(differs, use) if not u)


@pytest.mark.parametrize("inside", [True, False])
def test_far_kernel_source_from_a_window_start_map(host_lib, inside):
    """far.cu with the window's start map against the plain far frame from
    it, bit for bit: the window's rays start from the map, the rings keep
    their own starts."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, far_params

    layers = _far_case(2, inside)
    start = _start_map(37, 21, 8, seed=3)
    out = torch.full((21, 37, 3), 7, dtype=torch.uint8)
    assert host_lib.vhx_render_far_start(far_params(layers, inside), start.data_ptr(), 8, None,
                                         out.data_ptr(), 0, None) == 0
    want = far_frame_plain(layers, inside, start=start, start_tile=8)
    assert _equal(out, want)
    assert not _equal(want, far_frame_plain(layers, inside))


# ---------------------------------------------------------------------------
# the skip tracer's instances (skip.cuh) and the multi-hit march's start form
# ---------------------------------------------------------------------------


def _outs(n, K=None):
    """Outputs that start as garbage, so that a slot a kernel does not
    write shows."""
    if K is None:
        return [torch.full((n,), 7, dtype=torch.bool), torch.full((n,), 7, dtype=torch.int32),
                torch.full((n, 3), 7, dtype=torch.int32), torch.full((n, 3), 7.0),
                torch.full((n, 3), 7.0)]
    return [torch.full((n,), 7, dtype=torch.int32), torch.full((n, K, 3), 7, dtype=torch.int32),
            torch.full((n, K), 7.0)]


# grids of every depth the skip instances are tested at: 2, 3, 4 levels,
# then 1 (size 4) and 5 (size 260: 65^3 rows of 40 B)
SKIP_GRIDS = GRIDS + [(4, 0.3), (260, 0.002)]


@functools.lru_cache(maxsize=None)
def _skip_tree(size, density=None):
    """``_tree(size, density, skip=True)``, built once a module (the skip
    tests do not change it); ``density`` defaults to SKIP_GRIDS's."""
    if density is None:
        density = dict(SKIP_GRIDS)[size]
    return _tree(size, density, skip=True)


@pytest.mark.parametrize("size,density", SKIP_GRIDS)
@pytest.mark.parametrize("substeps", [1, 3])
def test_skip_traverse_kernel_source_equals_plain(host_lib, size, density, substeps):
    """traverse.cu's skip instance of the grid's depth through its C entry
    against the plain skip tracer, every output bit for bit, on random and
    grazing rays and on rays cut at 1, 2 and 7 body iterations; at an odd
    depth the rays fetch rows of both alignments (16 B and 8 B)."""
    from voxelhex_tpu_torch.ops.skip import plain_tracer, trace_skip_plain
    from voxelhex_tpu_torch.ops.traverse import trace_params

    tree = _skip_tree(size, density)
    o1, d1 = _rays_into(size, 1500, seed=size)
    o2, d2, _s = _grazing_rays(size, 500, seed=size + 1)
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    for max_iters in (1, 2, 7, 2048):
        out = _outs(o.shape[0])
        assert host_lib.host_traverse_skip(
            o.data_ptr(), d.data_ptr(), tree["skip_rows"].data_ptr(), tree["colors"].data_ptr(),
            trace_params(tree, max_iters), o.shape[0], substeps,
            *[t.data_ptr() for t in out]) == 0
        want = trace_skip_plain(tree, o, d, max_iters, substeps)
        for g, w in zip(out, want):
            assert _equal(g, w)
    assert want[0].sum() > 100
    L = len(tree["bases"])
    if L % 2 and L > 1:
        tracer = plain_tracer(tree, 2048, substeps)
        reads = torch.zeros(tree["skip_rows"].shape[0], dtype=torch.bool)
        tracer.run(tree, tracer.init(tree, o, d), 2048, reads=reads)
        rows = torch.nonzero(reads).ravel()
        assert (rows % 2 == 0).any() and (rows % 2 == 1).any()


def test_skip_kernel_entries_reject_misaligned_rows(host_lib):
    """The skip instances load a row as 16 B vectors: each C entry refuses
    rows that do not start on 16 B."""
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.traverse import trace_params
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _skip_tree(16)
    rows = tree["skip_rows"]
    shifted = torch.zeros(rows.numel() + 2, dtype=torch.int32)
    shifted[2:] = rows.ravel()
    o, d = _rays_into(16, 8, seed=3)
    out = _outs(8)
    for r, want in ((rows.data_ptr(), 0), (shifted.data_ptr() + 8, 1)):
        err = host_lib.host_traverse_skip(o.data_ptr(), d.data_ptr(), r,
                                          tree["colors"].data_ptr(), trace_params(tree), 8, 3,
                                          *[t.data_ptr() for t in out])
        assert (err != 0) == want
    frame = torch.zeros((4, 8, 3), dtype=torch.uint8)
    assert host_lib.vhx_render_frame_skip(shifted.data_ptr() + 8, tree["colors"].data_ptr(),
                                          tree["palette"].data_ptr(), tree["palette"].shape[0],
                                          frame_params(tree, orbit_camera(16.0, resolution=(8, 4))),
                                          3, None, 1, None, frame.data_ptr(), 0, None) != 0


@pytest.mark.parametrize("n_levels", [7, 8])
def test_skip_kernel_entries_reject_deep_pyramids(host_lib, n_levels):
    """The skip kernels have an instance for each depth from 1 to
    ``SKIP_KERNEL_MAX_LEVELS`` (6, worlds of up to 4096 a side, as
    ``skip.cuh`` defines): the C entries refuse deeper pyramids, which the
    plain skip tracer takes, and write nothing."""
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.skip import SKIP_KERNEL_MAX_LEVELS, SKIP_MAX_LEVELS
    from voxelhex_tpu_torch.ops.traverse import trace_params
    from voxelhex_tpu_torch.render.camera import orbit_camera

    with open(os.path.join(CSRC, "skip.cuh")) as f:
        header = re.search(r"#define VHX_SKIP_MAX_LEVELS (\d+)", f.read())
    assert int(header.group(1)) == SKIP_KERNEL_MAX_LEVELS == 6 < n_levels <= SKIP_MAX_LEVELS
    tree = _skip_tree(16)
    o, d = _rays_into(16, 8, seed=3)
    for depth, want in ((len(tree["bases"]), 0), (n_levels, 1)):
        out = _outs(8)
        p = trace_params(tree)
        p.n_levels = depth
        err = host_lib.host_traverse_skip(o.data_ptr(), d.data_ptr(),
                                          tree["skip_rows"].data_ptr(), tree["colors"].data_ptr(),
                                          p, 8, 3, *[t.data_ptr() for t in out])
        assert (err != 0) == want
        assert bool((out[1] == 7).all()) == want
        fp = frame_params(tree, orbit_camera(16.0, resolution=(8, 4)))
        fp.trace.n_levels = depth
        frame = torch.full((4, 8, 3), 7, dtype=torch.uint8)
        err = host_lib.vhx_render_frame_skip(tree["skip_rows"].data_ptr(),
                                             tree["colors"].data_ptr(),
                                             tree["palette"].data_ptr(),
                                             tree["palette"].shape[0], fp, 3, None, 1, None,
                                             frame.data_ptr(), 0, None)
        assert (err != 0) == want
        assert bool((frame == 7).all()) == want


@pytest.mark.parametrize("size,start_tile,out_u8", [
    pytest.param(64, start_tile, out_u8, id=f"{out_u8}-{start_tile}")
    for out_u8 in (True, False) for start_tile in (None, 2)] + [
    (size, start_tile, out_u8) for size, _d in SKIP_GRIDS if size != 64
    for start_tile, out_u8 in ((None, True), (2, False))])
def test_skip_frame_kernel_source_equals_plain(host_lib, size, start_tile, out_u8):
    """frame.cu's skip instances, with and without a start map, through its
    C entry against the plain skip frame at a ragged 67 x 41, bit for bit:
    every form at 3 levels (size 64), two at each other tested depth."""
    from voxelhex_tpu_torch.ops.frame import frame_params, render_frame_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _skip_tree(size)
    cam = orbit_camera(float(size), yaw_deg=35.0, resolution=(67, 41))
    start = None if start_tile is None else _start_map(67, 41, start_tile, seed=4) * (size / 64)
    out = torch.full((41, 67, 3), 7, dtype=torch.uint8 if out_u8 else torch.float32)
    assert host_lib.vhx_render_frame_skip(
        tree["skip_rows"].data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
        tree["palette"].shape[0], frame_params(tree, cam), 2,
        None if start is None else start.data_ptr(), start_tile or 1,
        None if out_u8 else out.data_ptr(), out.data_ptr() if out_u8 else None, 0, None) == 0
    want = render_frame_plain(tree, cam, out_u8=out_u8, start=start, start_tile=start_tile or 1,
                              skip_substeps=2)
    assert _equal(out, want)
    if out_u8 and start is None and size == 64:  # the skip frame is the stack frame here
        assert _equal(out, render_frame_plain(tree, cam))


@pytest.mark.parametrize("size", [s for s, _d in SKIP_GRIDS])
def test_skip_frames_kernel_source_equals_plain(host_lib, size):
    """frames.cu's skip instance of the grid's depth through its C entry,
    as the wrapper calls it: 35 cameras (two launches; 3 and one launch at
    the other depths) with start maps where their flag is set, frames and
    digests against the plain versions; and without maps."""
    from voxelhex_tpu_torch.ops.frames import launch_frames, render_frames_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _skip_tree(size)
    res = (24, 16)
    K = 35 if size == 16 else 3
    cams = [orbit_camera(float(size), yaw_deg=10.0 * k, resolution=res) for k in range(K)]
    maps = torch.stack([_start_map(*res, 8, seed=k) for k in range(K)]) * (size / 16)
    use = [k % 3 != 1 for k in range(K)]
    prev = torch.zeros((16, 24, 3), dtype=torch.uint8)

    def entry(rows, colors, palette, n_colors, p, *rest):
        return host_lib.vhx_render_frames_skip(rows, colors, palette, n_colors, p, 3, *rest)

    for starts in ((maps, 8, use), None):
        frames, digest, launches = launch_frames(entry, tree, cams, (0.1, 0.2, 0.3), True, 2048,
                                                 prev, starts=starts, words=tree["skip_rows"])
        want, nrows, flags = render_frames_plain(tree, cams, (0.1, 0.2, 0.3), True, 2048, prev,
                                                 starts=starts, skip_substeps=3)
        assert launches == (2 if K > 32 else 1) and _equal(frames, want)
        assert _equal(digest[:, 0], nrows) and _equal(digest[:, 1:], flags)
    p = launch_frames.__globals__["frames_params"](tree, cams[:1])[0]
    assert host_lib.vhx_render_frames_skip(tree["skip_rows"].data_ptr(),
                                           tree["colors"].data_ptr(),
                                           tree["palette"].data_ptr(), 5, p, 0, None, 1, 0,
                                           None, frames.data_ptr(), None, None, 0, None) != 0


@pytest.mark.parametrize("levels,size", [
    pytest.param(levels, size, id=str(levels) if size == 64 else f"{levels}-{size}")
    for size, _d in SKIP_GRIDS for levels in (1, 2)])
def test_skip_prepass_kernel_source_equals_plain(host_lib, levels, size):
    """prepass.cu's skip instance of the grid's depth, its one launch
    through its C entry, against the plain depth prepass of the skip
    tracer, level by level (each from the plain level before) and the
    start map, bit for bit."""
    from voxelhex_tpu_torch.ops.prepass import (depth_start_plain, level_camera,
                                                level_depth_plain)
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = _skip_tree(size)
    cam = orbit_camera(float(size), yaw_deg=25.0, resolution=(100, 44))
    sync = torch.zeros(host_lib.vhx_prepass_sync_words(50, 22, levels), dtype=torch.int32)
    got, start = _host_prepass(host_lib, tree, cam, levels, 3, sync, 1)
    want = None
    for i, depth in zip(range(levels, 0, -1), got):
        want = level_depth_plain(tree, level_camera(cam, i), want, skip_substeps=3)
        assert _equal(depth, want)
        assert (want == 1e8).any() and (want < 1e8).any()
    assert _equal(start, depth_start_plain(want))


def _host_multihit_form(host_lib, tree, o, d, K, start, substeps, max_iters=2048):
    from voxelhex_tpu_torch.ops.multihit import _start_parts
    from voxelhex_tpu_torch.ops.traverse import trace_params

    n = o.shape[0]
    out = _outs(n, K)
    smap, tile, w = (None, 1, 1) if start is None else _start_parts(start, n)
    words = tree["skip_rows"] if substeps else tree["occ_pairs"]
    assert host_lib.host_multihit_start(
        o.data_ptr(), d.data_ptr(), words.data_ptr(), trace_params(tree, max_iters), n, K,
        None if smap is None else smap.data_ptr(), tile, w, substeps,
        *[t.data_ptr() for t in out]) == 0
    return out


@pytest.mark.parametrize("size,density", SKIP_GRIDS)
@pytest.mark.parametrize("form", ["start", "skip", "skip+start"])
def test_multihit_forms_kernel_source_equal_plain(host_lib, size, density, form):
    """multihit.cu's start and skip forms through its C entry against the
    plain multi-hit march, K = 3, every slot bit for bit; the start a
    per-ray start at each ray's exit (``_grazing_rays``: some kill their
    ray), and on the smallest grid also a start map over the rays as a
    40-wide frame (its tiles index the same way on every grid)."""
    from voxelhex_tpu_torch.ops.multihit import multihit_plain

    tree = _skip_tree(size, density)
    o1, d1 = _rays_into(size, 1200, seed=size)
    o2, d2, s2 = _grazing_rays(size, 400, seed=size + 2)
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    substeps = 3 if "skip" in form else 0
    starts = [None] if form == "skip" else [torch.cat([torch.zeros(1200), s2])]
    if form != "skip" and (size, density) == GRIDS[0]:
        starts.append((_start_map(40, 40, 8, seed=size), 8, 40))
    for start in starts:
        got = _host_multihit_form(host_lib, tree, o, d, 3, start, substeps)
        want = multihit_plain(tree, o, d, 3, start=start, skip_substeps=substeps or None)
        for g, w in zip(got, want):
            assert _equal(g, w)
        assert int((want[0] >= 2).sum()) > 10
    if form != "skip":
        dead = (s2 >= 1e8) | (want[0][1200:] == 0)
        assert dead.any()


def test_multihit_skip_hits_after_a_row_refetch(host_lib):
    """Rays along x through a row of voxels: three hits in one level-0
    block (each found after the row fetch that ends the body of the hit
    before, and its clear), and a hit in the next block; a start past the
    row's exit kills a ray, one inside the row starts it mid-row."""
    from voxelhex_tpu_torch.ops.multihit import multihit_plain
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    occ = np.zeros((16, 16, 16), dtype=bool)
    occ[4:9, 5, 5] = True  # x = 4..7 in one block, 8 in the next
    tree = device_bitgrid(bitgrid_from_occupancy(occ), "cpu", skip_rows=True)
    o = torch.tensor([[-3.0, 5.5, 5.5], [-3.0, 5.5, 5.5], [-3.0, 5.5, 5.5], [-3.0, 5.3, 5.6]])
    d = torch.tensor([[1.0, 0.0, 0.0]] * 3 + [[1.0, 1e-3, 0.0]])
    start = torch.tensor([0.0, 100.0, 9.5, 0.0])
    for substeps in (1, 3):
        for st in (None, start):
            got = _host_multihit_form(host_lib, tree, o, d, 4, st, substeps)
            want = multihit_plain(tree, o, d, 4, start=st, skip_substeps=substeps)
            for g, w in zip(got, want):
                assert _equal(g, w)
    assert want[0].tolist() == [4, 0, 3, 4]
    assert want[1][0, :, 0].tolist() == [4, 5, 6, 7]
    assert want[1][2, :3, 0].tolist() == [6, 7, 8]
    got = _host_multihit_form(host_lib, tree, o, d, 5, None, 3)
    assert got[1][0, :, 0].tolist() == [4, 5, 6, 7, 8]
