// The differentiable renderer's shading of learned albedo, forward and
// backward: per ray, the albedo row at the ray's (brick, cell) from the flat
// params [B * d^3 * 3] (row (b, c) at 3 (b d^3 + c)), lit by Lambert.
//
// Replaces the XLA programs of `_gather_bc_flatbwd` (voxelhex_tpu/diff/
// render.py:142, forward :154, backward :158) with `shade_diff` (:176), as
// `DiffRenderer.render` and `fit_albedo`'s precomputed-hit loss compose
// them (render.py:236, fit.py:72); none has a Pallas source.  Per ray r:
//   lambert = ((n_x L_x + n_y L_y) + n_z L_z) / 2 + 0.5,  L = (-0.5, 0.5, -0.5),
//   rgb = bg                                       if the ray missed,
//         0 * lambert                              if it hit with brick < 0,
//         params[clip(brick), clip(cell)] * lambert otherwise,
// the reference's `where` order (clip to [0, B - 1] and [0, d^3 - 1]).  The
// backward adds dL/drgb * lambert into the zeroed flat gradient at the
// ray's row, with f32 atomics, for the rays that hit with brick >= 0; the
// others pass zeros in the reference and add nothing.  The products by
// +-0.5 are exact, so no multiply-add placement can change lambert, and
// each output is one rounding away from the reference's; the atomics add
// in no fixed order, so the gradient holds the reference's within a
// tolerance, not bit for bit.
//
// What bounds it on the H100: bytes.  Every ray reads its 1 B hit flag; a
// ray that hit also reads 8 B of brick and cell, 12 B of normal and a 12 B
// row (forward) or 12 B of dL/drgb (backward); the forward writes 12 B of
// rgb a ray, the backward the 3 MB gradient.  A few f32 operations a ray.
// At the bench's d = 4 the params are 3,905 bricks x 64 cells x 3 = 749,760
// floats (3 MB), resident in the 50 MB L2, so the gathers and the atomics
// hit the L2.  The forward runs one thread a ray, consecutive rays on
// consecutive threads: the per-ray arrays are read coalesced.  The
// backward is shaped otherwise: with one thread a ray, 88% of the threads
// would read one flag and leave (12% of the bench's rays hit), and since
// neighbouring pixels hit one voxel, a warp's atomic would often have many
// lanes on one address, which the L2 adds one after another.  So a thread
// takes a chunk of rays, and a run of rays on one voxel adds once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4;  // the backward's rays a thread

__device__ __forceinline__ float lambert(const float* __restrict__ n) {
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(n[0], -0.5f), __fmul_rn(n[1], 0.5f)),
                                __fmul_rn(n[2], -0.5f));
    return __fadd_rn(__fdiv_rn(dot, 2.f), 0.5f);
}

// the first of the 3 floats of row (brick, cell), both clipped as the
// reference clips them
__device__ __forceinline__ long long row_of(int b, int c, int n_bricks, int d3) {
    b = b < n_bricks - 1 ? b : n_bricks - 1;
    c = c < 0 ? 0 : (c < d3 - 1 ? c : d3 - 1);
    return ((long long)b * d3 + c) * 3;
}

__global__ void __launch_bounds__(THREADS)
albedo_fwd_kernel(const float* __restrict__ params, const unsigned char* __restrict__ hit,
                  const int* __restrict__ brick, const int* __restrict__ cell,
                  const float* __restrict__ normal, int R, int n_bricks, int d3, float bg0,
                  float bg1, float bg2, float* __restrict__ rgb) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float out[3] = {bg0, bg1, bg2};
    if (hit[r]) {
        const float lam = lambert(normal + 3 * r);
        const int b = brick[r];
        if (b < 0) {
            out[0] = out[1] = out[2] = __fmul_rn(0.f, lam);
        } else {
            const long long row = row_of(b, cell[r], n_bricks, d3);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) out[ch] = __fmul_rn(__ldg(&params[row + ch]), lam);
        }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[3 * r + ch] = out[ch];
}

// ---- the backward: a thread takes CHUNK = 4 consecutive rays [r0, r0 + 4)
// (a chunk), with r0 = 4 k - off for thread k: `off` (the flags' address
// modulo 4) puts every whole chunk's flags on a 4 B boundary, so one 4 B
// load reads them, and a warp whose chunks all missed leaves after that
// load and one vote.  Only the first and the last chunk may be cut by [0,
// R); they read their flags one by one.  The chunk's other arrays are read
// as 16 B vectors (brick, cell, and three each of normal and dL/drgb) where
// all four addresses are 16 B aligned, else one element at a time: an input
// at any 4 B offset takes the scalar edge, in this kernel.  A run of
// contributing rays on one row (rays that add nothing do not break it) is
// summed in registers; the lanes of a warp then merge the runs that cross
// their chunks' edges and the runs that end on one row (__match_any_sync),
// the lowest lane of each group adding the group's sum.  A run's three
// channels go out as one 8 B vector add (sm_90) and one scalar add.  Chunks
// of 8 and 16 rays, no warp merging and three scalar adds each measured
// slower (PERF.md, Findings): on the bench's two 1080p poses, 509,830 hit
// rays add 162,755 times, twice each.

// the flags of [r0, r0 + CHUNK): byte t is ray r0 + t's (zero outside [0,
// R)); `whole`: the chunk lies in [0, R) and starts on a 4 B boundary
__device__ __forceinline__ uint32_t load_flags(const unsigned char* __restrict__ hit, long long r0,
                                               int R, bool whole) {
    if (whole) return *reinterpret_cast<const uint32_t*>(hit + r0);
    uint32_t w = 0;
    for (int t = 0; t < CHUNK; ++t) {
        const long long r = r0 + t;
        if (r >= 0 && r < R && hit[r]) w |= 1u << (8 * t);
    }
    return w;
}

__device__ __forceinline__ bool on16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rays q .. q + 3 with flag word w: brick, cell, normal and dL/drgb of each
// ray whose flag is set (all four on the vector path)
struct Quad {
    int b[CHUNK], c[CHUNK];
    float n[3 * CHUNK], g[3 * CHUNK];
};

__device__ __forceinline__ void load_quad(const float* __restrict__ grad_rgb,
                                          const int* __restrict__ brick,
                                          const int* __restrict__ cell,
                                          const float* __restrict__ normal, long long q,
                                          uint32_t w, bool whole, Quad& x) {
    if (whole && on16(brick + q) && on16(cell + q) && on16(normal + 3 * q) &&
        on16(grad_rgb + 3 * q)) {
        const int4 b = *reinterpret_cast<const int4*>(brick + q);
        const int4 c = *reinterpret_cast<const int4*>(cell + q);
        x.b[0] = b.x, x.b[1] = b.y, x.b[2] = b.z, x.b[3] = b.w;
        x.c[0] = c.x, x.c[1] = c.y, x.c[2] = c.z, x.c[3] = c.w;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float4 n = reinterpret_cast<const float4*>(normal + 3 * q)[i];
            const float4 g = reinterpret_cast<const float4*>(grad_rgb + 3 * q)[i];
            x.n[4 * i] = n.x, x.n[4 * i + 1] = n.y, x.n[4 * i + 2] = n.z, x.n[4 * i + 3] = n.w;
            x.g[4 * i] = g.x, x.g[4 * i + 1] = g.y, x.g[4 * i + 2] = g.z, x.g[4 * i + 3] = g.w;
        }
        return;
    }
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
        if (!((w >> (8 * t)) & 0xff)) continue;
        x.b[t] = brick[q + t];
        x.c[t] = cell[q + t];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            x.n[3 * t + ch] = normal[3 * (q + t) + ch];
            x.g[3 * t + ch] = grad_rgb[3 * (q + t) + ch];
        }
    }
}

// add a run's sum into the row whose first float is g + row: the two
// channels on an 8 B boundary as one vector add, the third alone
__device__ __forceinline__ void add_run(float* __restrict__ g, long long row, const float (&s)[3]) {
    float* a = g + row;
    if ((reinterpret_cast<uintptr_t>(a) & 7) == 0) {
        atomicAdd(reinterpret_cast<float2*>(a), make_float2(s[0], s[1]));
        atomicAdd(a + 2, s[2]);
    } else {
        atomicAdd(a, s[0]);
        atomicAdd(reinterpret_cast<float2*>(a + 1), make_float2(s[1], s[2]));
    }
}

__global__ void __launch_bounds__(THREADS)
albedo_bwd_kernel(const float* __restrict__ grad_rgb, const unsigned char* __restrict__ hit,
                  const int* __restrict__ brick, const int* __restrict__ cell,
                  const float* __restrict__ normal, int R, int off, int n_bricks, int d3,
                  float* __restrict__ g_params) {
    static_assert(CHUNK == 4, "a chunk's flags are one 4 B word");
    constexpr unsigned FULL = 0xffffffffu;
    const long long r0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * CHUNK - off;
    const bool whole = r0 >= 0 && r0 + CHUNK <= R;
    const uint32_t w = load_flags(hit, r0, R, whole);
    // a warp whose rays all missed has nothing to add
    if (!__any_sync(FULL, w != 0)) return;
    Quad x;
    if (w) load_quad(grad_rgb, brick, cell, normal, r0, w, whole, x);
    // the open run (row -1: none) and the chunk's first run, kept back for
    // the warp (row -2: none, or it is the open run)
    long long row = -1, first = -2;
    float sum[3] = {0.f, 0.f, 0.f}, first_sum[3] = {0.f, 0.f, 0.f};
    int runs = 0;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
        if (!((w >> (8 * t)) & 0xff) || x.b[t] < 0) continue;
        const long long rr = row_of(x.b[t], x.c[t], n_bricks, d3);
        const float lam = lambert(x.n + 3 * t);
        if (rr == row) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
                sum[ch] = __fadd_rn(sum[ch], __fmul_rn(x.g[3 * t + ch], lam));
            continue;
        }
        if (runs == 1) {
            first = row;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) first_sum[ch] = sum[ch];
        } else if (runs > 0) {
            add_run(g_params, row, sum);
        }
        ++runs;
        row = rr;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) sum[ch] = __fmul_rn(x.g[3 * t + ch], lam);
    }
    const int lane = threadIdx.x & 31;
    // the next lane's first run joins this lane's open run on the same row
    const long long next_first = __shfl_down_sync(FULL, first, 1);
    const long long prev_row = __shfl_up_sync(FULL, row, 1);
    float next_sum[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) next_sum[ch] = __shfl_down_sync(FULL, first_sum[ch], 1);
    if (lane < 31 && next_first == row) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) sum[ch] = __fadd_rn(sum[ch], next_sum[ch]);
    }
    if (first >= 0 && !(lane > 0 && prev_row == first)) add_run(g_params, first, first_sum);
    // the open runs of one row: the group's lowest lane adds their sum
    const unsigned group = __match_any_sync(FULL, row);
    const bool leader = row >= 0 && lane == __ffs(group) - 1;
    unsigned todo = leader ? group & (group - 1) : 0u;
    while (__any_sync(FULL, todo != 0)) {
        const int src = todo ? __ffs(todo) - 1 : lane;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float v = __shfl_sync(FULL, sum[ch], src);
            if (todo) sum[ch] = __fadd_rn(sum[ch], v);
        }
        todo &= todo - 1;
    }
    if (leader) add_run(g_params, row, sum);
}

}  // namespace

// bg: three floats on the host
extern "C" cudaError_t vhx_albedo_forward(const float* params, const void* hit, const int* brick,
                                          const int* cell, const float* normal, int n_rays,
                                          int n_bricks, int d3, const float* bg, float* rgb,
                                          int device, cudaStream_t stream) {
    if (n_bricks < 1 || d3 < 1 || n_rays < 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays == 0) return cudaSuccess;
    albedo_fwd_kernel<<<(n_rays + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        params, static_cast<const unsigned char*>(hit), brick, cell, normal, n_rays, n_bricks, d3,
        bg[0], bg[1], bg[2], rgb);
    return cudaGetLastError();
}

// g_params: the flat gradient [n_bricks * d3 * 3], zeroed here on the stream,
// then added into
extern "C" cudaError_t vhx_albedo_backward(const float* grad_rgb, const void* hit,
                                           const int* brick, const int* cell,
                                           const float* normal, int n_rays, int n_bricks, int d3,
                                           float* g_params, int device, cudaStream_t stream) {
    if (n_bricks < 1 || d3 < 1 || n_rays < 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(g_params, 0, sizeof(float) * 3 * (size_t)n_bricks * d3, stream);
    if (err != cudaSuccess || n_rays == 0) return err;
    const int off = (int)(reinterpret_cast<uintptr_t>(hit) % CHUNK);
    const long long chunks = ((long long)n_rays + off + CHUNK - 1) / CHUNK;
    albedo_bwd_kernel<<<(unsigned)((chunks + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        grad_rgb, static_cast<const unsigned char*>(hit), brick, cell, normal, n_rays, off,
        n_bricks, d3, g_params);
    return cudaGetLastError();
}
