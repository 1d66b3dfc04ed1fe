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
// rgb a ray, the backward three atomic adds a hit.  A few f32 operations a
// ray.  At the bench's d = 4 the params are 3,905 bricks x 64 cells x 3 =
// 749,760 floats (3 MB), resident in the 50 MB L2, so the gathers and the
// atomics hit the L2; the backward's atomics contend where many rays hit
// one voxel.  One thread per ray, consecutive rays on consecutive threads:
// the per-ray arrays are read coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS)
albedo_bwd_kernel(const float* __restrict__ grad_rgb, const unsigned char* __restrict__ hit,
                  const int* __restrict__ brick, const int* __restrict__ cell,
                  const float* __restrict__ normal, int R, int n_bricks, int d3,
                  float* __restrict__ g_params) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R || !hit[r]) return;
    const int b = brick[r];
    if (b < 0) return;
    const float lam = lambert(normal + 3 * r);
    const long long row = row_of(b, cell[r], n_bricks, d3);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
        atomicAdd(&g_params[row + ch], __fmul_rn(grad_rgb[3 * r + ch], lam));
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

// g_params: the zeroed flat gradient [n_bricks * d3 * 3] to add into
extern "C" cudaError_t vhx_albedo_backward(const float* grad_rgb, const void* hit,
                                           const int* brick, const int* cell,
                                           const float* normal, int n_rays, int n_bricks, int d3,
                                           float* g_params, int device, cudaStream_t stream) {
    if (n_bricks < 1 || d3 < 1 || n_rays < 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays == 0) return cudaSuccess;
    albedo_bwd_kernel<<<(n_rays + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        grad_rgb, static_cast<const unsigned char*>(hit), brick, cell, normal, n_rays, n_bricks,
        d3, g_params);
    return cudaGetLastError();
}
