// Shading: palette lookup x Lambert, background on a miss, quantized to u8.
//
// Replaces the TPU kernel `_shade_kernel` / `pallas_shade`
// (voxelhex_tpu/ops/shade_pallas.py:40, :67), and computes what the frame
// uses: `_shade` (voxelhex_tpu/render/jax_renderer.py:448) followed by the
// u8 step `clip(round(rgb * 255), 0, 255)`.  The gate is the production
// one: a hit is colored unless its voxel is NO_COLOR_HIT or negative.
//
// What bounds it on the H100: bytes.  A pixel reads 1 B of hit, 4 B of
// voxel, 12 B of normal and a 16 B palette row and writes 3 B, with one
// multiply-add chain of arithmetic.  On the TPU the palette lookup was a
// one-hot matmul on the MXU because a per-lane gather was slow; a CUDA
// thread loads its row directly.  The 16,425-color palette of the
// benchmark scene (263 KB) exceeds a block's 227 KB of shared memory, so
// rows are read through the read-only cache from global memory (one 16 B
// load each) and neighboring pixels, which mostly share a voxel, share
// cache lines.
//
// Exactness: built with -fmad=false; the Lambert sum is added in the order
// `_shade` adds it, and rintf rounds half to even as jnp.round does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NO_COLOR_HIT = 0x3FFFFFFE;

__global__ void __launch_bounds__(256)
shade_kernel(const unsigned char* __restrict__ hit, const int* __restrict__ voxel,
             const float* __restrict__ normal, const float4* __restrict__ palette,
             int n_colors, float bg0, float bg1, float bg2, int R,
             float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float c[3] = {bg0, bg1, bg2};
    if (hit[r]) {
        const int v = voxel[r];
        float4 albedo = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v != NO_COLOR_HIT && v >= 0) albedo = __ldg(&palette[v < n_colors ? v : n_colors - 1]);
        const float n0 = normal[3 * r], n1 = normal[3 * r + 1], n2 = normal[3 * r + 2];
        // dot(n, (-0.5, 0.5, -0.5)) / 2 + 0.5
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(n0, -0.5f), __fmul_rn(n1, 0.5f)),
                                  __fmul_rn(n2, -0.5f));
        const float lambert = __fadd_rn(__fdiv_rn(s, 2.f), 0.5f);
        c[0] = __fmul_rn(albedo.x, lambert);
        c[1] = __fmul_rn(albedo.y, lambert);
        c[2] = __fmul_rn(albedo.z, lambert);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (rgb_out) rgb_out[3 * r + k] = c[k];
        if (u8_out) {
            // NaN -> 0 as the reference's float-to-int conversion does
            const float q = fminf(fmaxf(rintf(__fmul_rn(c[k], 255.f)), 0.f), 255.f);
            u8_out[3 * r + k] = (unsigned char)q;
        }
    }
}

}  // namespace

extern "C" cudaError_t vhx_shade(const void* hit, const int* voxel, const float* normal,
                                 const float* palette, int n_colors, float bg0, float bg1,
                                 float bg2, int n_rays, float* rgb, void* u8, int device,
                                 cudaStream_t stream) {
    if (n_colors < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int threads = 256;
    const int blocks = (n_rays + threads - 1) / threads;
    shade_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const unsigned char*>(hit), voxel, normal,
        reinterpret_cast<const float4*>(palette), n_colors, bg0, bg1, bg2, n_rays, rgb,
        static_cast<unsigned char*>(u8));
    return cudaGetLastError();
}
