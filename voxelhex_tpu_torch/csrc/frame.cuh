// The pieces of a frame that the single-frame kernel (frame.cu) and the
// batched kernel (frames.cu) share: the warp's pixel tile, the prologue
// that makes a pixel's ray from camera params, and the epilogue that
// shades the hit and takes the u8 step.  Each is inlined into its kernel,
// so the frame kernel compiles as it did with them written in its body.

#pragma once

#include "traverse.cuh"

// What ray generation reads of one camera (frames.cu, beam.cu)
struct FrameCam {
    float origin[3];
    float right[3];
    float up[3];
    float forward[3];
    float scale[2];  // (tan(fov_y / 2) * w / h, tan(fov_y / 2))
};

namespace vhx {

// Each warp covers a 4-column x 8-row pixel tile rather than 32 pixels of a
// row: neighbouring rays take similar numbers of steps, so fewer lanes wait
// on the warp's slowest ray.  A block's four warps sit side by side, so a
// block covers 16 x 8 pixels and row group blockIdx.y holds rows
// 8 * blockIdx.y .. 8 * blockIdx.y + 7.
constexpr int WARP_W = 4;
constexpr int WARP_H = 8;
constexpr int BLOCK_WARPS = 4;
constexpr int FRAME_THREADS = 32 * BLOCK_WARPS;
constexpr int BLOCK_W = WARP_W * BLOCK_WARPS;

// The pixel (x, y) of this thread.
__device__ __forceinline__ void tile_pixel(int& x, int& y) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    x = blockIdx.x * BLOCK_W + warp * WARP_W + lane % WARP_W;
    y = blockIdx.y * WARP_H + lane / WARP_W;
}

// The ray of pixel (x, y), with the plain `raygen`'s operation sequence
// (render/camera.py): __fmaf_rn where it fuses, the row term of the norm's
// copy added unfused, a correctly rounded sqrt.  `scale` is
// (tan(fov_y / 2) * w / h, tan(fov_y / 2)); cw and ch are 1 / w * 2 and
// 1 / h * 2, folded as the plain raygen folds them.
__device__ __forceinline__ void pixel_ray(const float origin[3], const float right[3],
                                          const float up[3], const float forward[3],
                                          const float scale[2], float cw, float ch, int x, int y,
                                          float o[3], float d[3]) {
    // (x + 0.5) / w * 2 - 1 and -(y + 0.5) / h * 2 + 1, each one multiply-add
    const float px = __fmaf_rn(__fadd_rn((float)x, 0.5f), cw, -1.f);
    const float py = __fmaf_rn(-__fadd_rn((float)y, 0.5f), ch, 1.f);
    const float pxs = __fmul_rn(px, scale[0]);
    const float pys = __fmul_rn(py, scale[1]);
    float head[3], dn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        head[c] = __fmaf_rn(pxs, right[c], forward[c]);
        dn[c] = __fadd_rn(head[c], __fmul_rn(pys, up[c]));  // the norm's copy: unfused
    }
    const float dlen = __fsqrt_rn(
        __fmaf_rn(dn[2], dn[2], __fmaf_rn(dn[1], dn[1], __fmul_rn(dn[0], dn[0]))));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        d[c] = __fdiv_rn(__fmaf_rn(pys, up[c], head[c]), dlen);  // the divided copy: fused
        o[c] = origin[c];
    }
}

// albedo x Lambert, the background on a miss: shade.cu's gate and sum order
__device__ __forceinline__ void shade_hit(const Hit& h, const float4* __restrict__ palette,
                                          int n_colors, const float bg[3], float rgb[3]) {
    rgb[0] = bg[0];
    rgb[1] = bg[1];
    rgb[2] = bg[2];
    if (h.hit) {
        const int v = h.voxel;
        float4 albedo = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v != NO_COLOR_HIT && v >= 0) albedo = __ldg(&palette[v < n_colors ? v : n_colors - 1]);
        // dot(n, (-0.5, 0.5, -0.5)) / 2 + 0.5
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(h.normal[0], -0.5f),
                                            __fmul_rn(h.normal[1], 0.5f)),
                                  __fmul_rn(h.normal[2], -0.5f));
        const float lambert = __fadd_rn(__fmul_rn(s, 0.5f), 0.5f);  // s / 2 + 0.5
        rgb[0] = __fmul_rn(albedo.x, lambert);
        rgb[1] = __fmul_rn(albedo.y, lambert);
        rgb[2] = __fmul_rn(albedo.z, lambert);
    }
}

// |p - o| as XLA:CPU computes the reference's jnp.linalg.norm of a 3-vector
// in the far frame and the depth prepass: the squares summed in order,
// unfused (far.cu, prepass.cu)
__device__ __forceinline__ float ray_length(const float p[3], const float o[3]) {
    const float x = __fsub_rn(p[0], o[0]), y = __fsub_rn(p[1], o[1]), z = __fsub_rn(p[2], o[2]);
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

// clip(round(v * 255), 0, 255), half to even; NaN -> 0 as the reference's
// float-to-int conversion does
__device__ __forceinline__ unsigned char to_u8(float v) {
    return (unsigned char)fminf(fmaxf(rintf(__fmul_rn(v, 255.f)), 0.f), 255.f);
}

}  // namespace vhx
