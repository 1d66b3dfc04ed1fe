// The whole frame in one launch: camera params in, shaded pixels out.
//
// Replaces, on the frame's path, the two ported TPU kernels
// (`make_kernel` / `traverse_tiles`, voxelhex_tpu/ops/traverse_pallas.py:79,
// :208, and `_shade_kernel` / `pallas_shade`,
// voxelhex_tpu/ops/shade_pallas.py:40, :67) and the ray generation before
// them, as the reference's one-dispatch frame does (`_fused_plan_fn(cam=...,
// u8=True)`, voxelhex_tpu/render/bitgrid.py:1738).  Each thread:
//   prologue  its pixel's ray, with the plain `raygen`'s operation sequence
//             (render/camera.py): __fmaf_rn where it fuses, the row term of
//             the norm's copy added unfused, a correctly rounded sqrt;
//   body      the automaton `vhx::march` (traverse.cuh), shared with the
//             standalone traversal kernel (traverse.cu);
//   epilogue  the color lookup, then shade.cu's shading and u8 step (the
//             same gate, the same sum order, rintf).
//
// What bounds it on the H100: operations, and the latency of the
// automaton's dependent steps.  The camera params travel by value in the
// launch parameters, so a frame makes no host-to-device copy; the frame
// reads only the pyramid (2.1 MB on the benchmark scene, L2-resident), 2 B
// of color per hit and a palette row per colored hit, and writes 3 B per
// pixel (12 B for f32).  Each warp covers a 4-column x 8-row pixel tile
// (frame.cuh).  The ragged right and bottom edges are masked; the output
// stays row-major [h, w, 3].  The prologue, the tile and the epilogue are
// frame.cuh's, shared with the batched kernel (frames.cu).

#include "frame.cuh"

struct FrameParams {
    TraceParams trace;
    float origin[3];
    float right[3];
    float up[3];
    float forward[3];
    float scale[2];  // (tan(fov_y / 2) * w / h, tan(fov_y / 2))
    float cw, ch;    // 1 / w * 2 and 1 / h * 2, folded as the plain raygen folds them
    float bg[3];     // background color of a miss
    int w, h;
};

namespace {

constexpr int WARP_H = vhx::WARP_H;
constexpr int THREADS = vhx::FRAME_THREADS;
constexpr int BLOCK_W = vhx::BLOCK_W;

__global__ void __launch_bounds__(THREADS)
frame_kernel(const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
             const float4* __restrict__ palette, int n_colors, const FrameParams P,
             float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    int x, y;
    vhx::tile_pixel(x, y);
    if (x >= P.w || y >= P.h) return;

    // ---- prologue: the pixel's ray
    float o[3], d[3];
    vhx::pixel_ray(P.origin, P.right, P.up, P.forward, P.scale, P.cw, P.ch, x, y, o, d);

    // ---- the ray
    const vhx::Hit h = vhx::march(o, d, occ, colors, levels, P.trace.n_levels, P.trace.size,
                                  P.trace.n_blocks, P.trace.max_iters);

    // ---- epilogue: albedo x Lambert, the background on a miss, u8
    float rgb[3];
    vhx::shade_hit(h, palette, n_colors, P.bg, rgb);
    const int r = y * P.w + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (rgb_out) rgb_out[3 * r + k] = rgb[k];
        if (u8_out) u8_out[3 * r + k] = vhx::to_u8(rgb[k]);
    }
}

}  // namespace

extern "C" int vhx_frame_params_size() { return (int)sizeof(FrameParams); }

extern "C" cudaError_t vhx_render_frame(const void* occ_pairs, const void* colors,
                                        const float* palette, int n_colors,
                                        const FrameParams* params, float* rgb, void* u8,
                                        int device, cudaStream_t stream) {
    const FrameParams& P = *params;
    if (P.trace.n_levels < 1 || P.trace.n_levels > VHX_MAX_LEVELS || n_colors < 1 || P.w < 1 ||
        P.h < 1)
        return cudaErrorInvalidValue;
    const dim3 grid((P.w + BLOCK_W - 1) / BLOCK_W, (P.h + WARP_H - 1) / WARP_H);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    frame_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const uint2*>(occ_pairs), static_cast<const unsigned short*>(colors),
        reinterpret_cast<const float4*>(palette), n_colors, P, rgb,
        static_cast<unsigned char*>(u8));
    return cudaGetLastError();
}
