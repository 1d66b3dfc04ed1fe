// K frames in one launch, each u8 frame with its row digest against the
// frame before it.
//
// Replaces the reference's batched frame program (`_fused_batch_fn`,
// voxelhex_tpu/render/bitgrid.py:2013: a `lax.scan` of the one-dispatch
// frame over stacked camera params) and, on the u8 delta path, its row
// digest (`_digest` inside `_fused_delta_fn`, bitgrid.py:2184, :2215), an
// XLA program with no Pallas source.  Each frame is what the single-frame
// kernel (frame.cu) computes, through the same prologue, automaton and
// epilogue (frame.cuh, traverse.cuh), over the same 4 x 8 warp tiles.
//
// Shape.  The grid is one frame's grid, and each thread renders its pixel
// for k = 0 .. K-1 in turn.  Frame k's digest compares frame k with frame
// k - 1, and both are this thread's pixel: the thread keeps its previous
// 3 bytes in registers, so no thread reads a pixel that another block
// writes in the same launch.  Frame 0 is compared with the carried-in
// baseline `prev`, read once a launch.  Up to VHX_KMAX cameras (56 B each)
// travel by value in the launch parameters; a longer batch is launched in
// chunks, each chunk's baseline the last frame of the chunk before.  The
// parameters are a __grid_constant__, so that the loop can index the
// cameras by frame without copying them to each thread's local memory.
//
// The digest of frame k is `digest[k]` = (changed rows, then one int32 a
// row group): a row changed if any of its w * 3 bytes differ from the
// baseline's; group g's word holds bit r for changed row 8 g + r.  A warp's
// tile is one row group (group = blockIdx.y).  The words are zeroed by one
// memset a launch and set with per-thread atomics: a thread whose pixel
// changed reads its group's word first and sets its row's bit only if it
// is clear, and the thread whose atomicOr set the bit adds the row to the
// count.  A changed row costs a few atomics, not one a pixel.
//
// What bounds it on the H100: the instructions its warps execute in the
// automaton, not bytes (35 us of a launch's 2.6 ms is its bytes bound) and
// not idle lanes.  A warp's 32 pixels take different moves in the same
// step (hit, descend, ascend, lateral, ADVANCE) in 29% of its steps at the
// bench pose, and most of a move's instructions are a DDA step.  The
// automaton (traverse.cuh `run`) gives each step one DDA loop whose turns
// the lanes share, so a warp whose lanes ascend, step sideways and advance
// in one step runs the DDA steps of its longest ADVANCE, not one more
// for each other move.

#include "frame.cuh"

#define VHX_KMAX 32

// What ray generation reads of one camera
struct FrameCam {
    float origin[3];
    float right[3];
    float up[3];
    float forward[3];
    float scale[2];  // (tan(fov_y / 2) * w / h, tan(fov_y / 2))
};

struct FramesParams {
    TraceParams trace;
    float cw, ch;  // 1 / w * 2 and 1 / h * 2, folded as the plain raygen folds them
    float bg[3];   // background color of a miss
    int w, h;
    int n_frames;  // 1 .. VHX_KMAX
    FrameCam cams[VHX_KMAX];
};

namespace {

constexpr int THREADS = vhx::FRAME_THREADS;

__global__ void __launch_bounds__(THREADS)
frames_kernel(const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
              const float4* __restrict__ palette, int n_colors,
              const __grid_constant__ FramesParams P, float* __restrict__ rgb_out,
              unsigned char* __restrict__ u8_out, const unsigned char* __restrict__ prev,
              int* __restrict__ digest) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    int x, y;
    vhx::tile_pixel(x, y);
    if (x >= P.w || y >= P.h) return;
    const long long r = (long long)y * P.w + x;
    const long long frame_px = (long long)P.w * P.h;
    const int digest_words = 1 + (P.h + vhx::WARP_H - 1) / vhx::WARP_H;
    const int row_bit = 1 << (y - (int)blockIdx.y * vhx::WARP_H);
    unsigned char last[3] = {0, 0, 0};
    if (digest) {
#pragma unroll
        for (int c = 0; c < 3; ++c) last[c] = prev[3 * r + c];
    }

    for (int k = 0; k < P.n_frames; ++k) {
        const FrameCam& cam = P.cams[k];
        float o[3], d[3];
        vhx::pixel_ray(cam.origin, cam.right, cam.up, cam.forward, cam.scale, P.cw, P.ch, x, y,
                       o, d);
        const vhx::Hit h = vhx::march(o, d, occ, colors, levels, P.trace.n_levels,
                                      P.trace.size, P.trace.n_blocks, P.trace.max_iters);
        float rgb[3];
        vhx::shade_hit(h, palette, n_colors, P.bg, rgb);
        const long long px = 3 * (k * frame_px + r);
        if (rgb_out) {
#pragma unroll
            for (int c = 0; c < 3; ++c) rgb_out[px + c] = rgb[c];
        }
        if (u8_out) {
            unsigned char q[3];
            bool changed = false;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                q[c] = vhx::to_u8(rgb[c]);
                u8_out[px + c] = q[c];
                changed = changed || q[c] != last[c];
                last[c] = q[c];
            }
            if (digest && changed) {
                int* words = digest + (long long)k * digest_words;
                int* group = words + 1 + blockIdx.y;
                if ((*(volatile int*)group & row_bit) == 0 &&
                    (atomicOr(group, row_bit) & row_bit) == 0)
                    atomicAdd(words, 1);
            }
        }
    }
}

}  // namespace

extern "C" int vhx_frames_params_size() { return (int)sizeof(FramesParams); }

extern "C" int vhx_frames_kmax() { return VHX_KMAX; }

// Render params->n_frames frames into rgb (f32 [K, h, w, 3]) or u8
// ([K, h, w, 3]).  With `digest` (int32 [K, 1 + ceil(h / 8)], u8 only),
// also each frame's digest, frame 0's against `prev` (u8 [h, w, 3]).
extern "C" cudaError_t vhx_render_frames(const void* occ_pairs, const void* colors,
                                         const float* palette, int n_colors,
                                         const FramesParams* params, float* rgb, void* u8,
                                         const void* prev, int* digest, int device,
                                         cudaStream_t stream) {
    const FramesParams& P = *params;
    if (P.trace.n_levels < 1 || P.trace.n_levels > VHX_MAX_LEVELS || n_colors < 1 || P.w < 1 ||
        P.h < 1 || P.n_frames < 1 || P.n_frames > VHX_KMAX || (!rgb) == (!u8) ||
        (digest && (!u8 || !prev)))
        return cudaErrorInvalidValue;
    const dim3 grid((P.w + vhx::BLOCK_W - 1) / vhx::BLOCK_W,
                    (P.h + vhx::WARP_H - 1) / vhx::WARP_H);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (digest) {
        const size_t words = (size_t)P.n_frames * (1 + grid.y);
        err = cudaMemsetAsync(digest, 0, words * sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    frames_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const uint2*>(occ_pairs), static_cast<const unsigned short*>(colors),
        reinterpret_cast<const float4*>(palette), n_colors, P, rgb,
        static_cast<unsigned char*>(u8), static_cast<const unsigned char*>(prev), digest);
    return cudaGetLastError();
}
