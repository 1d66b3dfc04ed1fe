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
//
// `frames_start_kernel` is the same batch from each frame's start map (the
// beam prepass of beam.cu, one map a camera): its own instance, so the
// batch without a start compiles as it did.  `frames_skip_kernel<kStart,
// L, kU8>` is the batch of the skip tracer (skip.cuh, the reference
// renderer's `tracer="skip"`) over the skip rows of a grid of L levels, with
// and without start maps.  `frames_form_kernel<kStart, kOpt, kU8>` is the
// stack automaton's batch under the renderer's options read at run time
// (kOpt: traverse.cuh TraceOptions), or over a u8 color grid (kU8: the
// reference's `color_u8`), or both; `frames_kernel` and
// `frames_start_kernel` are the default options' over u16 colors, as they
// were.  The skip batch's kU8 reads u8 colors too.

#include "frame.cuh"
#include "skip.cuh"

#define VHX_KMAX 32

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

// Where a batch's rays start (kStart): frame k's start map at `map + k *
// frame_stride`, one value for each `tile` x `tile` pixels, `stride` tiles a
// row, read where bit k of `mask` is set; a frame whose bit is clear marches
// from its entry, as without a start.
struct StartMaps {
    const float* __restrict__ map;
    long long frame_stride;
    int tile;
    int stride;
    unsigned mask;
};

// With L >= 1, `occ` holds the skip rows of a grid of L levels and each ray
// marches the skip tracer, `substeps` substeps a body iteration; with kOpt
// the stack automaton follows `opt`.
template <bool kStart, int L = 0, bool kOpt = false, class TColor>
__device__ __forceinline__ void frames_body(const uint2* __restrict__ occ,
                                            const TColor* __restrict__ colors,
                                            const float4* __restrict__ palette, int n_colors,
                                            const FramesParams& P, const int2* levels,
                                            const StartMaps& S, float* __restrict__ rgb_out,
                                            unsigned char* __restrict__ u8_out,
                                            const unsigned char* __restrict__ prev,
                                            int* __restrict__ digest, int substeps = 0,
                                            const TraceOptions& opt = TraceOptions{}) {
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
    long long start_at = 0;
    if constexpr (kStart) start_at = (long long)(y / S.tile) * S.stride + x / S.tile;

    for (int k = 0; k < P.n_frames; ++k) {
        const FrameCam& cam = P.cams[k];
        float o[3], d[3];
        vhx::pixel_ray(cam.origin, cam.right, cam.up, cam.forward, cam.scale, P.cw, P.ch, x, y,
                       o, d);
        float start_t = 0.f;
        bool use_start = false;
        if constexpr (kStart) {
            use_start = ((S.mask >> k) & 1u) != 0u;
            if (use_start) start_t = S.map[k * S.frame_stride + start_at];
        }
        vhx::Hit h;
        if constexpr (L > 0)
            h = vhx::skip_march<kStart, L>(o, d, vhx::skip_grid(occ, P.trace.size, substeps),
                                           colors, P.trace.max_iters, start_t, use_start);
        else
            h = vhx::march<kStart, kOpt>(o, d, occ, colors, levels, P.trace.n_levels,
                                         P.trace.size, P.trace.n_blocks, P.trace.max_iters,
                                         start_t, use_start, opt);
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

__global__ void __launch_bounds__(THREADS)
frames_kernel(const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
              const float4* __restrict__ palette, int n_colors,
              const __grid_constant__ FramesParams P, float* __restrict__ rgb_out,
              unsigned char* __restrict__ u8_out, const unsigned char* __restrict__ prev,
              int* __restrict__ digest) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    const StartMaps none{nullptr, 0, 1, 0, 0u};
    frames_body<false>(occ, colors, palette, n_colors, P, levels, none, rgb_out, u8_out, prev,
                       digest);
}

// The batch from each frame's start map (beam.cu)
__global__ void __launch_bounds__(THREADS)
frames_start_kernel(const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
                    const float4* __restrict__ palette, int n_colors,
                    const __grid_constant__ FramesParams P, const StartMaps S,
                    float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out,
                    const unsigned char* __restrict__ prev, int* __restrict__ digest) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    frames_body<true>(occ, colors, palette, n_colors, P, levels, S, rgb_out, u8_out, prev,
                      digest);
}

// The stack automaton's batch from start maps with kStart, under `opt` with
// kOpt, over u8 colors with kU8
template <bool kStart, bool kOpt, bool kU8>
__global__ void __launch_bounds__(THREADS)
frames_form_kernel(const uint2* __restrict__ occ, const vhx::color_t<kU8>* __restrict__ colors,
                   const float4* __restrict__ palette, int n_colors,
                   const __grid_constant__ FramesParams P, const StartMaps S,
                   const TraceOptions opt, float* __restrict__ rgb_out,
                   unsigned char* __restrict__ u8_out, const unsigned char* __restrict__ prev,
                   int* __restrict__ digest) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    frames_body<kStart, 0, kOpt>(occ, colors, palette, n_colors, P, levels, S, rgb_out, u8_out,
                                 prev, digest, 0, opt);
}

// The skip tracer's batch over a grid of L levels, from start maps with
// kStart, over u8 colors with kU8
template <bool kStart, int L, bool kU8>
__global__ void __launch_bounds__(THREADS)
frames_skip_kernel(const uint2* __restrict__ rows, const vhx::color_t<kU8>* __restrict__ colors,
                   const float4* __restrict__ palette, int n_colors,
                   const __grid_constant__ FramesParams P, const StartMaps S, int substeps,
                   float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out,
                   const unsigned char* __restrict__ prev, int* __restrict__ digest) {
    frames_body<kStart, L>(rows, colors, palette, n_colors, P, nullptr, S, rgb_out, u8_out, prev,
                           digest, substeps);
}

// The batch of either tracer over u16 (`color_bytes` 2) or u8 (1) colors:
// the stack automaton over the pyramid's word pairs with `substeps` 0,
// under `opts` (null: the default options), else the skip tracer over the
// skip rows
cudaError_t render(const void* grid_words, const void* colors, const float* palette,
                   int n_colors, const FramesParams* params, const TraceOptions* opts,
                   int color_bytes, int substeps, const float* start, int start_tile,
                   unsigned start_mask, float* rgb, void* u8, const void* prev, int* digest,
                   int device, cudaStream_t stream) {
    const FramesParams& P = *params;
    const int max_levels = substeps ? VHX_SKIP_MAX_LEVELS : VHX_MAX_LEVELS;
    if (P.trace.n_levels < 1 || P.trace.n_levels > max_levels || n_colors < 1 || P.w < 1 ||
        P.h < 1 || P.n_frames < 1 || P.n_frames > VHX_KMAX || (!rgb) == (!u8) ||
        (digest && (!u8 || !prev)) || (start && start_tile < 1) || substeps < 0 ||
        (color_bytes != 1 && color_bytes != 2) || (substeps && opts) ||
        (substeps && !vhx::skip_rows_aligned(grid_words)))
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
    const auto* occ = static_cast<const uint2*>(grid_words);
    const auto* pal = reinterpret_cast<const float4*>(palette);
    auto* out = static_cast<unsigned char*>(u8);
    const auto* base = static_cast<const unsigned char*>(prev);
    StartMaps S{};
    if (start) {
        const int stride = (P.w + start_tile - 1) / start_tile;
        S = StartMaps{start, (long long)stride * ((P.h + start_tile - 1) / start_tile),
                      start_tile, stride, start_mask};
    }
    const TraceOptions opt = opts ? *opts : TraceOptions{};
    auto launch = [&](auto u8_colors, auto with_start) {
        constexpr bool kU8 = decltype(u8_colors)::value;
        constexpr bool kStart = decltype(with_start)::value;
        const auto* col = static_cast<const vhx::color_t<kU8>*>(colors);
        if (substeps)
            return vhx::skip_depth(P.trace.n_levels, [&](auto depth) {
                constexpr int L = decltype(depth)::value;
                frames_skip_kernel<kStart, L, kU8><<<grid, THREADS, 0, stream>>>(
                    occ, col, pal, n_colors, P, S, substeps, rgb, out, base, digest);
                return cudaGetLastError();
            });
        if (opts)
            frames_form_kernel<kStart, true, kU8><<<grid, THREADS, 0, stream>>>(
                occ, col, pal, n_colors, P, S, opt, rgb, out, base, digest);
        else if constexpr (kU8)
            frames_form_kernel<kStart, false, true><<<grid, THREADS, 0, stream>>>(
                occ, col, pal, n_colors, P, S, opt, rgb, out, base, digest);
        else if constexpr (kStart)
            frames_start_kernel<<<grid, THREADS, 0, stream>>>(occ, col, pal, n_colors, P, S, rgb,
                                                              out, base, digest);
        else
            frames_kernel<<<grid, THREADS, 0, stream>>>(occ, col, pal, n_colors, P, rgb, out,
                                                        base, digest);
        return cudaGetLastError();
    };
    if (color_bytes == 1)
        return start ? launch(std::true_type{}, std::true_type{})
                     : launch(std::true_type{}, std::false_type{});
    return start ? launch(std::false_type{}, std::true_type{})
                 : launch(std::false_type{}, std::false_type{});
}

}  // namespace

extern "C" int vhx_frames_params_size() { return (int)sizeof(FramesParams); }

extern "C" int vhx_frames_kmax() { return VHX_KMAX; }

// Render params->n_frames frames into rgb (f32 [K, h, w, 3]) or u8
// ([K, h, w, 3]).  With `digest` (int32 [K, 1 + ceil(h / 8)], u8 only),
// also each frame's digest, frame 0's against `prev` (u8 [h, w, 3]).  With
// `start`, frame k whose bit of `start_mask` is set starts each ray at
// least its tile's value of start map k along (f32 [K, ceil(h / tile),
// ceil(w / tile)], `start_tile` x `start_tile` pixels a value).
// `substeps` 0 marches the stack automaton over the pyramid's word pairs
// `words`, under `opts` (null: the default options); `substeps` >= 1 the
// skip tracer over the skip rows (u32 [ceil(S / 4)^3, 2 n_levels], 16 B
// aligned; `opts` null), `substeps` substeps a body iteration and
// params->trace.max_iters body iterations a ray, the instance of the
// grid's depth.  `colors` is u16 (`color_bytes` 2) or u8 (1).
extern "C" cudaError_t vhx_render_frames_ex(const void* words, const void* colors,
                                            const float* palette, int n_colors,
                                            const FramesParams* params, const TraceOptions* opts,
                                            int color_bytes, int substeps, const float* start,
                                            int start_tile, unsigned start_mask, float* rgb,
                                            void* u8, const void* prev, int* digest, int device,
                                            cudaStream_t stream) {
    return render(words, colors, palette, n_colors, params, opts, color_bytes, substeps, start,
                  start_tile, start_mask, rgb, u8, prev, digest, device, stream);
}

// The stack automaton's batch over u16 colors with the default options
extern "C" cudaError_t vhx_render_frames_start(const void* occ_pairs, const void* colors,
                                               const float* palette, int n_colors,
                                               const FramesParams* params, const float* start,
                                               int start_tile, unsigned start_mask, float* rgb,
                                               void* u8, const void* prev, int* digest,
                                               int device, cudaStream_t stream) {
    return render(occ_pairs, colors, palette, n_colors, params, nullptr, 2, 0, start, start_tile,
                  start_mask, rgb, u8, prev, digest, device, stream);
}

// The skip tracer's batch over u16 colors, `substeps` >= 1
extern "C" cudaError_t vhx_render_frames_skip(const void* rows, const void* colors,
                                              const float* palette, int n_colors,
                                              const FramesParams* params, int substeps,
                                              const float* start, int start_tile,
                                              unsigned start_mask, float* rgb, void* u8,
                                              const void* prev, int* digest, int device,
                                              cudaStream_t stream) {
    if (substeps < 1) return cudaErrorInvalidValue;
    return render(rows, colors, palette, n_colors, params, nullptr, 2, substeps, start,
                  start_tile, start_mask, rgb, u8, prev, digest, device, stream);
}

extern "C" cudaError_t vhx_render_frames(const void* occ_pairs, const void* colors,
                                         const float* palette, int n_colors,
                                         const FramesParams* params, float* rgb, void* u8,
                                         const void* prev, int* digest, int device,
                                         cudaStream_t stream) {
    return vhx_render_frames_start(occ_pairs, colors, palette, n_colors, params, nullptr, 1, 0u,
                                   rgb, u8, prev, digest, device, stream);
}
