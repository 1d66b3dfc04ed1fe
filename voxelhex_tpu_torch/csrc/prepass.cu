// The depth prepass: a frame's rays traced at 1 / 2^k of its resolution,
// then at each finer level up to 1 / 2, each level starting its rays from
// the depths of the level before.
//
// Replaces the level loop of the reference's `_render_impl` (voxelhex_tpu/
// render/bitgrid.py:2857-2885) with its `_depth_start` (:1198), XLA
// programs on the path of the ported traversal (voxelhex_tpu/ops/
// traverse_pallas.py).  Two kernels:
//   prepass_kernel      one launch a coarse level, one thread a pixel of it
//                       (frame.cuh's 4 x 8 warp tiles): the pixel's ray
//                       from the camera params at the level's resolution;
//                       its start from the coarser level's depth, the least
//                       of the 2 x 2 edge-clamped neighbourhood of its
//                       coarse pixel, less 2, at least 0 (none at the
//                       coarsest level); the automaton (traverse.cuh, the
//                       renderer's settings); its depth |p - o|
//                       (frame.cuh ray_length, the reference's norm) or
//                       1e8 on a miss;
//   depth_start_kernel  the finest coarse level's depth to the start map of
//                       the full-resolution frame, which the frame kernel
//                       reads with a tile of 2 (frame.cu).
// The starts are not conservative: a frame with the prepass may differ
// from the plain frame, as the reference's does.
//
// What bounds it: the levels' marches, a quarter and a sixteenth of the
// frame's rays at two levels, each its own launch.
//
// Under the reference renderer's `tracer="skip"` its levels march the skip
// tracer (`self._trace`, bitgrid.py:1578, :1597), so a level's depths are
// those of the skip tracer's hit points: `prepass_kernel<kStart, L>` over
// the skip rows of a grid of L levels (skip.cuh); L = 0 is the stack
// automaton's.

#include "frame.cuh"
#include "skip.cuh"

struct PrepassParams {
    TraceParams trace;
    FrameCam cam;  // the camera params at this level's resolution
    float cw, ch;  // 1 / w * 2 and 1 / h * 2, folded as the plain raygen folds them
    int w, h;      // this level's resolution
};

namespace {

constexpr int THREADS = vhx::FRAME_THREADS;
constexpr float MISS_DEPTH = 1e8f;
constexpr float MARGIN = 2.f;

// max(min(d[y, x], d[y + 1, x], d[y, x + 1], d[y + 1, x + 1]) - 2, 0) over
// the [h, w] depths `d`, the last row and column repeated
__device__ __forceinline__ float start_from(const float* __restrict__ d, int w, int h, int x,
                                            int y) {
    const int x1 = x + 1 < w ? x + 1 : x, y1 = y + 1 < h ? y + 1 : y;
    const float a = vhx::xla_min(__ldg(&d[y * w + x]), __ldg(&d[y1 * w + x]));
    const float b = vhx::xla_min(__ldg(&d[y * w + x1]), __ldg(&d[y1 * w + x1]));
    return vhx::xla_max(__fsub_rn(vhx::xla_min(a, b), MARGIN), 0.f);
}

// With L >= 1, `occ` holds the skip rows of a grid of L levels and the
// rays march the skip tracer, `substeps` substeps a body iteration.
template <bool kStart, int L>
__global__ void __launch_bounds__(THREADS)
prepass_kernel(const uint2* __restrict__ occ, const PrepassParams P,
               const float* __restrict__ coarser, float* __restrict__ depth, int substeps) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    if constexpr (L == 0) vhx::load_levels(P.trace, levels);
    int x, y;
    vhx::tile_pixel(x, y);
    if (x >= P.w || y >= P.h) return;
    float o[3], d[3];
    vhx::pixel_ray(P.cam.origin, P.cam.right, P.cam.up, P.cam.forward, P.cam.scale, P.cw, P.ch,
                   x, y, o, d);
    float start_t = 0.f;
    if constexpr (kStart) start_t = start_from(coarser, P.w / 2, P.h / 2, x / 2, y / 2);
    if constexpr (L > 0) {
        const vhx::SkipGrid g = vhx::skip_grid(occ, P.trace.size, substeps);
        vhx::Skip<L> m;
        vhx::skip_init<kStart>(m, o, d, g, start_t);
        vhx::SkipStopAtHit stop;
        vhx::skip_run(m, g, P.trace.max_iters, stop);
        depth[y * P.w + x] = m.hit ? vhx::ray_length(m.p, o) : MISS_DEPTH;
    } else {
        const vhx::Grid g{occ, levels, P.trace.n_levels, P.trace.size, P.trace.n_blocks};
        vhx::March m;
        vhx::init<kStart>(m, o, d, g, start_t);
        vhx::StopAtHit stop;
        vhx::run(m, g, P.trace.max_iters, stop);
        depth[y * P.w + x] = m.hit ? vhx::ray_length(m.p, o) : MISS_DEPTH;
    }
}

__global__ void __launch_bounds__(THREADS)
depth_start_kernel(const float* __restrict__ depth, int w, int h, float* __restrict__ start) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= (long long)w * h) return;
    const int x = (int)(i % w), y = (int)(i / w);
    start[i] = start_from(depth, w, h, x, y);
}

template <bool kStart, int L>
cudaError_t launch(dim3 grid, const uint2* occ, const PrepassParams& P, const float* coarser,
                   float* depth, int substeps, cudaStream_t stream) {
    prepass_kernel<kStart, L><<<grid, THREADS, 0, stream>>>(occ, P, coarser, depth, substeps);
    return cudaGetLastError();
}

// One level of either tracer: the stack automaton over the pyramid's word
// pairs with `substeps` 0, else the skip tracer over the skip rows
cudaError_t level(const void* grid_words, const PrepassParams* params, int substeps,
                  const float* coarser, float* depth, int device, cudaStream_t stream) {
    const PrepassParams& P = *params;
    const int max_levels = substeps ? VHX_SKIP_MAX_LEVELS : VHX_MAX_LEVELS;
    if (P.trace.n_levels < 1 || P.trace.n_levels > max_levels || P.w < 1 || P.h < 1 ||
        (coarser && (P.w % 2 || P.h % 2)) || !depth || substeps < 0 ||
        (substeps && !vhx::skip_rows_aligned(grid_words)))
        return cudaErrorInvalidValue;
    const dim3 grid((P.w + vhx::BLOCK_W - 1) / vhx::BLOCK_W,
                    (P.h + vhx::WARP_H - 1) / vhx::WARP_H);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const auto* occ = static_cast<const uint2*>(grid_words);
    if (substeps)
        return vhx::skip_depth(P.trace.n_levels, [&](auto depth_of) {
            constexpr int L = decltype(depth_of)::value;
            return coarser ? launch<true, L>(grid, occ, P, coarser, depth, substeps, stream)
                           : launch<false, L>(grid, occ, P, nullptr, depth, substeps, stream);
        });
    return coarser ? launch<true, 0>(grid, occ, P, coarser, depth, 0, stream)
                   : launch<false, 0>(grid, occ, P, nullptr, depth, 0, stream);
}

}  // namespace

extern "C" int vhx_prepass_params_size() { return (int)sizeof(PrepassParams); }

// One level's depths, f32 [h, w], its rays started from the coarser
// level's depths `coarser` (f32 [h / 2, w / 2]), or from the world's entry
// without them.
extern "C" cudaError_t vhx_prepass_level(const void* occ_pairs, const PrepassParams* params,
                                         const float* coarser, float* depth, int device,
                                         cudaStream_t stream) {
    return level(occ_pairs, params, 0, coarser, depth, device, stream);
}

// The skip tracer's level: as vhx_prepass_level, over `rows` (the grid's
// skip rows, u32 [ceil(S / 4)^3, 2 n_levels], 16 B aligned), `substeps` >=
// 1 substeps a body iteration and params->trace.max_iters body iterations
// a ray; the instance of the grid's depth.
extern "C" cudaError_t vhx_prepass_level_skip(const void* rows, const PrepassParams* params,
                                              int substeps, const float* coarser, float* depth,
                                              int device, cudaStream_t stream) {
    if (substeps < 1) return cudaErrorInvalidValue;
    return level(rows, params, substeps, coarser, depth, device, stream);
}

// The start map, f32 [h, w], of the level finer than `depth` (f32 [h, w]).
extern "C" cudaError_t vhx_depth_start(const float* depth, int w, int h, float* start,
                                       int device, cudaStream_t stream) {
    if (w < 1 || h < 1 || !depth || !start) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const long long n = (long long)w * h;
    depth_start_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        depth, w, h, start);
    return cudaGetLastError();
}
