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
//
// `frame_start_kernel` is the same frame from a prepass's start map (the
// reference's `start_t`): each ray starts at least its pixel tile's value
// along.  It is its own instance, so the frame without a start compiles as
// it did.  `frame_skip_kernel<kStart, L, kU8>` is the frame of the skip
// tracer (skip.cuh, the reference renderer's `tracer="skip"`) over the skip
// rows of a grid of L levels, with and without a start map: the same
// prologue and epilogue.  `frame_form_kernel<kStart, kOpt, kU8>` is the
// stack automaton's frame under the renderer's options read at run time
// (kOpt: traverse.cuh TraceOptions, the reference's `lateral_step`,
// `parent_skip` and `advance_substeps`), or over a u8 color grid (kU8:
// `color_u8`), or both; the two instances of the default options over u16
// colors are `frame_kernel` and `frame_start_kernel`.  kU8 of the skip and
// LOD frames reads u8 colors too.
//
// `frame_lod_kernel<kStop>` is the reference renderer's `render_lod`
// (bitgrid.py:1627): the tracer `make_bitgrid_tracer(..., lod_scale)` with
// its default settings (2 DDA substeps an ADVANCE, lateral steps, 4
// restarts) and its `shade_lod`, an XLA program on the path of the two
// ported kernels.  The same prologue; the automaton with the LOD stop rule
// (`LodStop`: an occupied cell above level 0 is a hit where the ray's
// squared distance from its origin reaches its level's entry of the stop
// table, not from log2f, whose last bit differs from XLA:CPU's); an
// epilogue that takes the albedo from the palette at level 0 and from the
// hit level's MIP grid above it (`resolve_rgb_lod`), then Lambert, into
// f32.  What bounds it: as the frame kernel, the automaton's instructions
// a step, with more steps (2 substeps an ADVANCE against 4) and fewer as
// lod_scale stops rays higher.  The stop rule decides only on the steps
// that meet an occupied cell above level 0 (a fifth of them at the bench
// pose, a third in a 512 world), so it is computed only there, as one
// compare of the unrooted squared distance against the level's entry (a
// constant-bank load): no root, multiply or table scan on the other
// steps.  The hit voxel's color is read only where the palette gives the
// albedo.  Where no step can stop above level 0 (every entry of the table
// NaN, at lod_scale <= 0 or NaN, or +inf: ops/frame.py lod_stopless) the
// stopless instance marches without the rule.

#include "frame.cuh"
#include "skip.cuh"

// The LOD frame's parameters besides the frame's: the MIP color grids of
// levels 1 .. n_mip (f32 [n^3, 3], n = max(size >> 2l, 1)) and their
// cells, and the stop table: an occupied cell of level l >= 1 is a hit
// where the squared distance s = |p - o|^2 of the ray's point from its
// origin is at least stop_sq[l - 1] (NaN: at no s).  stop_sq[k] is the
// least f32 s at which the reference's stop level, clip(int(log2(max(
// sqrt(s) * lod_scale, 1)) * 0.5), 0, top), is above k (render/bitgrid.py
// lod_stop_sq): both roundings are monotone, so one compare of s decides
// what the norm, the multiply and the level's threshold decided.
struct LodParams {
    const float* mip[VHX_MAX_LEVELS];
    long long mip_cells[VHX_MAX_LEVELS];
    float stop_sq[VHX_MAX_LEVELS];
    int n_mip;
};

namespace vhx {

// The LOD frame's policy: stop on the first hit, an occupied cell above
// level 0 included where the ray's squared distance from its origin `o`
// reaches its level's entry of the stop table
struct LodStop {
    const float* stop_sq;  // LodParams.stop_sq
    float o[3];
    __device__ __forceinline__ bool on_hit(March&) const { return true; }
};

// |p - o|^2 as the reference's norm sums it before its root: the squares
// summed in order, unfused (frame.cuh ray_length)
__device__ __forceinline__ float ray_sq(const float p[3], const float o[3]) {
    const float x = __fsub_rn(p[0], o[0]), y = __fsub_rn(p[1], o[1]), z = __fsub_rn(p[2], o[2]);
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The LOD march's move: choose_move's, but a descend into an occupied cell
// of level l >= 1 is a hit where s >= stop_sq[l - 1].  The stop rule
// decides only there, so only there is it computed.
__device__ __forceinline__ int policy_move(const LodStop& pol, const March& m) {
    const int move = choose_move(m);
    if (move != MOVE_DESCEND) return move;
    return ray_sq(m.p, pol.o) >= pol.stop_sq[m.level - 1] ? MOVE_HIT : MOVE_DESCEND;
}

}  // namespace vhx

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

// One pixel's frame.  With kStart the ray starts at least `start_t` along
// (traverse.cuh init's start form): a prepass's start map, one value for
// each `start_tile` x `start_tile` pixels, `start_stride` tiles a row.
// With L >= 1, `occ` holds the skip rows of a grid of L levels and the ray
// marches the skip tracer, `substeps` substeps a body iteration; with kOpt
// the stack automaton follows `opt`.
template <bool kStart, int L = 0, bool kOpt = false, class TColor>
__device__ __forceinline__ void frame_pixel(const uint2* __restrict__ occ,
                                            const TColor* __restrict__ colors,
                                            const float4* __restrict__ palette, int n_colors,
                                            const FrameParams& P, const int2* levels,
                                            const float* __restrict__ start, int start_tile,
                                            int start_stride, float* __restrict__ rgb_out,
                                            unsigned char* __restrict__ u8_out,
                                            int substeps = 0,
                                            const TraceOptions& opt = TraceOptions{}) {
    int x, y;
    vhx::tile_pixel(x, y);
    if (x >= P.w || y >= P.h) return;

    // ---- prologue: the pixel's ray
    float o[3], d[3];
    vhx::pixel_ray(P.origin, P.right, P.up, P.forward, P.scale, P.cw, P.ch, x, y, o, d);

    // ---- the ray
    float start_t = 0.f;
    if constexpr (kStart) start_t = start[(y / start_tile) * start_stride + x / start_tile];
    vhx::Hit h;
    if constexpr (L > 0)
        h = vhx::skip_march<kStart, L>(o, d, vhx::skip_grid(occ, P.trace.size, substeps), colors,
                                       P.trace.max_iters, start_t);
    else
        h = vhx::march<kStart, kOpt>(o, d, occ, colors, levels, P.trace.n_levels, P.trace.size,
                                     P.trace.n_blocks, P.trace.max_iters, start_t, true, opt);

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

__global__ void __launch_bounds__(THREADS)
frame_kernel(const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
             const float4* __restrict__ palette, int n_colors, const FrameParams P,
             float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    frame_pixel<false>(occ, colors, palette, n_colors, P, levels, nullptr, 1, 0, rgb_out,
                       u8_out);
}

// The frame from a prepass's start map (beam.cu, splat.cu, prepass.cu)
__global__ void __launch_bounds__(THREADS)
frame_start_kernel(const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
                   const float4* __restrict__ palette, int n_colors, const FrameParams P,
                   const float* __restrict__ start, int start_tile, int start_stride,
                   float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    frame_pixel<true>(occ, colors, palette, n_colors, P, levels, start, start_tile,
                      start_stride, rgb_out, u8_out);
}

// The stack automaton's frame from a start map with kStart, under `opt`
// with kOpt, over u8 colors with kU8
template <bool kStart, bool kOpt, bool kU8>
__global__ void __launch_bounds__(THREADS)
frame_form_kernel(const uint2* __restrict__ occ, const vhx::color_t<kU8>* __restrict__ colors,
                  const float4* __restrict__ palette, int n_colors, const FrameParams P,
                  const TraceOptions opt, const float* __restrict__ start, int start_tile,
                  int start_stride, float* __restrict__ rgb_out,
                  unsigned char* __restrict__ u8_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    frame_pixel<kStart, 0, kOpt>(occ, colors, palette, n_colors, P, levels, start, start_tile,
                                 start_stride, rgb_out, u8_out, 0, opt);
}

// The skip tracer's frame over a grid of L levels, from a start map with
// kStart, over u8 colors with kU8
template <bool kStart, int L, bool kU8>
__global__ void __launch_bounds__(THREADS)
frame_skip_kernel(const uint2* __restrict__ rows, const vhx::color_t<kU8>* __restrict__ colors,
                  const float4* __restrict__ palette, int n_colors, const FrameParams P,
                  int substeps, const float* __restrict__ start, int start_tile,
                  int start_stride, float* __restrict__ rgb_out,
                  unsigned char* __restrict__ u8_out) {
    frame_pixel<kStart, L>(rows, colors, palette, n_colors, P, nullptr, start, start_tile,
                              start_stride, rgb_out, u8_out, substeps);
}

// The LOD frame of each pixel into rgb (f32 [h, w, 3]).  Without kStop no
// ray stops above level 0: the march is the stack automaton's at 2
// substeps, and every hit takes its albedo from the palette.  kU8: u8
// colors.
template <bool kStop, bool kU8>
__global__ void __launch_bounds__(THREADS)
frame_lod_kernel(const uint2* __restrict__ occ, const vhx::color_t<kU8>* __restrict__ colors,
                 const float4* __restrict__ palette, int n_colors, const FrameParams P,
                 const __grid_constant__ LodParams Lp, float* __restrict__ rgb_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P.trace, levels);
    int x, y;
    vhx::tile_pixel(x, y);
    if (x >= P.w || y >= P.h) return;
    float o[3], d[3];
    vhx::pixel_ray(P.origin, P.right, P.up, P.forward, P.scale, P.cw, P.ch, x, y, o, d);
    const vhx::Grid g{occ, levels, P.trace.n_levels, P.trace.size, P.trace.n_blocks};
    vhx::March m;
    vhx::init(m, o, d, g);
    if constexpr (kStop) {
        vhx::LodStop pol{Lp.stop_sq, {o[0], o[1], o[2]}};
        vhx::run<vhx::LodStop, 2>(m, g, P.trace.max_iters, pol);
    } else {
        vhx::StopAtHit pol;
        vhx::run<vhx::StopAtHit, 2>(m, g, P.trace.max_iters, pol);
    }
    float rgb[3] = {P.bg[0], P.bg[1], P.bg[2]};
    if (m.hit) {
        float a[3] = {0.f, 0.f, 0.f};
        const int l = m.level;
        // hit_of's voxel and normal; its color read only where the albedo
        // comes from the palette: at level 0, or above the MIP grids
        int hvox[3];
        float normal[3];
        vhx::hit_cell(m, hvox, normal);
        if (kStop && l >= 1 && l <= Lp.n_mip) {
            // the hit cell's MIP color: its cell of level l, clipped
            const int n = (P.trace.size >> (2 * l)) > 1 ? P.trace.size >> (2 * l) : 1;
            long long addr = 0, stride = 1;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const int v = hvox[c] >> (2 * l);
                addr += (long long)(v < 0 ? 0 : (v > n - 1 ? n - 1 : v)) * stride;
                stride *= n;
            }
            if (addr > Lp.mip_cells[l - 1] - 1) addr = Lp.mip_cells[l - 1] - 1;
#pragma unroll
            for (int c = 0; c < 3; ++c) a[c] = __ldg(&Lp.mip[l - 1][3 * addr + c]);
        } else {
            const int voxel = vhx::hit_color(hvox, colors, P.trace.size);
            if (voxel >= 0 && voxel != vhx::NO_COLOR_HIT) {
                const float4 p = __ldg(&palette[voxel < n_colors ? voxel : n_colors - 1]);
                a[0] = p.x;
                a[1] = p.y;
                a[2] = p.z;
            }
        }
        // sum(n * (-0.5, 0.5, -0.5)) / 2 + 0.5, as shade_hit
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(normal[0], -0.5f),
                                            __fmul_rn(normal[1], 0.5f)),
                                  __fmul_rn(normal[2], -0.5f));
        const float lambert = __fadd_rn(__fmul_rn(s, 0.5f), 0.5f);
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = __fmul_rn(a[c], lambert);
    }
    const long long r = (long long)y * P.w + x;
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb_out[3 * r + c] = rgb[c];
}

bool bad_frame(const FrameParams& P, int n_colors, const float* start, int start_tile,
               int max_levels) {
    return P.trace.n_levels < 1 || P.trace.n_levels > max_levels || n_colors < 1 || P.w < 1 ||
           P.h < 1 || (start && start_tile < 1) || (P.h + WARP_H - 1) / WARP_H > 65535;
}

}  // namespace

extern "C" int vhx_frame_params_size() { return (int)sizeof(FrameParams); }

// The frame into rgb (f32 [h, w, 3]) or u8 ([h, w, 3]).  With `start` (f32,
// one value a `start_tile` x `start_tile` tile of pixels, ceil(w /
// start_tile) a row), each ray starts at least its tile's value along.
// `substeps` 0 marches the stack automaton over the pyramid's word pairs
// `words`, under `opts` (null: the default options); `substeps` >= 1 the
// skip tracer over the skip rows (u32 [ceil(S / 4)^3, 2 n_levels], 16 B
// aligned; `opts` null), `substeps` substeps a body iteration and
// params->trace.max_iters body iterations a ray, the instance of the
// grid's depth.  `colors` is u16 (`color_bytes` 2) or u8 (1).
extern "C" cudaError_t vhx_render_frame_ex(const void* words, const void* colors,
                                           const float* palette, int n_colors,
                                           const FrameParams* params, const TraceOptions* opts,
                                           int color_bytes, int substeps, const float* start,
                                           int start_tile, float* rgb, void* u8, int device,
                                           cudaStream_t stream) {
    const FrameParams& P = *params;
    if (bad_frame(P, n_colors, start, start_tile,
                  substeps ? VHX_SKIP_MAX_LEVELS : VHX_MAX_LEVELS) ||
        substeps < 0 || (color_bytes != 1 && color_bytes != 2) || (substeps && opts) ||
        (substeps && !vhx::skip_rows_aligned(words)))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const dim3 grid((P.w + BLOCK_W - 1) / BLOCK_W, (P.h + WARP_H - 1) / WARP_H);
    const auto* occ = static_cast<const uint2*>(words);
    const auto* pal = reinterpret_cast<const float4*>(palette);
    auto* out = static_cast<unsigned char*>(u8);
    const int stride = start ? (P.w + start_tile - 1) / start_tile : 0;
    const TraceOptions opt = opts ? *opts : TraceOptions{};
    auto launch = [&](auto u8_colors, auto with_start) {
        constexpr bool kU8 = decltype(u8_colors)::value;
        constexpr bool kStart = decltype(with_start)::value;
        const auto* col = static_cast<const vhx::color_t<kU8>*>(colors);
        if (substeps)
            return vhx::skip_depth(P.trace.n_levels, [&](auto depth) {
                constexpr int L = decltype(depth)::value;
                frame_skip_kernel<kStart, L, kU8><<<grid, THREADS, 0, stream>>>(
                    occ, col, pal, n_colors, P, substeps, start, start_tile, stride, rgb, out);
                return cudaGetLastError();
            });
        if (opts)
            frame_form_kernel<kStart, true, kU8><<<grid, THREADS, 0, stream>>>(
                occ, col, pal, n_colors, P, opt, start, start_tile, stride, rgb, out);
        else if constexpr (kU8)
            frame_form_kernel<kStart, false, true><<<grid, THREADS, 0, stream>>>(
                occ, col, pal, n_colors, P, opt, start, start_tile, stride, rgb, out);
        else if constexpr (kStart)
            frame_start_kernel<<<grid, THREADS, 0, stream>>>(occ, col, pal, n_colors, P, start,
                                                             start_tile, stride, rgb, out);
        else
            frame_kernel<<<grid, THREADS, 0, stream>>>(occ, col, pal, n_colors, P, rgb, out);
        return cudaGetLastError();
    };
    if (color_bytes == 1)
        return start ? launch(std::true_type{}, std::true_type{})
                     : launch(std::true_type{}, std::false_type{});
    return start ? launch(std::false_type{}, std::true_type{})
                 : launch(std::false_type{}, std::false_type{});
}

// The skip tracer's frame over u16 colors: vhx_render_frame_ex with
// `substeps` >= 1
extern "C" cudaError_t vhx_render_frame_skip(const void* rows, const void* colors,
                                             const float* palette, int n_colors,
                                             const FrameParams* params, int substeps,
                                             const float* start, int start_tile, float* rgb,
                                             void* u8, int device, cudaStream_t stream) {
    if (substeps < 1) return cudaErrorInvalidValue;
    return vhx_render_frame_ex(rows, colors, palette, n_colors, params, nullptr, 2, substeps,
                               start, start_tile, rgb, u8, device, stream);
}

// The LOD frame (frame_lod_kernel) into rgb, f32 [h, w, 3]: `lod` holds the
// MIP grids and the stop table; params->trace.max_iters steps a ray;
// `colors` u16 (`color_bytes` 2) or u8 (1); the stop instance with `stop`,
// else the stopless one, for frames in which no step can stop above level 0
// (ops/frame.py lod_stopless).
extern "C" cudaError_t vhx_render_frame_lod_ex(const void* occ_pairs, const void* colors,
                                               const float* palette, int n_colors,
                                               const FrameParams* params, const LodParams* lod,
                                               int color_bytes, int stop, float* rgb, int device,
                                               cudaStream_t stream) {
    const FrameParams& P = *params;
    if (bad_frame(P, n_colors, nullptr, 1, VHX_MAX_LEVELS) || !rgb || lod->n_mip < 0 ||
        lod->n_mip > VHX_MAX_LEVELS || (color_bytes != 1 && color_bytes != 2))
        return cudaErrorInvalidValue;
    for (int l = 0; l < lod->n_mip; ++l)
        if (!lod->mip[l] || lod->mip_cells[l] < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const dim3 grid((P.w + BLOCK_W - 1) / BLOCK_W, (P.h + WARP_H - 1) / WARP_H);
    const auto* occ = static_cast<const uint2*>(occ_pairs);
    const auto* pal = reinterpret_cast<const float4*>(palette);
    auto launch = [&](auto u8_colors, auto with_stop) {
        constexpr bool kU8 = decltype(u8_colors)::value;
        constexpr bool kStop = decltype(with_stop)::value;
        frame_lod_kernel<kStop, kU8><<<grid, THREADS, 0, stream>>>(
            occ, static_cast<const vhx::color_t<kU8>*>(colors), pal, n_colors, P, *lod, rgb);
        return cudaGetLastError();
    };
    if (color_bytes == 1)
        return stop ? launch(std::true_type{}, std::true_type{})
                    : launch(std::true_type{}, std::false_type{});
    return stop ? launch(std::false_type{}, std::true_type{})
                : launch(std::false_type{}, std::false_type{});
}

// The LOD frame over u16 colors by the stop instance
extern "C" cudaError_t vhx_render_frame_lod(const void* occ_pairs, const void* colors,
                                            const float* palette, int n_colors,
                                            const FrameParams* params, const LodParams* lod,
                                            float* rgb, int device, cudaStream_t stream) {
    return vhx_render_frame_lod_ex(occ_pairs, colors, palette, n_colors, params, lod, 2, 1, rgb,
                                   device, stream);
}

// The same frame by the stopless instance
extern "C" cudaError_t vhx_render_frame_lod_stopless(const void* occ_pairs, const void* colors,
                                                     const float* palette, int n_colors,
                                                     const FrameParams* params,
                                                     const LodParams* lod, float* rgb, int device,
                                                     cudaStream_t stream) {
    return vhx_render_frame_lod_ex(occ_pairs, colors, palette, n_colors, params, lod, 2, 0, rgb,
                                   device, stream);
}

extern "C" int vhx_lod_params_size() { return (int)sizeof(LodParams); }

// The stack automaton's frame over u16 colors with the default options:
// vhx_render_frame_ex with `substeps` 0
extern "C" cudaError_t vhx_render_frame_start(const void* occ_pairs, const void* colors,
                                              const float* palette, int n_colors,
                                              const FrameParams* params, const float* start,
                                              int start_tile, float* rgb, void* u8, int device,
                                              cudaStream_t stream) {
    return vhx_render_frame_ex(occ_pairs, colors, palette, n_colors, params, nullptr, 2, 0, start,
                               start_tile, rgb, u8, device, stream);
}

extern "C" cudaError_t vhx_render_frame(const void* occ_pairs, const void* colors,
                                        const float* palette, int n_colors,
                                        const FrameParams* params, float* rgb, void* u8,
                                        int device, cudaStream_t stream) {
    return vhx_render_frame_start(occ_pairs, colors, palette, n_colors, params, nullptr, 1, rgb,
                                  u8, device, stream);
}
