// A streaming view's frame with its far field in one launch: the window,
// then each LOD ring behind it, folded by hit distance.
//
// Replaces the reference's `_render_far` (voxelhex_tpu/render/streaming.py:
// 1479): the window's `trace_compacted`, then one `trace_compacted` a ring
// with `start_t` from `_far_kill_hits` (:144), the ring's world distance
// (`_hit_dist`, :183) and the nearest-hit composite (`_far_accum`, :160),
// all XLA programs, on the path of the two ported TPU kernels (the
// traversal of voxelhex_tpu/ops/traverse_pallas.py and the shading of
// ops/shade_pallas.py).  Each pixel goes through every layer in turn (the
// window, then rings 0 .. n - 1, each a BitGrid with its own camera
// params, level table and palette, passed by value):
//   prologue  the pixel's ray in the layer's frame (frame.cuh pixel_ray);
//   body      the automaton (traverse.cuh): the window's march as frame.cu
//             runs it, from a start map when the window renderer's beam
//             prepass gives one (the reference's `trace_compacted(...,
//             beam=...)` of the window); a ring's from start_t = 0 when the
//             camera is inside the window, as the reference's, and from its
//             entry otherwise;
//   epilogue  shading (frame.cuh shade_hit), the distance |point - o| * F
//             in world voxels (the squares summed in order, unfused, as
//             XLA:CPU sums the reference's norm), and the fold: the ring's
//             hit replaces what the pixel holds if nothing was hit yet or
//             it is nearer.
// With the camera inside the window the reference starts a ray that hit
// already at 1e9, which makes it inactive from init on (a ring contains the
// window, so the ray's exit from a ring's box is nearer than 1e9 cells):
// here that ray skips the ring.  After the last layer, the u8 step
// (frame.cuh to_u8) or the f32 color.
//
// What bounds it on the H100: the automaton's instructions, as in frame.cu
// (the layers' pyramids are L2-resident: 2.1 MB at a 256 window, as much
// again for a 256-cell ring).  At a fly-over pose the window's march takes
// about 70% of the frame and the ring's march the rest, in proportion to
// its steps; the layer loop itself costs nothing measurable.  So the design
// keeps the march's code small and its registers free (PERF.md):
//   * one automaton: each layer picks init's form at run time (the start
//     clip for a ring when the camera is inside) and runs one `run` and one
//     hit epilogue, so the automaton's loop is compiled once, not once a
//     form;
//   * what a pixel holds between layers (hit, world distance, color: 17 B)
//     lives in the block's shared memory, one entry a thread: held in
//     registers across the march instead, it made the same launch 7%
//     slower;
//   * the level tables of all layers are filled by the block's threads at
//     once.
// Packing the rays that go on to a ring into a block's first warps at each
// layer boundary bought less than its barriers cost: the ring's rays are
// the sky and the far terrain, which fill whole warps already.
//
// Under the reference view's `tracer="skip"` (its window renderer and each
// ring's renderer take the view's tracer, streaming.py:396, :1407) every
// layer marches the skip tracer (skip.cuh) over its skip rows (a layer's
// `occ`): `far_skip_kernel<kStart, kInside, L, kSub>`.  The skip march is
// an instance a pyramid depth, and a far frame's layers need not share
// one: the window and every ring have `view_size` cells, but the outermost
// ring of a world more than 4 times the window has W / F cells, fewer than
// the window's and more than a quarter of them, so its pyramid is one
// level shallower or as deep.  So an instance takes the window's depth L,
// marches the window with L levels and each ring with its own, L or L - 1;
// the C entry refuses other depths.  Where the stack form keeps one copy
// of its march for every layer, the skip form fixes each of its march's
// forms at compile time (PERF.md §6, on an NVIDIA H100 80GB HBM3 at
// 700 W: -8.2% at fly-over pose 7, -5.4% at pose 0 against one march with
// its forms picked at run time, in the same call):
//   * init's start form: the window's by kStart (its start map), the
//     rings' by kInside (from the camera when it is inside the window, the
//     same for every block of a launch; a ray that hit stops there), so
//     the window's march and the rings' are copies of their own (the
//     forms picked at run time: +2.6% at pose 7);
//   * the view's 3 substeps a body iteration (kSub = 3) have instances of
//     their own, the substeps unrolled (without them: +7.2% at pose 7);
//     other counts run skip.cuh's loop (kSub = 0);
//   * what a pixel holds between layers stays in the block's shared
//     memory, as above (in registers: +1.1% at pose 7).  No barrier: a
//     thread touches only its own entry.
// Capping its registers for more blocks on an SM made it no faster (48
// registers and spills: +0.1%, on the window alone +1.1%): its march is
// bound by its instructions, not by the row fetch's latency.  The stack
// instances do not change.

#include "frame.cuh"
#include "skip.cuh"

#define VHX_FAR_MAX_LAYERS 8

// One layer: a BitGrid and the camera in its frame
struct FarLayer {
    TraceParams trace;
    const uint2* occ;
    const unsigned short* colors;
    const float4* palette;
    int n_colors;
    float factor;  // world voxels a cell of the layer
    float origin[3];
    float right[3];
    float up[3];
    float forward[3];
    float scale[2];  // (tan(fov_y / 2) * w / h, tan(fov_y / 2))
};

struct FarParams {
    float cw, ch;  // 1 / w * 2 and 1 / h * 2, folded as the plain raygen folds them
    float bg[3];   // background color of a miss
    int w, h;
    int inside;    // the camera is inside the window
    int n_layers;  // 1 .. VHX_FAR_MAX_LAYERS: the window, then the rings
    FarLayer layers[VHX_FAR_MAX_LAYERS];
};

namespace {

constexpr int THREADS = vhx::FRAME_THREADS;
constexpr int WARP_H = vhx::WARP_H;
constexpr int BLOCK_W = vhx::BLOCK_W;

// What the block's pixels hold between layers, one entry a thread
struct Pixels {
    float rgb[3][THREADS];
    float dist[THREADS];
    unsigned char hit[THREADS];
};

// The pixel (x, y) of thread t of this block (frame.cuh's tile_pixel).  The
// march's loop computes it again from t rather than keep it from the top: in
// that form the kernel compiled to the fastest of the shapes timed (PERF.md,
// §6), which differed by up to 1.6% with the same arithmetic.
__device__ __forceinline__ void thread_pixel(int t, int& x, int& y) {
    const int lane = t & 31;
    x = blockIdx.x * BLOCK_W + (t >> 5) * vhx::WARP_W + lane % vhx::WARP_W;
    y = blockIdx.y * WARP_H + lane / vhx::WARP_W;
}

// The frame of this block's pixels.  With kStart the window's rays start at
// least their tile's value of a start map along: one value a `start_tile` x
// `start_tile` tile of pixels, `start_stride` tiles a row.  Without it the
// window's rays start at their entry.
template <bool kStart>
__device__ __forceinline__ void far_frame(const FarParams& P, const float* __restrict__ start,
                                          int start_tile, int start_stride,
                                          float* __restrict__ rgb_out,
                                          unsigned char* __restrict__ u8_out) {
    __shared__ int2 levels[VHX_FAR_MAX_LAYERS * VHX_MAX_LEVELS];
    __shared__ Pixels px;
    const int t = threadIdx.x;
    for (int e = t; e < P.n_layers * VHX_MAX_LEVELS; e += THREADS) {
        const TraceParams& T = P.layers[e / VHX_MAX_LEVELS].trace;
        levels[e] = make_int2(T.bases[e % VHX_MAX_LEVELS], T.dims[e % VHX_MAX_LEVELS]);
    }
    int x, y;
    thread_pixel(t, x, y);
    const bool valid = x < P.w && y < P.h;
    px.hit[t] = 0;
    px.dist[t] = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) px.rgb[k][t] = P.bg[k];
    __syncthreads();

    for (int l = 0; l < P.n_layers; ++l) {
        // a ray that hit already skips a ring when the camera is inside (the
        // reference's start_t = 1e9)
        bool go = valid;
        if (l > 0 && P.inside) go = valid && !px.hit[t];
        if (go) {
            const FarLayer& L = P.layers[l];
            int sx, sy;
            thread_pixel(t, sx, sy);
            float o[3], d[3];
            vhx::pixel_ray(L.origin, L.right, L.up, L.forward, L.scale, P.cw, P.ch, sx, sy, o, d);
            const vhx::Grid g{L.occ, levels + l * VHX_MAX_LEVELS, L.trace.n_levels,
                              L.trace.size, L.trace.n_blocks};
            vhx::March m;
            // a ring's rays start at the camera (start_t = 0) when it is
            // inside; the window's from its start map when there is one
            float start_t = 0.f;
            bool use_start = l > 0 && P.inside;
            if constexpr (kStart) {
                if (l == 0) {
                    start_t = start[(sy / start_tile) * start_stride + sx / start_tile];
                    use_start = true;
                }
            }
            vhx::init<true>(m, o, d, g, start_t, use_start);
            vhx::StopAtHit stop;
            vhx::run(m, g, L.trace.max_iters, stop);
            if (m.hit) {
                const vhx::Hit h = vhx::hit_of(m, L.colors, L.trace.size);
                const float hd = __fmul_rn(vhx::ray_length(h.point, o), L.factor);
                // the nearest hit in world voxels; a tie keeps the finer layer's
                if (!px.hit[t] || hd < px.dist[t]) {
                    float rgb[3];
                    vhx::shade_hit(h, L.palette, L.n_colors, P.bg, rgb);
                    px.hit[t] = 1;
                    px.dist[t] = hd;
#pragma unroll
                    for (int k = 0; k < 3; ++k) px.rgb[k][t] = rgb[k];
                }
            }
        }
    }
    if (!valid) return;
    const long long r = (long long)y * P.w + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (rgb_out) rgb_out[3 * r + k] = px.rgb[k][t];
        if (u8_out) u8_out[3 * r + k] = vhx::to_u8(px.rgb[k][t]);
    }
}

__global__ void __launch_bounds__(THREADS)
far_kernel(const __grid_constant__ FarParams P, float* __restrict__ rgb_out,
           unsigned char* __restrict__ u8_out) {
    far_frame<false>(P, nullptr, 1, 0, rgb_out, u8_out);
}

// The frame whose window starts from the window renderer's beam (beam.cu)
__global__ void __launch_bounds__(THREADS)
far_start_kernel(const __grid_constant__ FarParams P, const float* __restrict__ start,
                 int start_tile, int start_stride, float* __restrict__ rgb_out,
                 unsigned char* __restrict__ u8_out) {
    far_frame<true>(P, start, start_tile, start_stride, rgb_out, u8_out);
}

// ---- the skip tracer's frame (far_skip_kernel)

// The substeps a body iteration of the reference view's skip tracer
// (`skip_substeps`' default), which have instances of their own
constexpr int VIEW_SUBSTEPS = 3;

// skip_run with the single-hit policy and kSub substeps a body iteration,
// unrolled
template <int kSub, int L>
__device__ __forceinline__ void skip_run_fixed(vhx::Skip<L>& m, const vhx::SkipGrid& g,
                                               int max_iters) {
    while (m.active && m.iters < max_iters) {
        m.iters += 1;
#pragma unroll
        for (int j = 0; j < kSub; ++j)
            if (!vhx::skip_substep(m, g)) break;
        if (m.hit) return;
        if (m.active) vhx::skip_fetch(m, g);
    }
}

// The skip march of a layer whose `occ` holds the skip rows of a pyramid of
// L levels: init's start form with kStartForm (from `start_t`), kSub
// substeps a body iteration (0: `substeps`)
template <bool kStartForm, int L, int kSub>
__device__ __forceinline__ vhx::Hit skip_layer(const FarLayer& Y, const float o[3],
                                               const float d[3], int substeps,
                                               float start_t) {
    const vhx::SkipGrid g = vhx::skip_grid(Y.occ, Y.trace.size, kSub > 0 ? kSub : substeps);
    vhx::Skip<L> m;
    vhx::skip_init<kStartForm>(m, o, d, g, start_t);
    if constexpr (kSub > 0) {
        skip_run_fixed<kSub>(m, g, Y.trace.max_iters);
    } else {
        vhx::SkipStopAtHit stop;
        vhx::skip_run(m, g, Y.trace.max_iters, stop);
    }
    return vhx::skip_hit_of(m, Y.colors, g.size);
}

// The skip tracer's frame of this thread's pixel.  The window (layer 0, of
// kDepth levels) starts from the start map with kStart, else at its entry;
// the rings (of kDepth or kDepth - 1 levels) from the camera with kInside
// (a ray that hit in a finer layer skips them: the reference's start_t =
// 1e9), else at their entry.  kSub substeps a body iteration (0:
// `substeps`).  What the pixel holds between layers is its entry of the
// block's Pixels, as in far_frame.
template <bool kStart, bool kInside, int kDepth, int kSub>
__device__ __forceinline__ void far_skip_frame(const FarParams& P, int substeps,
                                               const float* __restrict__ start, int start_tile,
                                               int start_stride, float* __restrict__ rgb_out,
                                               unsigned char* __restrict__ u8_out) {
    __shared__ Pixels px;
    const int t = threadIdx.x;
    int x, y;
    thread_pixel(t, x, y);
    if (x >= P.w || y >= P.h) return;
    px.hit[t] = 0;
    px.dist[t] = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) px.rgb[k][t] = P.bg[k];
    for (int l = 0; l < P.n_layers; ++l) {
        if (kInside && l > 0 && px.hit[t]) break;
        const FarLayer& Y = P.layers[l];
        float o[3], d[3];
        vhx::pixel_ray(Y.origin, Y.right, Y.up, Y.forward, Y.scale, P.cw, P.ch, x, y, o, d);
        vhx::Hit h;
        if (l == 0) {
            float start_t = 0.f;
            if constexpr (kStart) start_t = start[(y / start_tile) * start_stride + x / start_tile];
            h = skip_layer<kStart, kDepth, kSub>(Y, o, d, substeps, start_t);
        } else if (kDepth > 1 && Y.trace.n_levels != kDepth) {
            h = skip_layer<kInside, (kDepth > 1 ? kDepth - 1 : 1), kSub>(Y, o, d, substeps, 0.f);
        } else {
            h = skip_layer<kInside, kDepth, kSub>(Y, o, d, substeps, 0.f);
        }
        if (h.hit) {
            const float hd = __fmul_rn(vhx::ray_length(h.point, o), Y.factor);
            // the nearest hit in world voxels; a tie keeps the finer layer's
            if (!px.hit[t] || hd < px.dist[t]) {
                float rgb[3];
                vhx::shade_hit(h, Y.palette, Y.n_colors, P.bg, rgb);
                px.hit[t] = 1;
                px.dist[t] = hd;
#pragma unroll
                for (int k = 0; k < 3; ++k) px.rgb[k][t] = rgb[k];
            }
        }
    }
    const long long r = (long long)y * P.w + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (rgb_out) rgb_out[3 * r + k] = px.rgb[k][t];
        if (u8_out) u8_out[3 * r + k] = vhx::to_u8(px.rgb[k][t]);
    }
}

// The skip tracer's frame: layers of kDepth or kDepth - 1 levels, their
// `occ` the skip rows (far_skip_frame)
template <bool kStart, bool kInside, int kDepth, int kSub>
__global__ void __launch_bounds__(THREADS)
far_skip_kernel(const __grid_constant__ FarParams P, int substeps,
                const float* __restrict__ start, int start_tile, int start_stride,
                float* __restrict__ rgb_out, unsigned char* __restrict__ u8_out) {
    far_skip_frame<kStart, kInside, kDepth, kSub>(P, substeps, start, start_tile, start_stride,
                                                  rgb_out, u8_out);
}

using FarSkipKernel = void (*)(const FarParams, int, const float*, int, int, float*,
                               unsigned char*);

// The instance of far_skip_kernel for a launch of the window's depth L
template <bool kStart, int L>
FarSkipKernel far_skip_instance(const FarParams& P, int substeps) {
    constexpr int F = VIEW_SUBSTEPS;
    if (P.inside) return substeps == F ? far_skip_kernel<kStart, true, L, F>
                                       : far_skip_kernel<kStart, true, L, 0>;
    return substeps == F ? far_skip_kernel<kStart, false, L, F>
                         : far_skip_kernel<kStart, false, L, 0>;
}

bool bad_far(const FarParams& P, const float* start, int start_tile) {
    return P.n_layers < 1 || P.n_layers > VHX_FAR_MAX_LAYERS || P.w < 1 || P.h < 1 ||
           (start && start_tile < 1) || (P.h + WARP_H - 1) / WARP_H > 65535;
}

}  // namespace

extern "C" int vhx_far_params_size() { return (int)sizeof(FarParams); }

// The frame under the skip tracer, as vhx_render_far_start: each layer's
// `occ` its skip rows (16 B aligned), `substeps` >= 1 substeps a body
// iteration and its trace.max_iters body iterations a ray; the window's
// pyramid of L levels (1 .. VHX_SKIP_MAX_LEVELS) picks the instance, and
// every ring has L or L - 1 levels.
extern "C" cudaError_t vhx_render_far_skip(const FarParams* params, int substeps,
                                           const float* start, int start_tile, float* rgb,
                                           void* u8, int device, cudaStream_t stream) {
    const FarParams& P = *params;
    if (bad_far(P, start, start_tile) || substeps < 1) return cudaErrorInvalidValue;
    const int depth = P.layers[0].trace.n_levels;
    for (int l = 0; l < P.n_layers; ++l) {
        const int n = P.layers[l].trace.n_levels;
        if ((n != depth && n != depth - 1) || n < 1 || P.layers[l].n_colors < 1 ||
            !vhx::skip_rows_aligned(P.layers[l].occ))
            return cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const dim3 grid((P.w + BLOCK_W - 1) / BLOCK_W, (P.h + WARP_H - 1) / WARP_H);
    auto* out = static_cast<unsigned char*>(u8);
    const int stride = start ? (P.w + start_tile - 1) / start_tile : 0;
    return vhx::skip_depth(depth, [&](auto depth_of) {
        constexpr int L = decltype(depth_of)::value;
        if (start) {
            const FarSkipKernel kernel = far_skip_instance<true, L>(P, substeps);
            kernel<<<grid, THREADS, 0, stream>>>(P, substeps, start, start_tile, stride, rgb,
                                                 out);
        } else {
            const FarSkipKernel kernel = far_skip_instance<false, L>(P, substeps);
            kernel<<<grid, THREADS, 0, stream>>>(P, substeps, nullptr, 1, 0, rgb, out);
        }
        return cudaGetLastError();
    });
}
extern "C" int vhx_far_max_layers() { return VHX_FAR_MAX_LAYERS; }

// The frame into rgb (f32 [h, w, 3]) or u8.  With `start` (f32, one value a
// `start_tile` x `start_tile` tile of pixels, ceil(w / start_tile) a row),
// the window's rays start at least their tile's value along (the window
// renderer's beam prepass); the rings keep their own starts.
extern "C" cudaError_t vhx_render_far_start(const FarParams* params, const float* start,
                                            int start_tile, float* rgb, void* u8, int device,
                                            cudaStream_t stream) {
    const FarParams& P = *params;
    if (P.n_layers < 1 || P.n_layers > VHX_FAR_MAX_LAYERS || P.w < 1 || P.h < 1 ||
        (start && start_tile < 1))
        return cudaErrorInvalidValue;
    for (int l = 0; l < P.n_layers; ++l)
        if (P.layers[l].trace.n_levels < 1 || P.layers[l].trace.n_levels > VHX_MAX_LEVELS ||
            P.layers[l].n_colors < 1)
            return cudaErrorInvalidValue;
    const dim3 grid((P.w + BLOCK_W - 1) / BLOCK_W, (P.h + WARP_H - 1) / WARP_H);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    auto* out = static_cast<unsigned char*>(u8);
    if (start)
        far_start_kernel<<<grid, THREADS, 0, stream>>>(P, start, start_tile,
                                                       (P.w + start_tile - 1) / start_tile, rgb,
                                                       out);
    else
        far_kernel<<<grid, THREADS, 0, stream>>>(P, rgb, out);
    return cudaGetLastError();
}

extern "C" cudaError_t vhx_render_far(const FarParams* params, float* rgb, void* u8, int device,
                                      cudaStream_t stream) {
    return vhx_render_far_start(params, nullptr, 1, rgb, u8, device, stream);
}
