// The depth prepass: a frame's rays traced at 1 / 2^k of its resolution,
// then at each finer level up to 1 / 2, each level starting its rays from
// the depths of the level before, and the start map of the full-resolution
// frame from the last level.
//
// Replaces the level loop of the reference's `_render_impl` (voxelhex_tpu/
// render/bitgrid.py:2857-2885) with its `_depth_start` (:1198), XLA
// programs on the path of the ported traversal (voxelhex_tpu/ops/
// traverse_pallas.py).  A pixel of a level: its ray from the camera params
// at the level's resolution; its start from the coarser level's depth, the
// least of the 2 x 2 edge-clamped neighbourhood of its coarse pixel, less
// 2, at least 0 (none at the coarsest level); the automaton (traverse.cuh,
// the renderer's settings); its depth |p - o| (frame.cuh ray_length, the
// reference's norm) or 1e8 on a miss.  The start map takes the same 2 x 2
// rule over the finest coarse level (level 1), one value a 2 x 2 tile of
// the frame, which the frame kernel reads with a tile of 2 (frame.cu).
// The starts are not conservative: a frame with the prepass may differ
// from the plain frame, as the reference's does.
//
// Kernel: prepass_frame_kernel, the whole prepass in one launch.  A block
// is a tile of one level (16 x 8 pixels, frame.cuh's 4 x 8 warp tiles),
// the coarsest level's tiles first.  A block takes its tile from a ticket
// counter, so a tile's ticket is higher than those of the tiles it waits
// for: the (at most 2 x 2) coarser tiles under it, whose flags say their
// depths are written.  A level-1 tile also writes the start map's cells of
// its pixels: a cell whose 2 x 2 pixels are all its own is stored, the
// others (its last row and column) start at +inf, which its flag then
// says, and take each tile's least start by atomicMin, after the flags of
// the neighbours whose cells it reaches (left, above, above left).
//
// What bounds it: not the card's throughput (1.1 M automaton steps at
// 1080p and 2 levels) but the chain of the longest rays, about 1 us a step
// for a warp alone on its SM: at the bench pose a level-2 ray of 56 steps
// under a level-1 ray of 43 in the same neighbourhood, so no tiling of the
// levels runs the two side by side (tools/prepass_chain.py).  One launch
// with per-tile flags keeps that chain and drops what a launch a level
// adds to it: each level's wait for the last warp of the level before,
// two more launches, and the start map's pass over level 1.
// Tiles come in ticket order, not blockIdx order, so a block only ever
// waits for tiles that running blocks hold: no deadlock whatever order the
// card starts blocks in.  The flags hold the launch's epoch (the
// wrapper's, one a launch), so they need no clearing; the block that takes
// the last ticket puts the counter back to 0 for the next launch.  A
// start cell's value is max(min(d) - 2, 0) over its 2 x 2 pixels, and as
// max(x - 2, 0) is monotone it is the least of that value over the pixels
// of each tile, so the atomicMin of the values' bits (non-negative floats
// order as their bits) gives the plain start bit for bit.
//
// A prepass of more levels than a launch takes (VHX_PREPASS_MAX_LEVELS) is
// a chain of launches, each of at most that many levels, the coarsest
// first: a launch's last level writes a start map as level 1 does, and the
// next launch's coarsest level starts its rays from it (kChain), as a
// level starts from the depths of the level before.  The one launch of a
// prepass that fits keeps its instance (kChain false) unchanged.
//
// Under the reference renderer's `tracer="skip"` its levels march the skip
// tracer (`self._trace`, bitgrid.py:1578, :1597), so a level's depths are
// those of the skip tracer's hit points: the kernel's instance L >= 1 over
// the skip rows of a grid of L levels (skip.cuh); L = 0 is the stack
// automaton's.

#include <cstring>

#include "frame.cuh"
#include "skip.cuh"

struct PrepassParams {
    TraceParams trace;
    FrameCam cam;  // the camera params at this level's resolution
    float cw, ch;  // 1 / w * 2 and 1 / h * 2, folded as the plain raygen folds them
    int w, h;      // this level's resolution
};

// the levels one launch of prepass_frame_kernel takes
#define VHX_PREPASS_MAX_LEVELS 8

namespace {

constexpr int THREADS = vhx::FRAME_THREADS;
constexpr float MISS_DEPTH = 1e8f;
constexpr float MARGIN = 2.f;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// One level of prepass_frame_kernel: its camera, its depths and its tiles
struct FrameLevel {
    FrameCam cam;
    float cw, ch;
    int w, h;
    int tiles_x;   // 16 x 8 tiles a row
    int first;     // the ticket of its first tile
    float* depth;  // [h, w]
};

struct PrepassFrame {
    TraceParams trace;
    FrameLevel lv[VHX_PREPASS_MAX_LEVELS];  // the coarsest level first, level 1 last
    int n;                                  // levels
    int n_blocks;                           // tickets in all
    float* start;                           // [h, w] of level 1
    int* sync;      // the ticket counter, then a flag a level tile by ticket
    int epoch;      // this launch's, never 0
};

// max(min(d[y, x], d[y + 1, x], d[y, x + 1], d[y + 1, x + 1]) - 2, 0) over
// the [h, w] depths `d`, the last row and column repeated; read through
// the L2 (__ldcg): another SM wrote them in this launch, so a line in this
// SM's L1 may be older
__device__ __forceinline__ float start_from(const float* __restrict__ d, int w, int h, int x,
                                            int y) {
    const int x1 = x + 1 < w ? x + 1 : x, y1 = y + 1 < h ? y + 1 : y;
    const float a = vhx::xla_min(__ldcg(&d[y * w + x]), __ldcg(&d[y1 * w + x]));
    const float b = vhx::xla_min(__ldcg(&d[y * w + x1]), __ldcg(&d[y1 * w + x1]));
    return vhx::xla_max(__fsub_rn(vhx::xla_min(a, b), MARGIN), 0.f);
}

// The depth of pixel (x, y)'s ray (the camera `cam` at w x h), started at
// `start_t` when `use_start`.  With L >= 1, `occ` holds the skip rows of a
// grid of L levels and the ray marches the skip tracer, `substeps`
// substeps a body iteration; with kOpt the stack automaton follows `opt`.
template <int L, bool kOpt>
__device__ __forceinline__ float pixel_depth(const uint2* __restrict__ occ, const int2* levels,
                                             const TraceParams& T, const FrameCam& cam, float cw,
                                             float ch, int x, int y, float start_t,
                                             bool use_start, int substeps,
                                             const TraceOptions& opt) {
    float o[3], d[3];
    vhx::pixel_ray(cam.origin, cam.right, cam.up, cam.forward, cam.scale, cw, ch, x, y, o, d);
    if constexpr (L > 0) {
        const vhx::SkipGrid g = vhx::skip_grid(occ, T.size, substeps);
        vhx::Skip<L> m;
        vhx::skip_init<true>(m, o, d, g, start_t, use_start);
        vhx::SkipStopAtHit stop;
        vhx::skip_run(m, g, T.max_iters, stop);
        return m.hit ? vhx::ray_length(m.p, o) : MISS_DEPTH;
    } else {
        const vhx::Grid g{occ, levels, T.n_levels, T.size, T.n_blocks};
        vhx::March m;
        vhx::init<true>(m, o, d, g, start_t, use_start);
        vhx::StopAtHit stop;
        vhx::run<vhx::StopAtHit, vhx::ADVANCE_SUBSTEPS, kOpt>(m, g, T.max_iters, stop, opt);
        return m.hit ? vhx::ray_length(m.p, o) : MISS_DEPTH;
    }
}

// The flag of ticket t
__device__ __forceinline__ int* flag(const PrepassFrame& F, int t) { return F.sync + 1 + t; }

// Each thread with a ticket `t` >= 0 waits until its flag holds the
// epoch, then the block goes on: that tile's depths (or its start cells)
// are then readable through the L2.  A tile takes microseconds; a wait of
// seconds means a broken protocol, and traps rather than hanging the card.
constexpr long long MAX_POLLS = 1LL << 25;

__device__ __forceinline__ void wait_for(const PrepassFrame& F, int t) {
    if (t >= 0) {
        const volatile int* f = flag(F, t);
        for (long long k = 0; *f != F.epoch; ++k) {
            if (k == MAX_POLLS) __trap();
            __nanosleep(64);
        }
    }
    __threadfence();
    __syncthreads();
}

// max(x - 2, 0) as an int whose order is the floats' (x - 2 is never -0,
// so the result is +0 or more), a NaN as -1, which is a NaN read as a
// float and the least int: the min of these over a cell's pixels is the
// bits of start_from's value
__device__ __forceinline__ int start_bits(float d) {
    const float s = vhx::xla_max(__fsub_rn(d, MARGIN), 0.f);
    return s != s ? -1 : __float_as_int(s);
}

// With kChain, the coarsest level's rays start from `coarse`, the start map
// [h / 2, w / 2] of the launch before (a cell a 2 x 2 tile of its pixels).
// With kOpt (L = 0), the stack automaton follows `opt` (traverse.cuh
// TraceOptions: the renderer's options, which the reference's prepass
// levels march too).
template <int L, bool kChain, bool kOpt>
__global__ void __launch_bounds__(THREADS)
prepass_frame_kernel(const uint2* __restrict__ occ, const __grid_constant__ PrepassFrame F,
                     int substeps, const float* __restrict__ coarse, const TraceOptions opt) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    __shared__ int ticket;
    __shared__ float tile_depth[vhx::WARP_H][vhx::BLOCK_W];
    if (threadIdx.x == 0) {
        const int t = atomicAdd(F.sync, 1);
        if (t == F.n_blocks - 1) atomicExch(F.sync, 0);  // every ticket taken: for the next launch
        ticket = t;
    }
    if constexpr (L == 0)
        vhx::load_levels(F.trace, levels);
    else
        __syncthreads();
    const int t = ticket;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int li = 0;
    while (li + 1 < F.n && t >= F.lv[li + 1].first) ++li;
    const FrameLevel& P = F.lv[li];
    const bool finest = li == F.n - 1;
    const int tile = t - P.first;
    const int tx = tile % P.tiles_x, ty = tile / P.tiles_x;
    const int x0 = tx * vhx::BLOCK_W, y0 = ty * vhx::WARP_H;
    const int x1 = imin(x0 + vhx::BLOCK_W, P.w), y1 = imin(y0 + vhx::WARP_H, P.h);
    // the start cells of level 1 that this tile's pixels reach: its own,
    // and a column left and a row above of its neighbours'
    auto owns = [&](int x, int y) { return x >= x0 && x < x1 && y >= y0 && y < y1; };
    auto interior = [&](int x, int y) {
        return owns(imin(x + 1, P.w - 1), imin(y + 1, P.h - 1));
    };
    // the ticket this thread waits for, or -1: threads 0-2 a neighbour's,
    // threads 3-6 a coarser tile's
    int wait = -1;
    const int tid = threadIdx.x;
    if (finest) {
        // the start cells this tile owns that other tiles reach too begin
        // at +inf, before any tile's atomicMin: its flag says so
        for (int i = tid; i < vhx::BLOCK_W * vhx::WARP_H; i += THREADS) {
            const int x = x0 + i % vhx::BLOCK_W, y = y0 + i / vhx::BLOCK_W;
            if (owns(x, y) && !interior(x, y)) F.start[y * P.w + x] = __int_as_float(0x7F800000);
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(flag(F, t), F.epoch);
        // the neighbours left, above and above left, whose cells this tile
        // reaches
        if (tid == 0 && tx > 0) wait = t - 1;
        if (tid == 1 && ty > 0) wait = t - P.tiles_x;
        if (tid == 2 && tx > 0 && ty > 0) wait = t - P.tiles_x - 1;
    }
    const int x = x0 + warp * vhx::WARP_W + lane % vhx::WARP_W;
    const int y = y0 + lane / vhx::WARP_W;
    float depth = MISS_DEPTH;
    // where the depth goes: the stack instance takes the addresses before
    // the march, the skip instances after it; each form is the faster of
    // the two for its instance, by a few percent, in same-call turns
    // (ptxas schedules the march's loop otherwise)
    float* out = nullptr;
    float* slot = nullptr;
    if constexpr (L == 0) {
        out = x < P.w && y < P.h ? P.depth + y * P.w + x : nullptr;
        slot = &tile_depth[y - y0][x - x0];
    }
    if (li > 0) {
        // the coarser level's pixels [x / 2, x / 2 + 1] x [y / 2, y / 2 + 1]
        // of the tile's pixels, clamped: at most 2 x 2 of its tiles
        const FrameLevel& C = F.lv[li - 1];
        const int cx = x0 / 2, cy = y0 / 2;
        const int cx0 = cx / vhx::BLOCK_W, cy0 = cy / vhx::WARP_H;
        const int cx1 = imin(cx + vhx::BLOCK_W / 2, C.w - 1) / vhx::BLOCK_W;
        const int cy1 = imin(cy + vhx::WARP_H / 2, C.h - 1) / vhx::WARP_H;
        const int a = cx0 + (tid - 3) % 2, b = cy0 + (tid - 3) / 2;
        if (tid >= 3 && tid < 7 && a <= cx1 && b <= cy1) wait = C.first + b * C.tiles_x + a;
        wait_for(F, wait);
        if (x < P.w && y < P.h)
            depth = pixel_depth<L, kOpt>(
                occ, levels, F.trace, P.cam, P.cw, P.ch, x, y,
                start_from(C.depth, C.w, C.h, x / 2, y / 2), true, substeps, opt);
    } else {
        if (finest) wait_for(F, wait);
        if (x < P.w && y < P.h) {
            if constexpr (kChain)
                depth = pixel_depth<L, kOpt>(occ, levels, F.trace, P.cam, P.cw, P.ch, x, y,
                                             coarse[(y / 2) * (P.w / 2) + x / 2], true,
                                             substeps, opt);
            else
                depth = pixel_depth<L, kOpt>(occ, levels, F.trace, P.cam, P.cw, P.ch, x, y,
                                             0.f, false, substeps, opt);
        }
    }
    if constexpr (L == 0) {
        if (out) *out = depth;
    } else if (x < P.w && y < P.h) {
        P.depth[y * P.w + x] = depth;
    }
    if (!finest) {
        // a coarser level's tile: done
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(flag(F, t), F.epoch);
        return;
    }
    // level 1: the start map's cells from the tile's depths, each cell the
    // least of its 2 x 2 edge-clamped pixels less 2: a cell of this tile's
    // alone stored, one that other tiles reach too taken by atomicMin
    if constexpr (L == 0)
        *slot = depth;
    else
        tile_depth[y - y0][x - x0] = depth;
    __syncthreads();
    constexpr int CELLS_W = vhx::BLOCK_W + 1, CELLS_H = vhx::WARP_H + 1;
    for (int i = tid; i < CELLS_W * CELLS_H; i += THREADS) {
        const int cx = x0 - 1 + i % CELLS_W, cy = y0 - 1 + i / CELLS_W;
        if (cx < 0 || cy < 0 || cx >= x1 || cy >= y1) continue;
        const int nx = imin(cx + 1, P.w - 1), ny = imin(cy + 1, P.h - 1);
        const float(*d)[vhx::BLOCK_W] = tile_depth;
        if (owns(cx, cy) && interior(cx, cy)) {  // start_from's order
            const float a = vhx::xla_min(d[cy - y0][cx - x0], d[ny - y0][cx - x0]);
            const float b = vhx::xla_min(d[cy - y0][nx - x0], d[ny - y0][nx - x0]);
            F.start[cy * P.w + cx] = vhx::xla_max(__fsub_rn(vhx::xla_min(a, b), MARGIN), 0.f);
            continue;
        }
        int bits = 0x7F800000;
        const int px[2] = {cx, nx}, py[2] = {cy, ny};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int qx = px[k & 1], qy = py[k >> 1];
            if (owns(qx, qy)) bits = imin(bits, start_bits(d[qy - y0][qx - x0]));
        }
        if (bits != 0x7F800000) atomicMin(reinterpret_cast<int*>(&F.start[cy * P.w + cx]), bits);
    }
}

template <int L, bool kOpt = false>
cudaError_t launch_frame(const uint2* occ, const PrepassFrame& F, int substeps,
                         const float* coarse, cudaStream_t stream,
                         const TraceOptions opt = TraceOptions{}) {
    if (coarse)
        prepass_frame_kernel<L, true, kOpt><<<F.n_blocks, THREADS, 0, stream>>>(
            occ, F, substeps, coarse, opt);
    else
        prepass_frame_kernel<L, false, kOpt><<<F.n_blocks, THREADS, 0, stream>>>(
            occ, F, substeps, nullptr, opt);
    return cudaGetLastError();
}

// The tiles of a level of w x h pixels
int tiles_x(int w) { return (w + vhx::BLOCK_W - 1) / vhx::BLOCK_W; }
int tiles_y(int h) { return (h + vhx::WARP_H - 1) / vhx::WARP_H; }

bool bad_level(const PrepassParams& P, int substeps, const void* grid_words,
               const TraceOptions* opts) {
    const int max_levels = substeps ? VHX_SKIP_MAX_LEVELS : VHX_MAX_LEVELS;
    return P.trace.n_levels < 1 || P.trace.n_levels > max_levels || P.w < 1 || P.h < 1 ||
           substeps < 0 || (substeps && opts) ||
           (substeps && !vhx::skip_rows_aligned(grid_words));
}

// The tickets of a prepass of `n` levels whose level 1 is w1 x h1: a tile
// of each level's; -1 if a level would be empty
long long frame_tickets(int w1, int h1, int n) {
    long long tiles = 0;
    for (int k = n; k >= 1; --k) {
        const int w = w1 >> (k - 1), h = h1 >> (k - 1);
        if (w < 1 || h < 1) return -1;
        tiles += (long long)tiles_x(w) * tiles_y(h);
    }
    return tiles;
}

}  // namespace

extern "C" int vhx_prepass_params_size() { return (int)sizeof(PrepassParams); }
extern "C" int vhx_prepass_max_levels() { return VHX_PREPASS_MAX_LEVELS; }

// The int32 words of vhx_prepass's `sync` for `n` levels whose level 1 is
// w1 x h1: the ticket counter and a flag a level tile; -1 if out of range
extern "C" long long vhx_prepass_sync_words(int w1, int h1, int n) {
    if (n < 1 || n > VHX_PREPASS_MAX_LEVELS) return -1;
    const long long tickets = frame_tickets(w1, h1, n);
    return tickets < 0 ? -1 : tickets + 1;
}

// One launch of a chained prepass (vhx_prepass's arguments): with `coarse`
// (f32, the start map that the launch before wrote, [h / 2, w / 2] of
// params[n - 1]), the coarsest level's rays start from it, and `start` is
// the start map of params[0]'s pixels for the next finer level (or the
// frame); without it, vhx_prepass.  With `opts` (`substeps` 0 only), the
// stack automaton follows them (traverse.cuh TraceOptions); null: the
// default options.
extern "C" cudaError_t vhx_prepass_ex(const void* words, const PrepassParams* params, int n,
                                      int substeps, const TraceOptions* opts,
                                      float* const* depths, float* start, const float* coarse,
                                      int* sync, int epoch, int device, cudaStream_t stream) {
    if (n < 1 || n > VHX_PREPASS_MAX_LEVELS || !params || !depths || !start || !sync ||
        epoch == 0)
        return cudaErrorInvalidValue;
    PrepassFrame F;
    F.trace = params[0].trace;
    F.n = n;
    int ticket = 0;
    for (int k = n - 1; k >= 0; --k) {  // the coarsest level first
        const PrepassParams& P = params[k];
        if (bad_level(P, substeps, words, opts) || !depths[k] ||
            memcmp(&P.trace, &F.trace, sizeof(TraceParams)) ||
            (k + 1 < n && (P.w != 2 * params[k + 1].w || P.h != 2 * params[k + 1].h)) ||
            (coarse && k == n - 1 && (P.w % 2 || P.h % 2)))
            return cudaErrorInvalidValue;
        FrameLevel& lv = F.lv[n - 1 - k];
        lv.cam = P.cam;
        lv.cw = P.cw;
        lv.ch = P.ch;
        lv.w = P.w;
        lv.h = P.h;
        lv.tiles_x = tiles_x(P.w);
        lv.first = ticket;
        lv.depth = depths[k];
        const long long tiles = (long long)lv.tiles_x * tiles_y(P.h);
        if (ticket + tiles > (1LL << 30)) return cudaErrorInvalidValue;
        ticket += (int)tiles;
    }
    F.n_blocks = ticket;
    F.start = start;
    F.sync = sync;
    F.epoch = epoch;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const auto* occ = static_cast<const uint2*>(words);
    if (substeps)
        return vhx::skip_depth(F.trace.n_levels, [&](auto depth_of) {
            return launch_frame<decltype(depth_of)::value>(occ, F, substeps, coarse, stream);
        });
    if (opts) return launch_frame<0, true>(occ, F, 0, coarse, stream, *opts);
    return launch_frame<0>(occ, F, 0, coarse, stream);
}

// vhx_prepass_ex with the default options
extern "C" cudaError_t vhx_prepass_chain(const void* words, const PrepassParams* params, int n,
                                         int substeps, float* const* depths, float* start,
                                         const float* coarse, int* sync, int epoch, int device,
                                         cudaStream_t stream) {
    return vhx_prepass_ex(words, params, n, substeps, nullptr, depths, start, coarse, sync, epoch,
                          device, stream);
}

// The whole depth prepass in one launch: `n` levels, params[k] the camera
// of level k + 1 (1 / 2^(k + 1) of the frame; each level twice the next
// coarser one in each dimension), its depths into depths[k] (f32 [h, w]),
// and the start map of the frame, f32 [h, w] of level 1, into `start`.
// `substeps` 0 marches the stack automaton over the pyramid's word pairs
// `words`, >= 1 the skip tracer over the skip rows (16 B aligned), with
// params[0].trace.max_iters steps a ray.  `sync` (vhx_prepass_sync_words
// int32 words, zero when first used) keeps its flags and its ticket
// counter from launch to launch on one stream; `epoch` differs from that
// of every launch before on it and is not 0.
extern "C" cudaError_t vhx_prepass(const void* words, const PrepassParams* params, int n,
                                   int substeps, float* const* depths, float* start, int* sync,
                                   int epoch, int device, cudaStream_t stream) {
    return vhx_prepass_chain(words, params, n, substeps, depths, start, nullptr, sync, epoch,
                             device, stream);
}
