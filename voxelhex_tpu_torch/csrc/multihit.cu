// The multi-hit march: one thread per ray records the first K occupied
// voxels along its ray, in one loop.
//
// Replaces the XLA programs of the soft renderer's march
// (`make_multihit_tracer` / `trace_hits_compacted` / `_hits_body`,
// voxelhex_tpu/diff/soft.py:108, :286, :404), which have no Pallas source.
// Each thread runs the automaton of traverse.cuh (`vhx::init`, `vhx::run`)
// once: on a hit the policy `RecordHits` records the voxel and its distance
// at the ray's cursor, clears the voxel's bit in the register words and
// lets the loop step on from the same cell, as `_hit_step` (soft.py:189)
// does between the reference's rounds.  Nothing returns between hits, so a
// warp pays its lanes' longest march, not the longest march to a first hit
// plus the longest one after it.  A ray has K * max_iters automaton steps in
// all (a hit's step included), the reference's global budget; the
// reference spends it in lock-step rounds of 14 with compaction, which give
// the same hits unless a ray comes near the budget (the bench frame needs
// at most a few dozen steps a ray).
//
// Outputs, the reference's types and layout: count int32 [R], voxels int32
// [R, K, 3] (-1 in an empty slot), dists f32 [R, K] (inf in an empty slot).
// A distance is |point - o| as XLA:CPU computes the reference's norm:
// fma(z, z, fma(y, y, x * x)) and a correctly rounded root.  A ray writes
// each hit when it happens, and its count and empty slots when it ends.
//
// What bounds it on the H100: neither bytes nor arithmetic, as for the
// single-hit traversal: a ray reads 24 B and the 2.1 MB pyramid (L2
// resident), and writes 4 + 16 K B; its loop is a chain of dependent steps
// whose length differs from ray to ray (4.6 on average at the bench pose,
// at most 61), and a warp issues every branch of the automaton that one
// of its lanes takes in a step.  Persistent warps that refill idle lanes
// from a ray counter (Aila and Laine, HPG 2009) were timed on the card and
// were slower at every refill threshold (PERF.md), so the grid is one
// thread per ray.
//
// Two more forms, each its own instance, so that `multihit_kernel` compiles
// as it did:
//   start  each ray starts at least its start along (traverse.cuh init's
//          start form, the reference's `trace.init(tree, o, d, st)`,
//          soft.py:404-419): the beam prepass's start map, one value a
//          tile x tile pixel tile of a frame of width `start_w` whose
//          rays are the R rays in row order (soft.py `beam=`), or one a
//          ray (tile 1, width R).  A ray whose start is at or past its box
//          exit is dead, with no hits.
//   skip   the skip tracer (skip.cuh) over the skip rows of a grid of L
//          levels, an instance a depth, with or without a start, as
//          `_hit_step`'s skip branch (soft.py:204-226) drives it: a hit
//          ends its body iteration, the row of the hit voxel is fetched as
//          every body's end fetches it, and only then is the voxel's bit
//          cleared in the row's level-0 pair; the ray goes on from the hit
//          voxel.  A ray has K * max_iters body iterations in all.

#include "skip.cuh"

namespace {

constexpr int THREADS = 128;

// The voxel a march stands on at a hit
__device__ __forceinline__ void hit_voxel(const vhx::March& m, int v[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = (int)m.tmin[c];
}
template <int L>
__device__ __forceinline__ void hit_voxel(const vhx::Skip<L>& m, int v[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = m.v[c];
}

// What a record does after a hit that is not the K-th: the stack march
// clears the voxel's bit in its register words; the skip march clears it
// after its row fetch (skip.cuh skip_run)
__device__ __forceinline__ void after_record(vhx::March& m) { vhx::clear_hit_voxel(m); }
template <int L>
__device__ __forceinline__ void after_record(vhx::Skip<L>&) {}

// The multi-hit policy of `vhx::run` and `vhx::skip_run`: record each hit
// at the ray's cursor; stop at the K-th, else step on (the stack march
// clears the voxel's bit, the skip march fetches its row first).
template <class State>
struct RecordHits {
    const float* o;  // the ray's origin
    int* vox;        // the ray's K slots of voxels and distances
    float* dist;
    int K;
    int n;           // hits recorded
    __device__ __forceinline__ bool on_hit(State& m) {
        int v[3];
        hit_voxel(m, v);
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            vox[3 * n + c] = v[c];
            x[c] = __fsub_rn(m.p[c], o[c]);
        }
        dist[n] = __fsqrt_rn(__fmaf_rn(x[2], x[2], __fmaf_rn(x[1], x[1], __fmul_rn(x[0], x[0]))));
        n += 1;
        if (n == K) return true;
        after_record(m);
        return false;
    }
};

// Where the start form's rays start: ray r is pixel (r % w, r / w) of a
// frame of width w, and its start is its tile's value of `map`, `stride`
// tiles a row.
struct RayStarts {
    const float* __restrict__ map;
    int tile;
    int w;
    int stride;
};

// One ray's march: the stack automaton over the pyramid's word pairs with
// L = 0, or the skip tracer over the skip rows (`grid_words`) of a grid of
// L levels; with kStart, from its start.
template <bool kStart, int L>
__device__ __forceinline__ void multihit_ray(const float* __restrict__ origins,
                                             const float* __restrict__ dirs,
                                             const uint2* __restrict__ grid_words,
                                             const TraceParams& P, const int2* levels,
                                             const RayStarts& st, int substeps, int r, int K,
                                             int* __restrict__ count_out,
                                             int* __restrict__ voxels_out,
                                             float* __restrict__ dists_out) {
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        o[c] = origins[3 * (long long)r + c];
        d[c] = dirs[3 * (long long)r + c];
    }
    float start_t = 0.f;
    if constexpr (kStart)
        start_t = st.map[(r / st.w) / st.tile * st.stride + (r % st.w) / st.tile];
    int n;
    int* vox = voxels_out + (long long)r * K * 3;
    float* dist = dists_out + (long long)r * K;
    if constexpr (L > 0) {
        const vhx::SkipGrid g = vhx::skip_grid(grid_words, P.size, substeps);
        vhx::Skip<L> m;
        vhx::skip_init<kStart>(m, o, d, g, start_t);
        RecordHits<vhx::Skip<L>> rec{o, vox, dist, K, 0};
        vhx::skip_run(m, g, K * P.max_iters, rec);
        n = rec.n;
    } else {
        const vhx::Grid g{grid_words, levels, P.n_levels, P.size, P.n_blocks};
        vhx::March m;
        vhx::init<kStart>(m, o, d, g, start_t);
        RecordHits<vhx::March> rec{o, vox, dist, K, 0};
        vhx::run(m, g, K * P.max_iters, rec);
        n = rec.n;
    }
    count_out[r] = n;
    for (int k = n; k < K; ++k) {
        vox[3 * k] = vox[3 * k + 1] = vox[3 * k + 2] = -1;
        dist[k] = __int_as_float(0x7f800000);  // inf
    }
}

__global__ void __launch_bounds__(THREADS)
multihit_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const uint2* __restrict__ occ, const TraceParams P, int R, int K,
                int* __restrict__ count_out, int* __restrict__ voxels_out,
                float* __restrict__ dists_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P, levels);
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    multihit_ray<false, 0>(origins, dirs, occ, P, levels, RayStarts{}, 0, r, K, count_out,
                           voxels_out, dists_out);
}

// The start form (L = 0) and the skip forms (a grid of L levels)
template <bool kStart, int L>
__global__ void __launch_bounds__(THREADS)
multihit_form_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const uint2* __restrict__ grid_words, const TraceParams P,
                     const RayStarts st, int substeps, int R, int K,
                     int* __restrict__ count_out, int* __restrict__ voxels_out,
                     float* __restrict__ dists_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    if constexpr (L == 0) vhx::load_levels(P, levels);
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    multihit_ray<kStart, L>(origins, dirs, grid_words, P, levels, st, substeps, r, K,
                                count_out, voxels_out, dists_out);
}

template <bool kStart, int L>
cudaError_t launch(int blocks, const float* origins, const float* dirs, const uint2* words,
                   const TraceParams& P, const RayStarts& st, int substeps, int R, int K,
                   int* count, int* voxels, float* dists, cudaStream_t stream) {
    if constexpr (!kStart && L == 0)
        multihit_kernel<<<blocks, THREADS, 0, stream>>>(origins, dirs, words, P, R, K, count,
                                                        voxels, dists);
    else
        multihit_form_kernel<kStart, L><<<blocks, THREADS, 0, stream>>>(
            origins, dirs, words, P, st, substeps, R, K, count, voxels, dists);
    return cudaGetLastError();
}

}  // namespace

extern "C" int vhx_multihit_params_size() { return (int)sizeof(TraceParams); }

namespace {

// The march of either tracer (see the C entries below): `substeps` 0 marches
// the stack automaton over the word pairs `words`, >= 1 the skip tracer over
// the skip rows `words`.
cudaError_t march_entry(const float* origins, const float* dirs, const void* grid_words,
                        const TraceParams* params, int n_rays, int max_hits, int substeps,
                        const float* start, int start_tile, int start_w, int* count,
                        int* voxels, float* dists, int device, cudaStream_t stream) {
    const int max_levels = substeps ? VHX_SKIP_MAX_LEVELS : VHX_MAX_LEVELS;
    if (params->n_levels < 1 || params->n_levels > max_levels || max_hits < 1 ||
        (long long)max_hits * params->max_iters > 0x7fffffff ||
        (start && (start_tile < 1 || start_w < 1)) ||
        (substeps && !vhx::skip_rows_aligned(grid_words)))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    const auto* words = static_cast<const uint2*>(grid_words);
    const RayStarts st{start, start_tile, start_w,
                       start ? (start_w + start_tile - 1) / start_tile : 0};
    const TraceParams& P = *params;
    if (substeps)
        return vhx::skip_depth(P.n_levels, [&](auto depth) {
            constexpr int L = decltype(depth)::value;
            return start ? launch<true, L>(blocks, origins, dirs, words, P, st, substeps, n_rays,
                                           max_hits, count, voxels, dists, stream)
                         : launch<false, L>(blocks, origins, dirs, words, P, st, substeps, n_rays,
                                            max_hits, count, voxels, dists, stream);
        });
    return start ? launch<true, 0>(blocks, origins, dirs, words, P, st, 0, n_rays, max_hits,
                                   count, voxels, dists, stream)
                 : launch<false, 0>(blocks, origins, dirs, words, P, st, 0, n_rays, max_hits,
                                    count, voxels, dists, stream);
}

}  // namespace

// The march of the stack automaton over `occ_pairs`; with `start` (f32,
// one value a `start_tile` x `start_tile` tile of a frame of width
// `start_w`, ceil(start_w / start_tile) a row), ray r starts at least its
// tile's value along.
extern "C" cudaError_t vhx_multihit_start(const float* origins, const float* dirs,
                                          const void* occ_pairs, const TraceParams* params,
                                          int n_rays, int max_hits, const float* start,
                                          int start_tile, int start_w, int* count, int* voxels,
                                          float* dists, int device, cudaStream_t stream) {
    return march_entry(origins, dirs, occ_pairs, params, n_rays, max_hits, 0, start,
                       start_tile, start_w, count, voxels, dists, device, stream);
}

// The skip tracer's march: as vhx_multihit_start, over `rows` (the grid's
// skip rows, u32 [ceil(S / 4)^3, 2 n_levels], 16 B aligned), `substeps` >=
// 1 substeps a body iteration and max_hits * params->max_iters body
// iterations a ray; the instance of the grid's depth.
extern "C" cudaError_t vhx_multihit_skip(const float* origins, const float* dirs,
                                         const void* rows, const TraceParams* params, int n_rays,
                                         int max_hits, int substeps, const float* start,
                                         int start_tile, int start_w, int* count, int* voxels,
                                         float* dists, int device, cudaStream_t stream) {
    if (substeps < 1) return cudaErrorInvalidValue;
    return march_entry(origins, dirs, rows, params, n_rays, max_hits, substeps, start,
                       start_tile, start_w, count, voxels, dists, device, stream);
}

extern "C" cudaError_t vhx_multihit(const float* origins, const float* dirs, const void* occ_pairs,
                                    const TraceParams* params, int n_rays, int max_hits,
                                    int* count, int* voxels, float* dists, int device,
                                    cudaStream_t stream) {
    return vhx_multihit_start(origins, dirs, occ_pairs, params, n_rays, max_hits, nullptr, 1, 1,
                              count, voxels, dists, device, stream);
}
