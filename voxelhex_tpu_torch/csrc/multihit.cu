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

#include "traverse.cuh"

namespace {

constexpr int THREADS = 128;

// The multi-hit policy of `vhx::run`: record each hit at the ray's cursor;
// stop at the K-th, else clear the voxel's bit and step on.
struct RecordHits {
    const float* o;  // the ray's origin
    int* vox;        // the ray's K slots of voxels and distances
    float* dist;
    int K;
    int n;           // hits recorded
    __device__ __forceinline__ bool on_hit(vhx::March& m) {
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            vox[3 * n + c] = (int)m.tmin[c];
            x[c] = __fsub_rn(m.p[c], o[c]);
        }
        dist[n] = __fsqrt_rn(__fmaf_rn(x[2], x[2], __fmaf_rn(x[1], x[1], __fmul_rn(x[0], x[0]))));
        n += 1;
        if (n == K) return true;
        vhx::clear_hit_voxel(m);
        return false;
    }
};

__global__ void __launch_bounds__(THREADS)
multihit_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const uint2* __restrict__ occ, const TraceParams P, int R, int K,
                int* __restrict__ count_out, int* __restrict__ voxels_out,
                float* __restrict__ dists_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P, levels);
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        o[c] = origins[3 * (long long)r + c];
        d[c] = dirs[3 * (long long)r + c];
    }
    const vhx::Grid g{occ, levels, P.n_levels, P.size, P.n_blocks};
    vhx::March m;
    vhx::init(m, o, d, g);
    RecordHits rec{o, voxels_out + (long long)r * K * 3, dists_out + (long long)r * K, K, 0};
    vhx::run(m, g, K * P.max_iters, rec);
    count_out[r] = rec.n;
    for (int k = rec.n; k < K; ++k) {
        rec.vox[3 * k] = rec.vox[3 * k + 1] = rec.vox[3 * k + 2] = -1;
        rec.dist[k] = __int_as_float(0x7f800000);  // inf
    }
}

}  // namespace

extern "C" int vhx_multihit_params_size() { return (int)sizeof(TraceParams); }

extern "C" cudaError_t vhx_multihit(const float* origins, const float* dirs, const void* occ_pairs,
                                    const TraceParams* params, int n_rays, int max_hits,
                                    int* count, int* voxels, float* dists, int device,
                                    cudaStream_t stream) {
    if (params->n_levels < 1 || params->n_levels > VHX_MAX_LEVELS || max_hits < 1 ||
        (long long)max_hits * params->max_iters > 0x7fffffff)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    multihit_kernel<<<blocks, THREADS, 0, stream>>>(
        origins, dirs, static_cast<const uint2*>(occ_pairs), *params, n_rays, max_hits, count,
        voxels, dists);
    return cudaGetLastError();
}
