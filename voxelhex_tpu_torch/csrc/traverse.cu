// BitGrid traversal: one thread marches one ray through the occupancy pyramid.
//
// Replaces the TPU kernel `make_kernel` / `traverse_tiles`
// (voxelhex_tpu/ops/traverse_pallas.py:79, :208), and computes what the
// production tracer computes (`make_bitgrid_tracer.trace`,
// voxelhex_tpu/render/bitgrid.py:482-808).  The automaton is
// `vhx::march` in traverse.cuh, shared with the frame kernel (frame.cu),
// which is what renders a frame; this kernel takes rays from memory and
// writes all five per-ray outputs, for callers that trace their own rays.
//
// What bounds it on the H100: neither bytes nor arithmetic.  A ray reads
// 24 B of ray, one 8 B word pair per level change (the 2.1 MB pyramid of
// the benchmark scene stays in the 50 MB L2) and 2 B of color, and writes
// 41 B; its loop is a chain of dependent integer and f32 steps whose length
// differs from ray to ray, so the time is latency and warp divergence.
// The design keeps the whole automaton in registers, reads the pyramid
// through the read-only cache (__ldg), keeps the level table in shared
// memory, and lets every ray stop on its own (no lock-step rounds, so no
// compaction pass is needed).
//
// `traverse_skip_kernel<L, kU8>` traces the same rays with the skip tracer
// (skip.cuh: `make_skip_tracer`, voxelhex_tpu/render/bitgrid.py:859) over
// the skip rows of a grid of L levels, `substeps` substeps a body
// iteration: the reference renderer's `trace` under `tracer="skip"`.
// `traverse_form_kernel<kOpt, kU8>` is the stack automaton under the
// renderer's options read at run time (kOpt: traverse.cuh TraceOptions), or
// over a u8 color grid (kU8: the reference's `color_u8`), or both;
// `traverse_kernel`, the default options over u16 colors, compiles as it
// did.

#include "skip.cuh"

namespace {

// One ray's march into the five outputs
template <bool kOpt, class TColor>
__device__ __forceinline__ void traverse_ray(const float* __restrict__ origins,
                                             const float* __restrict__ dirs,
                                             const uint2* __restrict__ occ,
                                             const TColor* __restrict__ colors,
                                             const TraceParams& P, const TraceOptions& opt,
                                             const int2* levels, int R,
                                             unsigned char* __restrict__ hit_out,
                                             int* __restrict__ voxel_out,
                                             int* __restrict__ hvox_out,
                                             float* __restrict__ point_out,
                                             float* __restrict__ hnormal_out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        o[c] = origins[3 * r + c];
        d[c] = dirs[3 * r + c];
    }
    const vhx::Hit h = vhx::march<false, kOpt>(o, d, occ, colors, levels, P.n_levels, P.size,
                                               P.n_blocks, P.max_iters, 0.f, true, opt);
    hit_out[r] = h.hit ? 1 : 0;
    voxel_out[r] = h.voxel;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        hvox_out[3 * r + c] = h.hvox[c];
        point_out[3 * r + c] = h.point[c];
        hnormal_out[3 * r + c] = h.normal[c];
    }
}

__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
                const TraceParams P, int R,
                unsigned char* __restrict__ hit_out, int* __restrict__ voxel_out,
                int* __restrict__ hvox_out, float* __restrict__ point_out,
                float* __restrict__ hnormal_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P, levels);
    traverse_ray<false>(origins, dirs, occ, colors, P, TraceOptions{}, levels, R, hit_out,
                        voxel_out, hvox_out, point_out, hnormal_out);
}

// The stack automaton under `opt` with kOpt, over u8 colors with kU8
template <bool kOpt, bool kU8>
__global__ void __launch_bounds__(128)
traverse_form_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const uint2* __restrict__ occ, const vhx::color_t<kU8>* __restrict__ colors,
                     const TraceParams P, const TraceOptions opt, int R,
                     unsigned char* __restrict__ hit_out, int* __restrict__ voxel_out,
                     int* __restrict__ hvox_out, float* __restrict__ point_out,
                     float* __restrict__ hnormal_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P, levels);
    traverse_ray<kOpt>(origins, dirs, occ, colors, P, opt, levels, R, hit_out, voxel_out,
                       hvox_out, point_out, hnormal_out);
}

template <int L, bool kU8>
__global__ void __launch_bounds__(128)
traverse_skip_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const uint2* __restrict__ rows, const vhx::color_t<kU8>* __restrict__ colors,
                     const TraceParams P, int substeps, int R,
                     unsigned char* __restrict__ hit_out, int* __restrict__ voxel_out,
                     int* __restrict__ hvox_out, float* __restrict__ point_out,
                     float* __restrict__ hnormal_out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        o[c] = origins[3 * r + c];
        d[c] = dirs[3 * r + c];
    }
    const vhx::SkipGrid g = vhx::skip_grid(rows, P.size, substeps);
    const vhx::Hit h = vhx::skip_march<false, L>(o, d, g, colors, P.max_iters);
    hit_out[r] = h.hit ? 1 : 0;
    voxel_out[r] = h.voxel;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        hvox_out[3 * r + c] = h.hvox[c];
        point_out[3 * r + c] = h.point[c];
        hnormal_out[3 * r + c] = h.normal[c];
    }
}

}  // namespace

extern "C" int vhx_trace_params_size() { return (int)sizeof(TraceParams); }

extern "C" int vhx_trace_options_size() { return (int)sizeof(TraceOptions); }

// Trace `n_rays` rays (origins, dirs: f32 [R, 3]) into hit (u8 [R]), voxel
// (int32 [R]), hvox (int32 [R, 3]), point and hnormal (f32 [R, 3]), each
// ray for at most params->max_iters steps.  `substeps` 0 marches the stack
// automaton over the pyramid's word pairs `words`, under `opts` (null: the
// default options, traverse_kernel's); `substeps` >= 1 the skip tracer over
// the skip rows (u32 [ceil(S / 4)^3, 2 n_levels], 16 B aligned; `opts`
// null), `substeps` substeps a body iteration and params->max_iters body
// iterations a ray, the instance of the grid's depth.  `colors` is u16
// (`color_bytes` 2) or u8 (1).
extern "C" cudaError_t vhx_traverse_ex(const float* origins, const float* dirs,
                                       const void* words, const void* colors,
                                       const TraceParams* params, const TraceOptions* opts,
                                       int color_bytes, int substeps, int n_rays, void* hit,
                                       int* voxel, int* hvox, float* point, float* hnormal,
                                       int device, cudaStream_t stream) {
    const int max_levels = substeps ? VHX_SKIP_MAX_LEVELS : VHX_MAX_LEVELS;
    if (params->n_levels < 1 || params->n_levels > max_levels || substeps < 0 ||
        (color_bytes != 1 && color_bytes != 2) || (substeps && opts) ||
        (substeps && !vhx::skip_rows_aligned(words)))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int threads = 128;
    const int blocks = (n_rays + threads - 1) / threads;
    const auto* occ = static_cast<const uint2*>(words);
    auto* hit_u8 = static_cast<unsigned char*>(hit);
    auto launch = [&](auto u8) {
        constexpr bool kU8 = decltype(u8)::value;
        const auto* col = static_cast<const vhx::color_t<kU8>*>(colors);
        if (substeps)
            return vhx::skip_depth(params->n_levels, [&](auto depth) {
                constexpr int L = decltype(depth)::value;
                traverse_skip_kernel<L, kU8><<<blocks, threads, 0, stream>>>(
                    origins, dirs, occ, col, *params, substeps, n_rays, hit_u8, voxel, hvox,
                    point, hnormal);
                return cudaGetLastError();
            });
        if (opts)
            traverse_form_kernel<true, kU8><<<blocks, threads, 0, stream>>>(
                origins, dirs, occ, col, *params, *opts, n_rays, hit_u8, voxel, hvox, point,
                hnormal);
        else if constexpr (kU8)
            traverse_form_kernel<false, true><<<blocks, threads, 0, stream>>>(
                origins, dirs, occ, col, *params, TraceOptions{}, n_rays, hit_u8, voxel, hvox,
                point, hnormal);
        else
            traverse_kernel<<<blocks, threads, 0, stream>>>(
                origins, dirs, occ, col, *params, n_rays, hit_u8, voxel, hvox, point, hnormal);
        return cudaGetLastError();
    };
    return color_bytes == 1 ? launch(std::true_type{}) : launch(std::false_type{});
}

extern "C" cudaError_t vhx_traverse(const float* origins, const float* dirs,
                                    const void* occ_pairs, const void* colors,
                                    const TraceParams* params, int n_rays,
                                    void* hit, int* voxel, int* hvox, float* point,
                                    float* hnormal, int device, cudaStream_t stream) {
    return vhx_traverse_ex(origins, dirs, occ_pairs, colors, params, nullptr, 2, 0, n_rays, hit,
                           voxel, hvox, point, hnormal, device, stream);
}

// The skip tracer's rays: vhx_traverse_ex with `substeps` >= 1 over u16
// colors
extern "C" cudaError_t vhx_traverse_skip(const float* origins, const float* dirs,
                                         const void* rows, const void* colors,
                                         const TraceParams* params, int n_rays, int substeps,
                                         void* hit, int* voxel, int* hvox, float* point,
                                         float* hnormal, int device, cudaStream_t stream) {
    if (substeps < 1) return cudaErrorInvalidValue;
    return vhx_traverse_ex(origins, dirs, rows, colors, params, nullptr, 2, substeps, n_rays, hit,
                           voxel, hvox, point, hnormal, device, stream);
}
