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

#include "traverse.cuh"

namespace {

__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
                const TraceParams P, int R,
                unsigned char* __restrict__ hit_out, int* __restrict__ voxel_out,
                int* __restrict__ hvox_out, float* __restrict__ point_out,
                float* __restrict__ hnormal_out) {
    __shared__ int2 levels[VHX_MAX_LEVELS];
    vhx::load_levels(P, levels);
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        o[c] = origins[3 * r + c];
        d[c] = dirs[3 * r + c];
    }
    const vhx::Hit h = vhx::march(o, d, occ, colors, levels, P.n_levels, P.size, P.n_blocks,
                                  P.max_iters);
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

extern "C" cudaError_t vhx_traverse(const float* origins, const float* dirs,
                                    const void* occ_pairs, const void* colors,
                                    const TraceParams* params, int n_rays,
                                    void* hit, int* voxel, int* hvox, float* point,
                                    float* hnormal, int device, cudaStream_t stream) {
    if (params->n_levels < 1 || params->n_levels > VHX_MAX_LEVELS) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int threads = 128;
    const int blocks = (n_rays + threads - 1) / threads;
    traverse_kernel<<<blocks, threads, 0, stream>>>(
        origins, dirs, static_cast<const uint2*>(occ_pairs),
        static_cast<const unsigned short*>(colors), *params, n_rays,
        static_cast<unsigned char*>(hit), voxel, hvox, point, hnormal);
    return cudaGetLastError();
}
