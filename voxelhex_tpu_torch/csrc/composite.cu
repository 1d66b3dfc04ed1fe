// Transmittance compositing over the K voxels each ray recorded, forward
// and backward, over flat per-voxel params: albedo f32 [S^3 * 3] (voxel i's
// color at 3 i .. 3 i + 2) and opacity logits f32 [S^3].
//
// Replaces the XLA programs of the soft renderer's `composite`
// (voxelhex_tpu/diff/soft.py:1033) and of its gradient, the flat-param
// gather's scatter-add (`_gather_rows_flat_params_bwd`, soft.py:95) under
// `grad_on_hits` (soft.py:932); none has a Pallas source.  Per ray, over
// its slots k < K (voxel -1: empty):
//   a_k = sigmoid(logit[v_k]) (0 in an empty slot), f_k = (1 - a_k) + 1e-9,
//   T_k = f_0 ... f_k, w_k = a_k T_{k-1} (T_{-1} = 1),
//   rgb = sum_k w_k c_k (+ T_{K-1} bg).
// The backward takes dL/drgb = g and adds, with f32 atomics,
//   dL/dc_k = w_k g into the albedo gradient, and
//   dL/dlogit_k = da_k (a_k (1 - a_k)) into the logit gradient, where
//   da_k = T_{k-1} (g.c_k - Q_k), Q_{K-1} = g.bg (0 without bg),
//   Q_{k-1} = (g.c_k) a_k + f_k Q_k.
// A ray with no hit has a params-free color and adds nothing, so it is
// skipped: the reference compacts it away for the same reason.  An empty
// slot adds exact zeros in the reference (its alpha is masked) and is
// skipped too.  The atomics add in no fixed order, so the gradients hold
// the reference's within a tolerance, not bit for bit.
//
// What bounds it on the H100: bytes, and the latency of scattered 4 B
// accesses.  Per hit slot the forward gathers 4 B of logit and 12 B of
// albedo from voxels spread over the 268 MB of params; the backward does
// the same gathers and 4 atomic adds.  Rays with no hit (85% of the bench
// frame) read their slots' voxels and stop.  One thread per ray keeps a ray's
// K slots in registers (K is a template parameter, 1 to 8).

#include "traverse.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sigmoid(float x) {
    // 1 / (exp(-x) + 1), the reference's form
    return __fdiv_rn(1.f, __fadd_rn(expf(-x), 1.f));
}

// The slots of ray r: address, alpha and albedo of each valid slot
template <int K>
__device__ __forceinline__ int load_slots(const float* __restrict__ albedo,
                                          const float* __restrict__ logits,
                                          const int* __restrict__ voxels, long long r, int size,
                                          long long addr[K], float a[K], float c[K][3]) {
    int n = 0;
    const int* v = voxels + r * K * 3;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        addr[k] = -1;
        a[k] = 0.f;
        c[k][0] = c[k][1] = c[k][2] = 0.f;
        int x = v[3 * k], y = v[3 * k + 1], z = v[3 * k + 2];
        if (x >= 0) {
            const int hi = size - 1;
            x = x > hi ? hi : x;
            y = y < 0 ? 0 : (y > hi ? hi : y);
            z = z < 0 ? 0 : (z > hi ? hi : z);
            addr[k] = vhx::voxel_addr(x, y, z, size);
            a[k] = sigmoid(__ldg(&logits[addr[k]]));
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) c[k][ch] = __ldg(&albedo[3 * addr[k] + ch]);
            n += 1;
        }
    }
    return n;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float* __restrict__ albedo, const float* __restrict__ logits,
                     const int* __restrict__ voxels, int R, int size, float bg0, float bg1,
                     float bg2, int has_bg, float* __restrict__ rgb_out) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    long long addr[K];
    float a[K], c[K][3];
    load_slots<K>(albedo, logits, voxels, r, size, addr, a, c);
    float rgb[3] = {0.f, 0.f, 0.f};
    float T = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const float w = __fmul_rn(a[k], T);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float term = __fmul_rn(w, c[k][ch]);
            rgb[ch] = k == 0 ? term : __fadd_rn(rgb[ch], term);
        }
        T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.f, a[k]), 1e-9f));
    }
    if (has_bg) {
        rgb[0] = __fadd_rn(rgb[0], __fmul_rn(T, bg0));
        rgb[1] = __fadd_rn(rgb[1], __fmul_rn(T, bg1));
        rgb[2] = __fadd_rn(rgb[2], __fmul_rn(T, bg2));
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb_out[3 * r + ch] = rgb[ch];
}

template <int K>
__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ grad_rgb, const float* __restrict__ albedo,
                     const float* __restrict__ logits, const int* __restrict__ voxels, int R,
                     int size, float bg0, float bg1, float bg2, int has_bg,
                     float* __restrict__ g_albedo, float* __restrict__ g_logits) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    long long addr[K];
    float a[K], c[K][3], Tp[K];
    // no valid slot: a zero gradient (each slot is valid or not on its own)
    if (load_slots<K>(albedo, logits, voxels, r, size, addr, a, c) == 0) return;
    float T = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        Tp[k] = T;
        T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.f, a[k]), 1e-9f));
    }
    const float g[3] = {grad_rgb[3 * r], grad_rgb[3 * r + 1], grad_rgb[3 * r + 2]};
    float Q = has_bg ? __fadd_rn(__fadd_rn(__fmul_rn(g[0], bg0), __fmul_rn(g[1], bg1)),
                                 __fmul_rn(g[2], bg2))
                     : 0.f;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
        if (addr[k] < 0) continue;
        const float dw = __fadd_rn(__fadd_rn(__fmul_rn(g[0], c[k][0]), __fmul_rn(g[1], c[k][1])),
                                   __fmul_rn(g[2], c[k][2]));
        const float da = __fmul_rn(Tp[k], __fsub_rn(dw, Q));
        const float f = __fadd_rn(__fsub_rn(1.f, a[k]), 1e-9f);
        Q = __fadd_rn(__fmul_rn(dw, a[k]), __fmul_rn(f, Q));
        if (g_logits)
            atomicAdd(&g_logits[addr[k]], __fmul_rn(da, __fmul_rn(a[k], __fsub_rn(1.f, a[k]))));
        if (g_albedo) {
            const float w = __fmul_rn(a[k], Tp[k]);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) atomicAdd(&g_albedo[3 * addr[k] + ch], __fmul_rn(w, g[ch]));
        }
    }
}

template <int K>
void launch_fwd(int blocks, cudaStream_t s, const float* albedo, const float* logits,
                const int* voxels, int R, int size, const float* bg, float* rgb) {
    composite_fwd_kernel<K><<<blocks, THREADS, 0, s>>>(
        albedo, logits, voxels, R, size, bg ? bg[0] : 0.f, bg ? bg[1] : 0.f, bg ? bg[2] : 0.f,
        bg ? 1 : 0, rgb);
}

template <int K>
void launch_bwd(int blocks, cudaStream_t s, const float* grad_rgb, const float* albedo,
                const float* logits, const int* voxels, int R, int size, const float* bg,
                float* g_albedo, float* g_logits) {
    composite_bwd_kernel<K><<<blocks, THREADS, 0, s>>>(
        grad_rgb, albedo, logits, voxels, R, size, bg ? bg[0] : 0.f, bg ? bg[1] : 0.f,
        bg ? bg[2] : 0.f, bg ? 1 : 0, g_albedo, g_logits);
}

#define VHX_DISPATCH_K(K, CALL)            \
    switch (K) {                           \
        case 1: CALL(1); break;            \
        case 2: CALL(2); break;            \
        case 3: CALL(3); break;            \
        case 4: CALL(4); break;            \
        case 5: CALL(5); break;            \
        case 6: CALL(6); break;            \
        case 7: CALL(7); break;            \
        case 8: CALL(8); break;            \
        default: return cudaErrorInvalidValue; \
    }

}  // namespace

// bg: three floats on the host, or null for no background
extern "C" cudaError_t vhx_composite_forward(const float* albedo, const float* logits,
                                             const int* voxels, int n_rays, int max_hits,
                                             int size, const float* bg, float* rgb, int device,
                                             cudaStream_t stream) {
    if (size < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int blocks = (n_rays + THREADS - 1) / THREADS;
#define VHX_FWD(k) launch_fwd<k>(blocks, stream, albedo, logits, voxels, n_rays, size, bg, rgb)
    VHX_DISPATCH_K(max_hits, VHX_FWD)
#undef VHX_FWD
    return cudaGetLastError();
}

// g_albedo / g_logits: zeroed gradient buffers to add into, or null to skip
extern "C" cudaError_t vhx_composite_backward(const float* grad_rgb, const float* albedo,
                                              const float* logits, const int* voxels,
                                              int n_rays, int max_hits, int size,
                                              const float* bg, float* g_albedo, float* g_logits,
                                              int device, cudaStream_t stream) {
    if (size < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int blocks = (n_rays + THREADS - 1) / THREADS;
#define VHX_BWD(k) launch_bwd<k>(blocks, stream, grad_rgb, albedo, logits, voxels, n_rays, size, \
                                 bg, g_albedo, g_logits)
    VHX_DISPATCH_K(max_hits, VHX_BWD)
#undef VHX_BWD
    return cudaGetLastError();
}
