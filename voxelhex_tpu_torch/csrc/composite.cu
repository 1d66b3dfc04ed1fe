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
// skipped: the reference compacts it away for the same reason (by the
// march's count, as the backward does when it is given the count).  An
// empty slot adds exact zeros in the reference (its alpha is masked) and
// is skipped too.  The atomics add in no fixed order, so the gradients hold
// the reference's within a tolerance, not bit for bit.
//
// What bounds it on the H100: bytes, and the latency of scattered 4 B
// accesses.  Per hit slot the forward gathers 4 B of logit and 12 B of
// albedo from voxels spread over the 268 MB of params; the backward does
// the same gathers and its atomic adds, and the dense gradients' zero-fill
// writes 268 MB.  One thread per ray keeps a ray's K slots in registers (K
// is a template parameter, 1 to 8).
//
// The backward keeps each warp whole, so that its lanes can merge their
// adds:
//   * with the march's count (int32 [R], 4 B a ray) a warp reads its rays'
//     counts first and leaves when none hit: 85% of the bench frame's
//     rays, whose 24 B of slots (K = 2) it then never reads; without it,
//     a warp leaves once its rays' slots show no hit;
//   * for each slot k, the lanes whose slot holds one voxel (neighbouring
//     pixels often hit one) meet by __match_any_sync, the group's lowest
//     lane sums the group's contributions by shuffles and adds once: 1
//     logit add, and the albedo's three channels as one 8 B vector add and
//     one 4 B add (the pair on an 8 B boundary: parity of 3 * addr), where
//     one thread a ray issued 4 scalar adds a hit slot, serialized on the
//     addresses that many lanes share.
// At the training step's shapes (the bench pose at 1080p, K = 2) that is
// 1.157 adds a hit slot against 4, and the kernel alone takes 0.0243 ms
// against one thread a ray's 0.0550 (0.0360 without the count).  The
// dense gradients are zero-filled by the caller (two PyTorch fills, 0.081
// ms): the C entry's cudaMemsetAsync of the same 268 MB measured 1% slower
// (PERF.md §6; an NVIDIA H100 80GB HBM3 at 700 W).

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

// Add a slot's contributions (lg into the logit, w into the albedo
// channels of voxel addr; addr -1: none) merged across the warp: the lanes
// of one voxel meet, their lowest lane sums theirs and adds once.  Every
// lane of the warp calls it.
__device__ __forceinline__ void add_merged(long long addr, float lg, const float (&w)[3],
                                           float* __restrict__ g_albedo,
                                           float* __restrict__ g_logits) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const unsigned group = __match_any_sync(FULL, addr);
    const bool leader = addr >= 0 && lane == __ffs(group) - 1;
    unsigned todo = leader ? group & (group - 1) : 0u;
    float s[4] = {lg, w[0], w[1], w[2]};
    while (__any_sync(FULL, todo != 0)) {
        const int src = todo ? __ffs(todo) - 1 : lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float v = __shfl_sync(FULL, s[q], src);
            if (todo) s[q] = __fadd_rn(s[q], v);
        }
        todo &= todo - 1;
    }
    if (!leader) return;
    if (g_logits) atomicAdd(&g_logits[addr], s[0]);
    if (g_albedo) {
        float* p = g_albedo + 3 * addr;
        if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
            atomicAdd(reinterpret_cast<float2*>(p), make_float2(s[1], s[2]));
            atomicAdd(p + 2, s[3]);
        } else {
            atomicAdd(p, s[1]);
            atomicAdd(reinterpret_cast<float2*>(p + 1), make_float2(s[2], s[3]));
        }
    }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ grad_rgb, const float* __restrict__ albedo,
                     const float* __restrict__ logits, const int* __restrict__ voxels,
                     const int* __restrict__ count, int R, int size, float bg0, float bg1,
                     float bg2, int has_bg, float* __restrict__ g_albedo,
                     float* __restrict__ g_logits) {
    constexpr unsigned FULL = 0xffffffffu;
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    // a ray that may hold a hit: by its count where there is one
    bool live = r < R && (count == nullptr || __ldg(&count[r]) > 0);
    if (!__any_sync(FULL, live)) return;
    long long addr[K];
    float a[K], c[K][3], Tp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) addr[k] = -1;
    // no valid slot: a zero gradient (each slot is valid or not on its own)
    if (live) live = load_slots<K>(albedo, logits, voxels, r, size, addr, a, c) > 0;
    if (!__any_sync(FULL, live)) return;
    float g[3] = {0.f, 0.f, 0.f}, Q = 0.f;
    if (live) {
        float T = 1.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            Tp[k] = T;
            T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.f, a[k]), 1e-9f));
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) g[ch] = grad_rgb[3 * r + ch];
        if (has_bg)
            Q = __fadd_rn(__fadd_rn(__fmul_rn(g[0], bg0), __fmul_rn(g[1], bg1)),
                          __fmul_rn(g[2], bg2));
    }
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
        const bool valid = addr[k] >= 0;
        if (!__any_sync(FULL, valid)) continue;
        float lg = 0.f, w[3] = {0.f, 0.f, 0.f};
        if (valid) {
            const float dw = __fadd_rn(
                __fadd_rn(__fmul_rn(g[0], c[k][0]), __fmul_rn(g[1], c[k][1])),
                __fmul_rn(g[2], c[k][2]));
            const float da = __fmul_rn(Tp[k], __fsub_rn(dw, Q));
            const float f = __fadd_rn(__fsub_rn(1.f, a[k]), 1e-9f);
            Q = __fadd_rn(__fmul_rn(dw, a[k]), __fmul_rn(f, Q));
            lg = __fmul_rn(da, __fmul_rn(a[k], __fsub_rn(1.f, a[k])));
            const float wk = __fmul_rn(a[k], Tp[k]);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) w[ch] = __fmul_rn(wk, g[ch]);
        }
        add_merged(addr[k], lg, w, g_albedo, g_logits);
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
                const float* logits, const int* voxels, const int* count, int R, int size,
                const float* bg, float* g_albedo, float* g_logits) {
    composite_bwd_kernel<K><<<blocks, THREADS, 0, s>>>(
        grad_rgb, albedo, logits, voxels, count, R, size, bg ? bg[0] : 0.f, bg ? bg[1] : 0.f,
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

// g_albedo / g_logits: zeroed gradient buffers to add into, or null to skip.
// count: the march's hits a ray (int32 [n_rays]), or null to read every
// ray's slots; a ray of count 0 must have no valid slot.
extern "C" cudaError_t vhx_composite_backward(const float* grad_rgb, const float* albedo,
                                              const float* logits, const int* voxels,
                                              const int* count, int n_rays, int max_hits,
                                              int size, const float* bg, float* g_albedo,
                                              float* g_logits, int device, cudaStream_t stream) {
    if (size < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n_rays <= 0) return cudaSuccess;
    const int blocks = (n_rays + THREADS - 1) / THREADS;
#define VHX_BWD(k) launch_bwd<k>(blocks, stream, grad_rgb, albedo, logits, voxels, count, n_rays, \
                                 size, bg, g_albedo, g_logits)
    VHX_DISPATCH_K(max_hits, VHX_BWD)
#undef VHX_BWD
    return cudaGetLastError();
}
