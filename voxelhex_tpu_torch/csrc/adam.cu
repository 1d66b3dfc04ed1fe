// The soft renderer's optimizer step in one pass over its flat params:
// the opacity-L1 gradient folded into the logits' gradient, optax's Adam,
// and the param clamps (albedo to [0, 1], logits to [-12, 12]).
//
// Replaces the XLA program of the step's tail (`_apply_update` /
// `_finish_step_fn`, voxelhex_tpu/diff/soft.py:532, :585, with the L1 term
// of `_fused_loss_grads`, :507), which has no Pallas source.  Each element
// computes optax 0.2.6's `scale_by_adam` + `scale_by_learning_rate` +
// `apply_updates` in the order XLA:CPU compiles them, so that the update is
// bit-equal to the reference's for equal inputs:
//   mu' = fma(g, 1 - b1, b1 mu),  nu' = fma(g g, 1 - b2, b2 nu),
//   c' = count + 1 (saturating),  bc1 = 1 - b1^c',  bc2 = 1 - b2^c',
//   p' = fma(mu' / (bc1 (sqrt(nu' / bc2) + eps)), -lr, p),
// where XLA has rewritten optax's (mu' / bc1) / (sqrt(nu' / bc2 + 0) + eps)
// into one division and fused the multiply-adds.  b^c' is the correctly
// rounded f32 of the power, which equals XLA:CPU's f32 power of 1 - b^c' for
// the counts of a training run.  The L1 term adds
// fma(l1 / N, s (1 - s), g) with s = sigmoid(logit), JAX's derivative.
// A null gradient pointer stands for zeros (fit_albedo=False in the
// reference passes zero albedo gradients, so momentum still moves albedo).
//
// The count lives on the device: each block reads it and computes the bias
// corrections once, and block 0 writes count + 1 to `count_out`, a
// separate buffer, so that no block reads a count already advanced.
//
// What bounds it on the H100: bytes.  Per element it reads p, g, mu, nu and
// writes p, mu, nu: 28 B, about 1.9 GB for the 67,108,864 params of a 256^3
// world, 0.56 ms at 3.35 TB/s; the arithmetic is some 20 f32 operations per
// element.  A grid-stride loop of coalesced 4 B accesses; params, mu and nu
// are updated in place.

#include <cuda_runtime.h>
#include <stdint.h>

struct AdamParams {
    float neg_lr;         // -lr
    float b1, b2;         // decay rates
    float one_m_b1;       // 1 - b1, as optax's f32 constant
    float one_m_b2;       // 1 - b2
    float eps;
    double b1_d, b2_d;    // the f32 decay rates, widened
    float l1_scale;       // opacity_l1 / N for the logits group, 0 for none
    float lo[2], hi[2];   // clamp of each group
};

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float sigmoid(float x) {
    return __fdiv_rn(1.f, __fadd_rn(expf(-x), 1.f));
}

__global__ void __launch_bounds__(THREADS)
adam_kernel(float* __restrict__ p0, const float* __restrict__ g0, float* __restrict__ mu0,
            float* __restrict__ nu0, long long n0, float* __restrict__ p1,
            const float* __restrict__ g1, float* __restrict__ mu1, float* __restrict__ nu1,
            long long n1, const int* __restrict__ count_in, int* __restrict__ count_out,
            const AdamParams A) {
    __shared__ float bc[2];
    if (threadIdx.x == 0) {
        const int c0 = count_in[0];
        const int c = c0 < 0x7fffffff ? c0 + 1 : c0;  // optax's safe_increment
        bc[0] = __fsub_rn(1.f, (float)pow(A.b1_d, (double)c));
        bc[1] = __fsub_rn(1.f, (float)pow(A.b2_d, (double)c));
        if (blockIdx.x == 0) count_out[0] = c;
    }
    __syncthreads();
    const float bc1 = bc[0], bc2 = bc[1];
    const long long n = n0 + n1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const bool first = i < n0;
        const long long j = first ? i : i - n0;
        float* p = first ? p0 : p1;
        const float* gp = first ? g0 : g1;
        float* mu = first ? mu0 : mu1;
        float* nu = first ? nu0 : nu1;
        const float x = p[j];
        float g = gp ? gp[j] : 0.f;
        if (!first && A.l1_scale != 0.f) {
            const float s = sigmoid(x);
            g = __fmaf_rn(A.l1_scale, __fmul_rn(s, __fsub_rn(1.f, s)), g);
        }
        const float m = __fmaf_rn(g, A.one_m_b1, __fmul_rn(A.b1, mu[j]));
        const float v = __fmaf_rn(__fmul_rn(g, g), A.one_m_b2, __fmul_rn(A.b2, nu[j]));
        const float den = __fmul_rn(bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), A.eps));
        float y = __fmaf_rn(__fdiv_rn(m, den), A.neg_lr, x);
        const int grp = first ? 0 : 1;
        y = y < A.lo[grp] ? A.lo[grp] : y;  // NaN passes, as in jnp.clip
        y = y > A.hi[grp] ? A.hi[grp] : y;
        mu[j] = m;
        nu[j] = v;
        p[j] = y;
    }
}

}  // namespace

extern "C" int vhx_adam_params_size() { return (int)sizeof(AdamParams); }

// Group 0 (albedo) and group 1 (logits); g0 / g1 null for zero gradients.
extern "C" cudaError_t vhx_adam(float* p0, const float* g0, float* mu0, float* nu0, long long n0,
                                float* p1, const float* g1, float* mu1, float* nu1, long long n1,
                                const int* count_in, int* count_out, const AdamParams* params,
                                int device, cudaStream_t stream) {
    if (n0 < 0 || n1 < 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const long long n = n0 + n1;
    long long blocks = (n + THREADS - 1) / THREADS;
    blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
    adam_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(p0, g0, mu0, nu0, n0, p1, g1, mu1, nu1,
                                                           n1, count_in, count_out, *params);
    return cudaGetLastError();
}
