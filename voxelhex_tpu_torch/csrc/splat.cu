// The splat prepass: the surface voxels' centers projected into a
// half-resolution buffer, whose conservative minimum gives each 2 x 2 pixel
// tile a start.
//
// Replaces the reference's `_splat_depth_fn` (voxelhex_tpu/render/
// bitgrid.py:1262, with `_splat_points` :1236 and `splat_start` :1367), an
// XLA program with no Pallas source on the path of the ported frame.  Two
// kernels, in the reference's order of operations (-fmad=false; the
// multiply-adds that XLA:CPU fuses are __fmaf_rn):
//   point pass  one thread a center: its view depth z, texel (u, v) and
//               distance d (the explicit dot products and the norm each a
//               chain of fused multiply-adds), its footprint f_tex.  A
//               reliable center (z > 0, f_tex <= 2, within 3 texels of the
//               buffer) takes the minimum of its texel's distance: an
//               atomicMin of d's bits as an int, which orders non-negative
//               floats as the floats, so the minimum is exact whatever the
//               order.  A center whose footprint exceeds 2 texels flags its
//               cell of the blocker grid that takes its footprint (cells of
//               4, 16 and 64 texels); one beyond 64 texels, or nearer the
//               eye than max(sref / 64, 3), sets the global flag;
//   texel pass  one thread a texel: the least distance of its 5 x 5
//               neighbourhood (edge-clamped), 0 where no center reached it,
//               0 where a flagged cell lies within one cell of its own in a
//               blocker grid, 0 everywhere under the global flag, then the
//               start max(min - margin, 0).
// The buffer's words start at 0x7F7F7F7F (one memset), a float above 1e8
// that the texel pass reads as the reference's empty 1e8; the flags start
// at 0.  The frame kernel reads the texel map with a tile of 2 (frame.cu).
//
// What bounds it: the point pass's atomics on the buffer and the flags
// (the bench scene has 55,812 surface centers), and two launches; the
// texel pass reads 25 words a texel from L1/L2.

#include "traverse.cuh"

struct SplatParams {
    float origin[3];
    float right[3];
    float up[3];
    float forward[3];
    float scale[2];  // (tan(fov_y / 2) * w / h, tan(fov_y / 2))
    float margin;
    int w2, h2;      // the half-resolution buffer
    int n_points;
};

namespace {

constexpr int THREADS = 256;
constexpr float NO_SPLAT = 1e8f;
constexpr int N_BLOCKERS = 3;

// blocker grid b: its cell in texels, and the footprints (f_lo, f_hi] in
// texels of the centers it takes
__host__ __device__ __forceinline__ int blocker_cell(int b) { return b == 0 ? 4 : (b == 1 ? 16 : 64); }
__device__ __forceinline__ float blocker_lo(int b) { return b == 0 ? 2.f : (b == 1 ? 3.f : 16.f); }
__device__ __forceinline__ float blocker_hi(int b) { return b == 0 ? 3.f : (b == 1 ? 16.f : 64.f); }

// the blocker grid of cell c over a w2 x h2 buffer: (gw, gh) with a margin
// of 2 cells each side
__host__ __device__ __forceinline__ int grid_w(int w2, int c) { return (w2 + c - 1) / c + 4; }
__host__ __device__ __forceinline__ int grid_h(int h2, int c) { return (h2 + c - 1) / c + 4; }

__device__ __forceinline__ int clamp_to(int i, int n) { return i < 0 ? 0 : (i > n - 1 ? n - 1 : i); }

// m . v as XLA:CPU compiles the reference's m0 * v0 + m1 * v1 + m2 * v2
__device__ __forceinline__ float dot3(const float m[3], const float v[3]) {
    return __fmaf_rn(m[2], v[2], __fmaf_rn(m[1], v[1], __fmul_rn(m[0], v[0])));
}

// sref = max(w2 / 2 / scale_x, h2 / 2 / scale_y): texels a unit of view depth
__device__ __forceinline__ float splat_sref(const SplatParams& P) {
    return vhx::xla_max(__fdiv_rn(__fmul_rn((float)P.w2, 0.5f), P.scale[0]),
                        __fdiv_rn(__fmul_rn((float)P.h2, 0.5f), P.scale[1]));
}

__global__ void __launch_bounds__(THREADS)
splat_point_kernel(const float* __restrict__ pts, const SplatParams P, int* __restrict__ depth,
                   int* __restrict__ flags) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= P.n_points) return;
    float rel[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) rel[c] = __fsub_rn(pts[3 * i + c], P.origin[c]);
    const float z = dot3(rel, P.forward);
    const float x = dot3(rel, P.right);
    const float y = dot3(rel, P.up);
    const float zs = vhx::xla_max(z, 1e-6f);
    const float w2 = (float)P.w2, h2 = (float)P.h2;
    // (x / (zs * sx) + 1) * 0.5 * w2 and (1 - y / (zs * sy)) * 0.5 * h2
    const float u = __fmul_rn(
        __fmul_rn(__fadd_rn(__fdiv_rn(x, __fmul_rn(zs, P.scale[0])), 1.f), 0.5f), w2);
    const float v = __fmul_rn(
        __fmul_rn(__fsub_rn(1.f, __fdiv_rn(y, __fmul_rn(zs, P.scale[1]))), 0.5f), h2);
    const float d = __fsqrt_rn(
        __fmaf_rn(rel[2], rel[2], __fmaf_rn(rel[1], rel[1], __fmul_rn(rel[0], rel[0]))));
    const float sref = splat_sref(P);
    const float f_tex = __fdiv_rn(sref, zs);

    const bool reliable = z > 0.f && f_tex <= 2.f && u >= -3.f && u < __fadd_rn(w2, 3.f) &&
                          v >= -3.f && v < __fadd_rn(h2, 3.f);
    if (reliable) {
        // clip(u, 0, w2 - 1) truncated toward zero, as the reference's astype
        const int ui = (int)fminf(fmaxf(u, 0.f), __fsub_rn(w2, 1.f));
        const int vi = (int)fminf(fmaxf(v, 0.f), __fsub_rn(h2, 1.f));
        atomicMin(&depth[vi * P.w2 + ui], __float_as_int(d));
    }
    int* g = flags;
#pragma unroll
    for (int b = 0; b < N_BLOCKERS; ++b) {
        const int c = blocker_cell(b);
        const int gw = grid_w(P.w2, c), gh = grid_h(P.h2, c);
        // floor(u / c) + 2, compared as floats: an index out of int range
        // is out of the grid either way
        const float inv_c = 1.f / (float)c;
        const float gu = __fadd_rn(floorf(__fmul_rn(u, inv_c)), 2.f);
        const float gv = __fadd_rn(floorf(__fmul_rn(v, inv_c)), 2.f);
        const bool near = z > 0.f && f_tex > blocker_lo(b) && f_tex <= blocker_hi(b);
        if (near && gu >= 0.f && gu < (float)gw && gv >= 0.f && gv < (float)gh)
            atomicMax(&g[(int)gv * gw + (int)gu], 1);
        g += gw * gh;
    }
    const float eye = vhx::xla_max(__fmul_rn(sref, 1.f / 64.f), 3.f);
    if ((z > 0.f && f_tex > 64.f) || d < eye) atomicMax(g, 1);  // the global flag
}

__global__ void __launch_bounds__(THREADS)
splat_texel_kernel(const SplatParams P, const int* __restrict__ depth,
                   const int* __restrict__ flags, float* __restrict__ out) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const int w2 = P.w2, h2 = P.h2;
    if (i >= w2 * h2) return;
    const int tx = i % w2, ty = i / w2;
    float dmin = NO_SPLAT;
    for (int dy = -2; dy <= 2; ++dy) {
        const int yy = clamp_to(ty + dy, h2);
        for (int dx = -2; dx <= 2; ++dx) {
            const int xx = clamp_to(tx + dx, w2);
            dmin = fminf(dmin, __int_as_float(__ldg(&depth[yy * w2 + xx])));
        }
    }
    if (!(dmin < 1e7f)) dmin = 0.f;
    const int* g = flags;
#pragma unroll
    for (int b = 0; b < N_BLOCKERS; ++b) {
        const int c = blocker_cell(b);
        const int gw = grid_w(w2, c), gh = grid_h(h2, c);
        const int cx = tx / c + 2, cy = ty / c + 2;
        bool blocked = false;
        for (int yy = cy - 1; yy <= cy + 1; ++yy)
            for (int xx = cx - 1; xx <= cx + 1; ++xx)
                if (yy >= 0 && yy < gh && xx >= 0 && xx < gw && __ldg(&g[yy * gw + xx]))
                    blocked = true;
        if (blocked) dmin = 0.f;
        g += gw * gh;
    }
    if (__ldg(g)) dmin = 0.f;
    out[i] = vhx::xla_max(__fsub_rn(dmin, P.margin), 0.f);
}

}  // namespace

extern "C" int vhx_splat_params_size() { return (int)sizeof(SplatParams); }

// The int32 words of the three blocker grids and the global flag
extern "C" int vhx_splat_block_words(int w2, int h2) {
    int n = 1;
    for (int b = 0; b < N_BLOCKERS; ++b)
        n += grid_w(w2, blocker_cell(b)) * grid_h(h2, blocker_cell(b));
    return n;
}

// Each 2 x 2 tile's start, f32 [h2, w2], from the centers `pts` (f32
// [n_points, 3]); `depth` (int32 [h2 * w2]) and `flags` (int32
// [vhx_splat_block_words]) are the passes' scratch.
extern "C" cudaError_t vhx_splat(const float* pts, const SplatParams* params, int* depth,
                                 int* flags, float* out, int device, cudaStream_t stream) {
    const SplatParams& P = *params;
    if (P.w2 < 1 || P.h2 < 1 || P.n_points < 0 || (P.n_points && !pts) || !depth || !flags ||
        !out)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const long long texels = (long long)P.w2 * P.h2;
    // every byte 0x7F: each word 0x7F7F7F7F, a float above NO_SPLAT
    err = cudaMemsetAsync(depth, 0x7F, texels * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(flags, 0, vhx_splat_block_words(P.w2, P.h2) * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    if (P.n_points > 0) {
        splat_point_kernel<<<(P.n_points + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            pts, P, depth, flags);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    splat_texel_kernel<<<(unsigned)((texels + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        P, depth, flags, out);
    return cudaGetLastError();
}
