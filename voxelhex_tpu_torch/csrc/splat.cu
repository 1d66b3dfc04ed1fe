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
//               buffer) takes the minimum of its texel's distance: a 64-bit
//               atomicMax of (epoch << 32 | ~bits of d), which orders
//               non-negative floats in reverse, so the minimum is exact
//               whatever the order.  A center whose footprint exceeds 2
//               texels flags its cell of the blocker grid that takes its
//               footprint (cells of 4, 16 and 64 texels); one beyond 64
//               texels, or nearer the eye than max(sref / 64, 3), sets the
//               global flag; a flag is set by an atomicMax of the epoch;
//   texel pass  a block a 32 x 16 tile of texels: it stages the tile's
//               distances with their 2-texel edge-clamped halo in shared
//               memory (a word of another epoch is the reference's empty
//               1e8), takes each texel's 5 x 5 minimum as a 5-wide row
//               minimum then a 5-tall column minimum (fminf over the same
//               set), 0 where no center reached it; it ORs each blocker
//               grid's flags over the cells the tile touches, dilated by a
//               cell, once, and zeroes a texel under a flagged cell, every
//               texel under the global flag; then the start
//               max(min - margin, 0).
// The scratch (the distances, the blocker grids, the global flag) is the
// wrapper's and stays from call to call: each call's epoch, one higher
// than the last call's on the stream, tags what it writes, so no call
// clears it.  The frame kernel reads the texel map with a tile of 2
// (frame.cu).
//
// What bounds it: two launches and the point pass's atomics on the buffer
// and the flags (the bench scene has 55,812 surface centers); the texel
// pass reads a tile and its halo, 1.4 64-bit words a texel, from the L2.

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

// a texel tile of the texel pass and its halo
constexpr int TEX_W = 32, TEX_H = 16, HALO = 2;
constexpr int STAGE_W = TEX_W + 2 * HALO, STAGE_H = TEX_H + 2 * HALO;
// the cells of a blocker grid (of 4 texels or more) that a tile touches
constexpr int MAX_CELLS = (TEX_W / 4 + 1) * (TEX_H / 4 + 1);
// a distance word of no center this call: every byte 0x7F, a float above
// NO_SPLAT, as the reference's empty buffer reads after its 1e8 fill
constexpr unsigned EMPTY_BITS = 0x7F7F7F7Fu;

__device__ __forceinline__ unsigned long long splat_word(unsigned epoch, float d) {
    return (unsigned long long)epoch << 32 | (unsigned)~(unsigned)__float_as_int(d);
}

// the texel pass's tiles of a w2 x h2 buffer
__host__ __device__ __forceinline__ int tex_tiles_x(int w2) { return (w2 + TEX_W - 1) / TEX_W; }
__host__ __device__ __forceinline__ int tex_tiles_y(int h2) { return (h2 + TEX_H - 1) / TEX_H; }

__global__ void __launch_bounds__(THREADS)
splat_point_kernel(const float* __restrict__ pts, const SplatParams P,
                   unsigned long long* __restrict__ depth, int* __restrict__ flags,
                   int* __restrict__ reached, unsigned epoch) {
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
        atomicMax(&depth[vi * P.w2 + ui], splat_word(epoch, d));
        reached[vi / TEX_H * tex_tiles_x(P.w2) + ui / TEX_W] = (int)epoch;  // its texel tile
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
            atomicMax(&g[(int)gv * gw + (int)gu], (int)epoch);
        g += gw * gh;
    }
    const float eye = vhx::xla_max(__fmul_rn(sref, 1.f / 64.f), 3.f);
    if ((z > 0.f && f_tex > 64.f) || d < eye) atomicMax(g, (int)epoch);  // the global flag
}

__global__ void __launch_bounds__(THREADS)
splat_texel_kernel(const SplatParams P, const unsigned long long* __restrict__ depth,
                   const int* __restrict__ flags, const int* __restrict__ reached,
                   unsigned epoch, float* __restrict__ out) {
    __shared__ float stage[STAGE_H][STAGE_W];
    __shared__ float rows[STAGE_H][TEX_W];
    __shared__ unsigned char blocked[N_BLOCKERS][MAX_CELLS];
    __shared__ int near;
    const int w2 = P.w2, h2 = P.h2;
    const int x0 = blockIdx.x * TEX_W, y0 = blockIdx.y * TEX_H;
    // whether a reliable center reached this tile or one next to it, which
    // the 5 x 5 windows of its texels reach (the clamped edge too); if none
    // did, each texel's minimum is the empty 1e8, so its start is that of
    // a minimum of 0 whatever the blockers say
    if (threadIdx.x == 0) near = 0;
    __syncthreads();
    if (threadIdx.x < 9) {
        const int bx = (int)blockIdx.x - 1 + (int)threadIdx.x % 3;
        const int by = (int)blockIdx.y - 1 + (int)threadIdx.x / 3;
        if (bx >= 0 && bx < (int)gridDim.x && by >= 0 && by < (int)gridDim.y &&
            (unsigned)__ldg(&reached[by * gridDim.x + bx]) == epoch)
            near = 1;
    }
    __syncthreads();
    if (!near) {
        const float empty = vhx::xla_max(__fsub_rn(0.f, P.margin), 0.f);
        for (int i = threadIdx.x; i < TEX_W * TEX_H; i += THREADS) {
            const int tx = x0 + i % TEX_W, ty = y0 + i / TEX_W;
            if (tx < w2 && ty < h2) out[ty * w2 + tx] = empty;
        }
        return;
    }
    for (int i = threadIdx.x; i < STAGE_H * STAGE_W; i += THREADS) {
        const int r = i / STAGE_W, c = i % STAGE_W;
        const unsigned long long w =
            __ldg(&depth[clamp_to(y0 - HALO + r, h2) * w2 + clamp_to(x0 - HALO + c, w2)]);
        stage[r][c] = __int_as_float(
            (int)((unsigned)(w >> 32) == epoch ? ~(unsigned)w : EMPTY_BITS));
    }
    // the tile's cells of each blocker grid, (cx0, cy0) the first, each
    // flagged where a cell within one of it is
    const int* g = flags;
    int cx0[N_BLOCKERS], cy0[N_BLOCKERS], ncx[N_BLOCKERS];
#pragma unroll
    for (int b = 0; b < N_BLOCKERS; ++b) {
        const int c = blocker_cell(b);
        const int gw = grid_w(w2, c), gh = grid_h(h2, c);
        const int x1 = (x0 + TEX_W < w2 ? x0 + TEX_W : w2) - 1;
        const int y1 = (y0 + TEX_H < h2 ? y0 + TEX_H : h2) - 1;
        cx0[b] = x0 / c + 2;
        cy0[b] = y0 / c + 2;
        ncx[b] = x1 / c + 2 - cx0[b] + 1;
        const int n = ncx[b] * (y1 / c + 2 - cy0[b] + 1);
        for (int i = threadIdx.x; i < n; i += THREADS) {
            const int cx = cx0[b] + i % ncx[b], cy = cy0[b] + i / ncx[b];
            bool on = false;
            for (int yy = cy - 1; yy <= cy + 1; ++yy)
                for (int xx = cx - 1; xx <= cx + 1; ++xx)
                    if (yy >= 0 && yy < gh && xx >= 0 && xx < gw &&
                        (unsigned)__ldg(&g[yy * gw + xx]) == epoch)
                        on = true;
            blocked[b][i] = on;
        }
        g += gw * gh;
    }
    const bool global = (unsigned)__ldg(g) == epoch;
    __syncthreads();
    for (int i = threadIdx.x; i < STAGE_H * TEX_W; i += THREADS) {
        const int r = i / TEX_W, c = i % TEX_W;
        float m = stage[r][c];
#pragma unroll
        for (int dx = 1; dx <= 2 * HALO; ++dx) m = fminf(m, stage[r][c + dx]);
        rows[r][c] = m;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TEX_W * TEX_H; i += THREADS) {
        const int c = i % TEX_W, r = i / TEX_W;
        const int tx = x0 + c, ty = y0 + r;
        if (tx >= w2 || ty >= h2) continue;
        float dmin = NO_SPLAT;
#pragma unroll
        for (int dy = 0; dy <= 2 * HALO; ++dy) dmin = fminf(dmin, rows[r + dy][c]);
        if (!(dmin < 1e7f)) dmin = 0.f;
#pragma unroll
        for (int b = 0; b < N_BLOCKERS; ++b) {
            const int cell = blocker_cell(b);
            if (blocked[b][(ty / cell + 2 - cy0[b]) * ncx[b] + tx / cell + 2 - cx0[b]])
                dmin = 0.f;
        }
        if (global) dmin = 0.f;
        out[ty * w2 + tx] = vhx::xla_max(__fsub_rn(dmin, P.margin), 0.f);
    }
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

// The int32 words of vhx_splat's scratch: a 64-bit distance word a texel,
// the blocker grids and the global flag, then a word a texel tile that a
// reliable center reached
extern "C" long long vhx_splat_scratch_words(int w2, int h2) {
    return 2LL * w2 * h2 + vhx_splat_block_words(w2, h2) +
           (long long)tex_tiles_x(w2) * tex_tiles_y(h2);
}

// Each 2 x 2 tile's start, f32 [h2, w2], from the centers `pts` (f32
// [n_points, 3]).  `scratch` (vhx_splat_scratch_words int32 words, 8 B
// aligned, zero when first used) is the passes' and stays from call to
// call on one stream: `epoch` is higher than that of every call before
// on it, and not 0.
extern "C" cudaError_t vhx_splat(const float* pts, const SplatParams* params, int* scratch,
                                 int epoch, float* out, int device, cudaStream_t stream) {
    const SplatParams& P = *params;
    if (P.w2 < 1 || P.h2 < 1 || P.n_points < 0 || (P.n_points && !pts) || !scratch || !out ||
        epoch < 1 || reinterpret_cast<uintptr_t>(scratch) % 8)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    auto* depth = reinterpret_cast<unsigned long long*>(scratch);
    int* flags = scratch + 2LL * P.w2 * P.h2;
    int* reached = flags + vhx_splat_block_words(P.w2, P.h2);
    const dim3 grid(tex_tiles_x(P.w2), tex_tiles_y(P.h2));
    if (P.n_points > 0) {
        splat_point_kernel<<<(P.n_points + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            pts, P, depth, flags, reached, (unsigned)epoch);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    if (grid.y > 65535) return cudaErrorInvalidValue;
    splat_texel_kernel<<<grid, THREADS, 0, stream>>>(P, depth, flags, reached, (unsigned)epoch,
                                                     out);
    return cudaGetLastError();
}
