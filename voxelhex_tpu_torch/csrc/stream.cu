// The streaming view's device updates of its resident window (a BitGrid of
// edge S): three kernels, each with its plain version in
// voxelhex_tpu_torch/ops/stream.py.
//
//   region_scatter   replaces `_make_region_scatter`
//                    (voxelhex_tpu/render/streaming.py:42): K paged regions
//                    of 16^3 voxels, each sent as its 12-byte corner, its
//                    colors (u8, or u16 past 254 palette colors) and its
//                    4^3 level-0 word pairs.  Every address is computed here
//                    from the corner, in the reference's layouts: a region's
//                    colors are rows of its [x, y, z] grid (z fastest), its
//                    word pairs rows of its [bz, by, bx] blocks (bx
//                    fastest).  The u8 wire's 255 and 254 widen to the u16
//                    sentinels 0xFFFF (empty) and 0xFFFE (no color).
//   coarse_rebuild   replaces `_make_coarse_rebuild` (:114) with
//                    `_jnp_pack_bits` (:89): pyramid level l + 1 from level
//                    l, one launch a level (64^3 -> 16^3 -> 4^3 -> 1 blocks
//                    at S = 256).  Bit s = cx + 4 cy + 16 cz of a word is set
//                    when its child block's pair is not zero; children past
//                    the edge of a level whose blocks an axis are not a
//                    multiple of 4 count as empty (the reference's pad).
//   window_shift     replaces `roll_zero` in `_shift_device` (:1073): the
//                    window's colors [S, S, S] move by -shift and its level-0
//                    pairs [S/4, S/4, S/4] by -shift / 4, the exposed slab
//                    filled with the empty color or 0, into other buffers:
//                    out[z, y, x] = in[z + sz, y + sy, x + sx] inside, the
//                    fill outside.  It never writes over its input.
//
// What bounds them on the H100: bytes.  A fly-over update pages about 1,500
// regions (6 MB of u8 colors in, 12 MB out), rebuilds from 2 MB of level-0
// pairs and shifts 33.5 MB of colors: each is a copy with arithmetic
// addresses, and the threads of a warp take consecutive x so that their
// writes (the scatter's, the shift's: 16 B of 8 colors a thread) or reads
// (the rebuild's children of one word are a 4 x 4 x 4 cube, read as four
// rows of 4) fall on a few sectors.  The scatter's wire rows are z fastest, so a warp's reads fall
// 256 B apart; its stores, twice the bytes, are the side kept contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int REGION = 16;                       // voxels a region edge
constexpr int RN = REGION / 4;                   // blocks a region edge
constexpr int REGION_VOXELS = REGION * REGION * REGION;
constexpr int REGION_BLOCKS = RN * RN * RN;
constexpr int THREADS = 256;
constexpr int COLOR_BLOCKS = REGION_VOXELS / THREADS;  // blocks a region's colors take

// One region a blockIdx.y: blocks 0..COLOR_BLOCKS-1 of it write its colors,
// voxel x fastest along the threads; the last one its word pairs.
template <class Wire>
__global__ void __launch_bounds__(THREADS)
region_scatter_kernel(unsigned short* __restrict__ colors, uint2* __restrict__ pairs,
                      const int* __restrict__ corners, const Wire* __restrict__ col_vals,
                      const uint2* __restrict__ blk_vals, int S) {
    const int k = blockIdx.y;
    const int cx = corners[3 * k], cy = corners[3 * k + 1], cz = corners[3 * k + 2];
    const int t = threadIdx.x;
    if (blockIdx.x < COLOR_BLOCKS) {
        const int r = blockIdx.x * THREADS + t;  // x + 16 y + 256 z in the region
        const int x = r % REGION, y = (r / REGION) % REGION, z = r / (REGION * REGION);
        // the wire row is the region's [x, y, z] grid, z fastest
        const unsigned v = col_vals[(long long)k * REGION_VOXELS + x * REGION * REGION +
                                    y * REGION + z];
        unsigned short c = (unsigned short)v;
        if (sizeof(Wire) == 1) c = v == 255u ? 0xFFFFu : (v == 254u ? 0xFFFEu : c);
        colors[(long long)(cx + x) + (long long)(cy + y) * S + (long long)(cz + z) * S * S] = c;
    } else if (t < REGION_BLOCKS) {
        const int nb = S / 4;
        const int bx = t % RN, by = (t / RN) % RN, bz = t / (RN * RN);
        pairs[(cx / 4 + bx) + (cy / 4 + by) * nb + (long long)(cz / 4 + bz) * nb * nb] =
            blk_vals[k * REGION_BLOCKS + t];
    }
}

// One word pair of level l + 1 a thread, from the 64 pairs of its child
// blocks at level l (`child` holds c^3 of them, the parent level n^3).
__global__ void __launch_bounds__(THREADS)
coarse_level_kernel(uint2* __restrict__ pairs, int child_base, int c, int parent_base, int n) {
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= n * n * n) return;
    const int bx = b % n, by = (b / n) % n, bz = b / (n * n);
    uint32_t lo = 0u, hi = 0u;
#pragma unroll 1
    for (int cz = 0; cz < 4; ++cz) {
        const int z = 4 * bz + cz;
#pragma unroll
        for (int cy = 0; cy < 4; ++cy) {
            const int y = 4 * by + cy;
#pragma unroll
            for (int cx = 0; cx < 4; ++cx) {
                const int x = 4 * bx + cx;
                if (x >= c || y >= c || z >= c) continue;
                const uint2 w = pairs[child_base + x + y * c + (long long)z * c * c];
                if ((w.x | w.y) == 0u) continue;
                const int s = cx + 4 * cy + 16 * cz;
                if (s < 32) lo |= 1u << s;
                else hi |= 1u << (s - 32);
            }
        }
    }
    pairs[parent_base + b] = make_uint2(lo, hi);
}

// in moved by -(sx, sy, sz) into out, for an n^3 grid x fastest: the index
// in `in` of entry (x, y, z) of `out`, or -1 where the move exposes it
__device__ __forceinline__ int shifted(int x, int y, int z, int n, int sx, int sy, int sz) {
    const int xs = x + sx, ys = y + sy, zs = z + sz;
    if (xs < 0 || xs >= n || ys < 0 || ys >= n || zs < 0 || zs >= n) return -1;
    return xs + (ys + zs * n) * n;
}

// The colors (an S^3 grid, the empty color where exposed) and the word pairs
// (the level-0 grid of (S/4)^3 moved, 0 where exposed; the other levels
// copied) in one launch: the first `color_blocks` blocks take the colors,
// V of them a thread (V = 8: one 16 B load and store, when S and sx are
// multiples of 8, so that the 8 colors move together).  32-bit indices:
// S^3 < 2^31 for the windows a view holds.
template <int V>
__global__ void __launch_bounds__(THREADS)
window_shift_kernel(const unsigned short* __restrict__ colors,
                    unsigned short* __restrict__ out_colors, const uint2* __restrict__ pairs,
                    uint2* __restrict__ out_pairs, int n_pairs, int S, int sx, int sy, int sz,
                    int color_blocks) {
    if ((int)blockIdx.x < color_blocks) {
        const int g = S / V;  // groups of V colors a row
        const int i = blockIdx.x * THREADS + threadIdx.x;
        if (i >= S * S * g) return;
        const int j = shifted(V * (i % g), (i / g) % S, i / (g * S), S, sx, sy, sz);
        if (V == 8) {
            const uint4 empty = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
            reinterpret_cast<uint4*>(out_colors)[i] =
                j < 0 ? empty : reinterpret_cast<const uint4*>(colors)[j / 8];
        } else {
            out_colors[i] = j < 0 ? (unsigned short)0xFFFFu : colors[j];
        }
    } else {
        const int nb = S / 4;
        const int i = (blockIdx.x - color_blocks) * THREADS + threadIdx.x;
        if (i >= n_pairs) return;
        if (i >= nb * nb * nb) {
            out_pairs[i] = pairs[i];
            return;
        }
        const int j = shifted(i % nb, (i / nb) % nb, i / (nb * nb), nb, sx / 4, sy / 4, sz / 4);
        out_pairs[i] = j < 0 ? make_uint2(0u, 0u) : pairs[j];
    }
}

}  // namespace

// K regions into the resident grids; `wide` says the colors are u16 (else u8).
extern "C" cudaError_t vhx_region_scatter(void* colors, void* pairs, const int* corners,
                                          const void* col_vals, const void* blk_vals, int K,
                                          int S, int wide, int device, cudaStream_t stream) {
    if (K < 0 || K > 65535 || S < REGION || S % REGION) return cudaErrorInvalidValue;
    if (K == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const dim3 grid(COLOR_BLOCKS + 1, K);
    if (wide)
        region_scatter_kernel<unsigned short><<<grid, THREADS, 0, stream>>>(
            static_cast<unsigned short*>(colors), static_cast<uint2*>(pairs), corners,
            static_cast<const unsigned short*>(col_vals), static_cast<const uint2*>(blk_vals), S);
    else
        region_scatter_kernel<unsigned char><<<grid, THREADS, 0, stream>>>(
            static_cast<unsigned short*>(colors), static_cast<uint2*>(pairs), corners,
            static_cast<const unsigned char*>(col_vals), static_cast<const uint2*>(blk_vals), S);
    return cudaGetLastError();
}

// Levels 1 .. n_levels - 1 of `pairs` from level 0, one launch a level, in
// turn; `bases` and `dims` are the pyramid's word-pair offsets and blocks an
// axis (traverse.cuh's level table).
extern "C" cudaError_t vhx_coarse_rebuild(void* pairs, const int* bases, const int* dims,
                                          int n_levels, int device, cudaStream_t stream) {
    if (n_levels < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    for (int l = 0; l + 1 < n_levels; ++l) {
        const int n = dims[l + 1];
        const int blocks = (n * n * n + THREADS - 1) / THREADS;
        coarse_level_kernel<<<blocks, THREADS, 0, stream>>>(static_cast<uint2*>(pairs), bases[l],
                                                           dims[l], bases[l + 1], n);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

// The window moved by (sx, sy, sz) voxels, multiples of 4: its colors [S^3]
// and word pairs [n_pairs] moved into out_colors and out_pairs.
extern "C" cudaError_t vhx_window_shift(const void* colors, void* out_colors, const void* pairs,
                                        void* out_pairs, int n_pairs, int S, int sx, int sy,
                                        int sz, int device, cudaStream_t stream) {
    const long long nb = S / 4;
    if (S < 4 || S % 4 || S > 1024 || sx % 4 || sy % 4 || sz % 4 || n_pairs < nb * nb * nb)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const bool wide = S % 8 == 0 && sx % 8 == 0;
    const long long groups = (long long)S * S * (wide ? S / 8 : S);
    const int color_blocks = (int)((groups + THREADS - 1) / THREADS);
    const int pair_blocks = (n_pairs + THREADS - 1) / THREADS;
    const unsigned short* c = static_cast<const unsigned short*>(colors);
    unsigned short* oc = static_cast<unsigned short*>(out_colors);
    const uint2* p = static_cast<const uint2*>(pairs);
    uint2* op = static_cast<uint2*>(out_pairs);
    if (wide)
        window_shift_kernel<8><<<color_blocks + pair_blocks, THREADS, 0, stream>>>(
            c, oc, p, op, n_pairs, S, sx, sy, sz, color_blocks);
    else
        window_shift_kernel<1><<<color_blocks + pair_blocks, THREADS, 0, stream>>>(
            c, oc, p, op, n_pairs, S, sx, sy, sz, color_blocks);
    return cudaGetLastError();
}
