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
//                    `_jnp_pack_bits` (:89): every pyramid level above level
//                    0 from level 0 (64^3 -> 16^3 -> 4^3 -> 1 blocks at S =
//                    256), in one launch.  Bit s = cx + 4 cy + 16 cz of a
//                    word is set when its child block's pair is not zero;
//                    children past the edge of a level whose blocks an axis
//                    are not a multiple of 4 count as empty (the reference's
//                    pad).  A warp makes a word: lane l reads children l and
//                    l + 32 (four lanes a 32 B row of pairs), and the
//                    ballots of "not zero" are the word's two halves.  A
//                    block makes the 64 level-1 words under one level-2
//                    word, then that word from shared memory; the last block
//                    to finish (a ticket: a fence, then an atomic add on a
//                    counter that it sets back to 0) makes the levels above
//                    from the level-2 words.
//   window_shift     replaces `roll_zero` in `_shift_device` (:1073): the
//                    window's colors [S, S, S] move by -shift and its level-0
//                    pairs [S/4, S/4, S/4] by -shift / 4, the exposed slab
//                    filled with the empty color or 0, into other buffers:
//                    out[z, y, x] = in[z + sz, y + sy, x + sx] inside, the
//                    fill outside.  It never writes over its input.
//
//   skip_rows        replaces `_skip_rows_from_pairs_jit` (voxelhex_tpu/
//                    render/bitgrid.py:848, run at :432-441 and
//                    :1359-1382): under the skip tracer, the rows of every
//                    level-0 block (level k's pair of its ancestor in
//                    columns 2k, 2k + 1: 64^3 rows of 4 pairs, 8 MiB, at S =
//                    256) from the word pairs, after a change of the pairs.
//                    The ancestor's index is computed from the block's
//                    coordinates, not read from an index array.
//
// What bounds them on the H100: bytes.  A fly-over update pages about 1,500
// regions (6 MB of u8 colors in, 12 MB out), rebuilds from 2 MB of level-0
// pairs and shifts 33.5 MB of colors: each is a copy with arithmetic
// addresses, laid out so that a warp's loads and stores fall on few
// sectors, each used whole.  The scatter is a block a region (one wave of
// blocks for a fly-over update), a thread a (y, z) row of it: the wire is z
// fastest, so for one x a warp's 32 threads read 32 consecutive wire values,
// and the row's 16 colors, x fastest in the window, leave as one 32 B
// sector; the region's word pairs leave as 16 B words.  The shift moves
// 16 B of 8 colors a thread.  The rebuild's children of one word are a 4 x
// 4 x 4 cube, read as rows of 4; its work is a few microseconds' of reads,
// less than a launch: it is one launch, and each thread issues all of its
// level-0 loads before its first ballot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int REGION = 16;                       // voxels a region edge
constexpr int RN = REGION / 4;                   // blocks a region edge
constexpr int REGION_VOXELS = REGION * REGION * REGION;
constexpr int REGION_BLOCKS = RN * RN * RN;
constexpr int THREADS = 256;

constexpr int SCATTER_THREADS = 128;                  // threads a region (a block)
constexpr int ROWS = REGION * REGION;                  // (y, z) rows a region
constexpr int ROWS_A_THREAD = ROWS / SCATTER_THREADS;
constexpr unsigned FULL = 0xffffffffu;

// A wire color as the window's u16: the u8 wire's 255 and 254 widen to the
// sentinels 0xFFFF and 0xFFFE, every other value is itself.
__device__ __forceinline__ unsigned widen(unsigned v, bool wide) {
    return wide || v < 254u ? v : 0xFF00u | v;
}

// One region a block (a fly-over update's 1,536 blocks are one wave).  The
// region's wire is staged in shared memory by 16 B loads.  Thread t then
// takes the (y, z) rows 16 y + z = t + j SCATTER_THREADS: it reads the row's
// 16 colors x = 0..15 (for one x a warp reads 32 consecutive wire values:
// no bank conflicts) and widens them.  A row is 32 B of the window's
// x-fastest colors, one sector (the corner's x and S are multiples of 16).
// Lanes 2i and 2i + 1 hold rows z and z + 1; they trade halves, and each
// stores 16 B of both rows, so that a store instruction writes 16 whole
// sectors (a thread storing its own row in two halves writes 32 half
// sectors an instruction: 1.7 times the kernel's time).  The
// first 32 threads store the region's 64 word pairs, two a thread as one
// 16 B word (a block row of 4 pairs is 32 B, as cx / 4 is a multiple of 4).
// Every address comes from the corner, which the caller keeps to multiples
// of 16 in [0, S - 16] (ops/stream.py checks it).
template <class Wire>
__global__ void __launch_bounds__(SCATTER_THREADS)
region_scatter_kernel(unsigned short* __restrict__ colors, uint2* __restrict__ pairs,
                      const int* __restrict__ corners, const Wire* __restrict__ col_vals,
                      const uint2* __restrict__ blk_vals, int S) {
    constexpr bool wide = sizeof(Wire) == 2;
    constexpr int WORDS = REGION_VOXELS * (int)sizeof(Wire) / 16;  // the wire's 16 B words
    static_assert(WORDS % SCATTER_THREADS == 0 && ROWS % SCATTER_THREADS == 0, "whole words");
    __shared__ uint4 stage[WORDS];
    const int k = blockIdx.x, t = threadIdx.x;
    const uint4* wire = reinterpret_cast<const uint4*>(col_vals) + (long long)k * WORDS;
#pragma unroll
    for (int i = 0; i < WORDS / SCATTER_THREADS; ++i)
        stage[t + i * SCATTER_THREADS] = __ldg(wire + t + i * SCATTER_THREADS);
    const int cx = __ldg(corners + 3 * k), cy = __ldg(corners + 3 * k + 1),
              cz = __ldg(corners + 3 * k + 2);
    if (t < REGION_BLOCKS / 2) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(blk_vals) + k * REGION_BLOCKS / 2 + t);
        const int nb = S / 4;
        const int bx = 2 * (t & 1), by = (t >> 1) % RN, bz = t / (2 * RN);
        *reinterpret_cast<uint4*>(pairs + (cx / 4 + bx) + (long long)(cy / 4 + by) * nb +
                                  (long long)(cz / 4 + bz) * nb * nb) = w;
    }
    __syncthreads();
    const Wire* from = reinterpret_cast<const Wire*>(stage);
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < ROWS_A_THREAD; ++j) {
        const int row = t + j * SCATTER_THREADS, y = row / REGION, z = row % REGION;
        unsigned w[REGION / 2];
#pragma unroll
        for (int i = 0; i < REGION / 2; ++i)
            w[i] = widen(from[2 * i * ROWS + row], wide) |
                   widen(from[(2 * i + 1) * ROWS + row], wide) << 16;
        // the even lane stores the first halves of rows z and z + 1, the odd
        // lane the second halves: each gives the other the half it stores
        unsigned got[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            got[i] = __shfl_sync(FULL, odd ? w[i] : w[4 + i], (t & 31) ^ 1);
        unsigned short* row_z = colors + cx + 8 * odd + (long long)(cy + y) * S +
                                (long long)(cz + (z & ~1)) * S * S;
        const uint4 mine = odd ? make_uint4(w[4], w[5], w[6], w[7])
                               : make_uint4(w[0], w[1], w[2], w[3]);
        const uint4 theirs = make_uint4(got[0], got[1], got[2], got[3]);
        // __stwb keeps each a 16 B store: a plain assignment of the select
        // was compiled into a 16 B store in half the lanes and four 4 B
        // stores in the other half, at 3.8 times the kernel's time
        __stwb(reinterpret_cast<uint4*>(row_z), odd ? theirs : mine);
        __stwb(reinterpret_cast<uint4*>(row_z + (long long)S * S), odd ? mine : theirs);
    }
}

constexpr int MAX_LEVELS = 12;  // VHX_MAX_LEVELS in traverse.cuh
constexpr int REBUILD_THREADS = 256;
constexpr int REBUILD_WARPS = REBUILD_THREADS / 32;
constexpr int WORDS_A_WARP = 64 / REBUILD_WARPS;  // level-1 words a warp makes

// A pyramid's level table: word-pair offset and blocks an axis of each level
struct Pyramid {
    int n_levels;
    int bases[MAX_LEVELS];
    int dims[MAX_LEVELS];
};

// Whether child s = lane + 32 h (h = 0, 1) of the parent block (bx, by, bz)
// is not zero, at a level of c^3 blocks from `child`; past the edge, empty.
__device__ __forceinline__ bool child_set(const uint2* child, int c, int bx, int by, int bz,
                                          int lane, int h) {
    const int x = 4 * bx + (lane & 3), y = 4 * by + ((lane >> 2) & 3),
              z = 4 * bz + (lane >> 4) + 2 * h;
    if (x >= c || y >= c || z >= c) return false;
    const uint2 w = __ldcg(&child[x + (long long)y * c + (long long)z * c * c]);
    return (w.x | w.y) != 0u;
}

// The word pair of the parent block (bx, by, bz) over a child level of c^3
// blocks, made by the whole warp: bit s is lane s's ballot (s < 32, the low
// word) or lane s - 32's (the high word).
__device__ __forceinline__ uint2 parent_word(const uint2* child, int c, int bx, int by, int bz,
                                             int lane) {
    const bool lo = child_set(child, c, bx, by, bz, lane, 0);
    const bool hi = child_set(child, c, bx, by, bz, lane, 1);
    return make_uint2(__ballot_sync(FULL, lo), __ballot_sync(FULL, hi));
}

// Block q makes the level-1 words under level-2 word q (a pyramid of two
// levels: the one level-1 word, one block) and word q itself; the last
// block to finish makes levels 3 .. n_levels - 1.  `tickets` is 0 before
// the launch and after it.
__global__ void __launch_bounds__(REBUILD_THREADS)
coarse_kernel(uint2* __restrict__ pairs, const __grid_constant__ Pyramid P,
              int* __restrict__ tickets) {
    __shared__ unsigned char set[64];  // the block's level-1 words that are not zero
    __shared__ bool last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n2 = P.n_levels > 2 ? P.dims[2] : 1;
    const int q = blockIdx.x;
    const int qx = q % n2, qy = q / n2 % n2, qz = q / (n2 * n2);
    const int c0 = P.dims[0], c1 = P.dims[1];
    const uint2* level0 = pairs + P.bases[0];
    // level 1: word s of the 64 under q is made by warp s % REBUILD_WARPS in
    // turn s / REBUILD_WARPS; every load first, then the ballots
    bool lo[WORDS_A_WARP], hi[WORDS_A_WARP];
#pragma unroll
    for (int k = 0; k < WORDS_A_WARP; ++k) {
        const int s = warp + REBUILD_WARPS * k;
        const int bx = 4 * qx + (s & 3), by = 4 * qy + (s >> 2 & 3), bz = 4 * qz + (s >> 4);
        const bool in = bx < c1 && by < c1 && bz < c1;
        lo[k] = in && child_set(level0, c0, bx, by, bz, lane, 0);
        hi[k] = in && child_set(level0, c0, bx, by, bz, lane, 1);
    }
#pragma unroll
    for (int k = 0; k < WORDS_A_WARP; ++k) {
        const int s = warp + REBUILD_WARPS * k;
        const int bx = 4 * qx + (s & 3), by = 4 * qy + (s >> 2 & 3), bz = 4 * qz + (s >> 4);
        const uint2 w = make_uint2(__ballot_sync(FULL, lo[k]), __ballot_sync(FULL, hi[k]));
        if (lane == 0) {
            if (bx < c1 && by < c1 && bz < c1)
                pairs[P.bases[1] + bx + (long long)by * c1 + (long long)bz * c1 * c1] = w;
            set[s] = (w.x | w.y) != 0u;
        }
    }
    __syncthreads();
    if (P.n_levels <= 2) return;
    if (warp == 0) {  // level 2: word q from the 64 below it
        const uint2 w =
            make_uint2(__ballot_sync(FULL, set[lane]), __ballot_sync(FULL, set[lane + 32]));
        if (lane == 0) {
            pairs[P.bases[2] + q] = w;
            __threadfence();  // word q is seen before the ticket
            last = atomicAdd(tickets, 1) == (int)gridDim.x - 1;
        }
    }
    __syncthreads();
    if (!last) return;
    // the last block: every level-2 word is written; the levels above
    __threadfence();
    for (int L = 3; L < P.n_levels; ++L) {
        const int n = P.dims[L], c = P.dims[L - 1];
        for (int b = warp; b < n * n * n; b += REBUILD_WARPS) {
            const uint2 w = parent_word(pairs + P.bases[L - 1], c, b % n, b / n % n, b / (n * n),
                                        lane);
            if (lane == 0) pairs[P.bases[L] + b] = w;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) *tickets = 0;
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

// Row a's pair of level k, a thread a (a, k): the pair of a's ancestor at
// level k.  A block row of the grid is one (ay, az) line of rows (blockIdx.y
// = ay, blockIdx.z = az), its n0 * L pairs in the threads in order, so a
// warp writes 256 consecutive bytes and a row's address takes no division
// but by L, a template parameter; the level's table entry is picked with
// constant indices.  The pairs of the upper levels are few and stay in the
// caches.
template <int L>
__global__ void __launch_bounds__(THREADS)
skip_rows_kernel(const uint2* __restrict__ pairs, uint2* __restrict__ rows, const Pyramid P,
                 int n0) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n0 * L) return;
    const int k = i % L, ax = i / L, ay = blockIdx.y, az = blockIdx.z;
    int j = 0;
#pragma unroll
    for (int kk = 0; kk < L; ++kk)
        if (kk == k) {
            const int n = P.dims[kk];
            j = P.bases[kk] + (ax >> (2 * kk)) + ((ay >> (2 * kk)) + (az >> (2 * kk)) * n) * n;
        }
    rows[((long long)az * n0 + ay) * n0 * L + i] = __ldg(&pairs[j]);
}

}  // namespace

// The skip rows [n0^3, n_levels] of word pairs (n0 = dims[0], the level-0
// blocks an axis) from `pairs`, the pyramid's word pairs of `bases` and
// `dims` (each level's dims ceil(dims below / 4)); rows 16 B aligned.
extern "C" cudaError_t vhx_skip_rows(const void* pairs, void* rows, const int* bases,
                                     const int* dims, int n_levels, int device,
                                     cudaStream_t stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS || reinterpret_cast<uintptr_t>(rows) % 16)
        return cudaErrorInvalidValue;
    Pyramid P;
    P.n_levels = n_levels;
    for (int l = 0; l < n_levels; ++l) {
        if (dims[l] < 1 || (l > 0 && dims[l] != (dims[l - 1] + 3) / 4))
            return cudaErrorInvalidValue;
        P.bases[l] = bases[l];
        P.dims[l] = dims[l];
    }
    const int n0 = dims[0];
    if (n0 > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const dim3 grid((n0 * n_levels + THREADS - 1) / THREADS, n0, n0);
    const auto* pr = static_cast<const uint2*>(pairs);
    auto* out = static_cast<uint2*>(rows);
    switch (n_levels) {
#define VHX_ROWS(n) \
    case n: skip_rows_kernel<n><<<grid, THREADS, 0, stream>>>(pr, out, P, n0); break;
        VHX_ROWS(1) VHX_ROWS(2) VHX_ROWS(3) VHX_ROWS(4) VHX_ROWS(5) VHX_ROWS(6)
        VHX_ROWS(7) VHX_ROWS(8) VHX_ROWS(9) VHX_ROWS(10) VHX_ROWS(11) VHX_ROWS(12)
#undef VHX_ROWS
    }
    return cudaGetLastError();
}

// K regions into the resident grids; `wide` says the colors are u16 (else
// u8).  The grids, the wire and the pairs are 16 B aligned; each corner is
// a multiple of 16 in [0, S - 16] on every axis, which the kernel relies on
// and does not check (the caller does, before the corners reach the card).
extern "C" cudaError_t vhx_region_scatter(void* colors, void* pairs, const int* corners,
                                          const void* col_vals, const void* blk_vals, int K,
                                          int S, int wide, int device, cudaStream_t stream) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16; };
    if (K < 0 || S < REGION || S % REGION || misaligned(colors) || misaligned(pairs) ||
        misaligned(col_vals) || misaligned(blk_vals))
        return cudaErrorInvalidValue;
    if (K == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (wide)
        region_scatter_kernel<unsigned short><<<K, SCATTER_THREADS, 0, stream>>>(
            static_cast<unsigned short*>(colors), static_cast<uint2*>(pairs), corners,
            static_cast<const unsigned short*>(col_vals), static_cast<const uint2*>(blk_vals), S);
    else
        region_scatter_kernel<unsigned char><<<K, SCATTER_THREADS, 0, stream>>>(
            static_cast<unsigned short*>(colors), static_cast<uint2*>(pairs), corners,
            static_cast<const unsigned char*>(col_vals), static_cast<const uint2*>(blk_vals), S);
    return cudaGetLastError();
}

// Levels 1 .. n_levels - 1 of `pairs` from level 0 in one launch; `bases`
// and `dims` are the pyramid's word-pair offsets and blocks an axis
// (traverse.cuh's level table), each level's dims ceil(dims below / 4);
// `tickets` is one int, 0, that the launch leaves at 0 (launches that share
// it are ordered on one stream).
extern "C" cudaError_t vhx_coarse_rebuild(void* pairs, const int* bases, const int* dims,
                                          int n_levels, int* tickets, int device,
                                          cudaStream_t stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return cudaErrorInvalidValue;
    Pyramid P;
    P.n_levels = n_levels;
    for (int l = 0; l < n_levels; ++l) {
        if (dims[l] < 1 || (l > 0 && dims[l] != (dims[l - 1] + 3) / 4))
            return cudaErrorInvalidValue;
        P.bases[l] = bases[l];
        P.dims[l] = dims[l];
    }
    if (n_levels == 1) return cudaSuccess;
    const long long n2 = n_levels > 2 ? dims[2] : 1;
    if (n2 * n2 * n2 > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int blocks = (int)(n2 * n2 * n2);
    coarse_kernel<<<blocks, REBUILD_THREADS, 0, stream>>>(static_cast<uint2*>(pairs), P, tickets);
    return cudaGetLastError();
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
