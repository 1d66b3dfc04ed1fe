// The BitGrid automaton of one ray, shared by the traversal kernel
// (traverse.cu) and the frame kernel (frame.cu).
//
// It computes what the production tracer computes (`make_bitgrid_tracer`,
// voxelhex_tpu/render/bitgrid.py:482-808): clip to the world box, then the
// PUSH/POP/ADVANCE sectant automaton with restarts, lateral steps, DDA
// substeps inside a block, the impact normal and the color lookup.
//
// Exactness: the expressions keep the reference's operation order, and the
// files are built with -fmad=false so that only the multiply-adds written
// here as __fmaf_rn are fused: exactly those that XLA:CPU fuses in the
// reference.  Where the reference divides by a cell or block edge (a power
// of two, 4^k with k <= 12), the code multiplies by the exact reciprocal:
// both round the same exact value, so the results are the same bits.  The
// loop stops after `max_iters` iterations whatever the ray does, and a ray
// restarts at most MAX_RESTARTS times.
//
// The tracer settings are those of the reference renderer
// (BitGridRenderer.__init__): lateral steps on, MAX_RESTARTS restarts,
// ADVANCE_SUBSTEPS DDA substeps per ADVANCE.  They are fixed here; only
// `max_iters` is a launch parameter.
//
// The per-level table (word-pair base, blocks per axis) is read with a
// per-thread level.  Indexed that way inside the launch parameters it would
// be copied to each thread's local memory (a 112 B stack frame), so every
// kernel copies it to shared memory first (load_levels), with constant
// indices only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VHX_MAX_LEVELS 12

struct TraceParams {
    int n_levels;
    int bases[VHX_MAX_LEVELS];  // word-pair offset of each level
    int dims[VHX_MAX_LEVELS];   // blocks per axis of each level
    int size;                   // world extent in voxels
    int n_blocks;               // rows of occ_pairs
    int max_iters;
};

namespace vhx {

constexpr int MAX_RESTARTS = 4;
constexpr int ADVANCE_SUBSTEPS = 4;
constexpr int OOB = 64;
constexpr float BIG = 1e30f;
constexpr int NO_COLOR_HIT = 0x3FFFFFFE;
constexpr int EMPTY_DESC = -1;
constexpr int COLOR_NONE = 0xFFFE;

// jnp.sign: +-1, and zero (with its sign) or NaN as given
__device__ __forceinline__ float sgn(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// XLA max: NaN propagates, +0 > -0
__device__ __forceinline__ float xla_max(float a, float b) {
    if (a != a || a > b || (a == b && !signbit(a))) return a;
    return b;
}

// jnp.fmin / jnp.fmax: NaN loses, a tie takes the second operand
__device__ __forceinline__ float fmin_nan(float a, float b) {
    return (a < b || b != b) ? a : b;
}
__device__ __forceinline__ float fmax_nan(float a, float b) {
    return (a > b || b != b) ? a : b;
}

// 4^k and 4^-k as f32 (0 <= k <= 13), exact, from the exponent bits
__device__ __forceinline__ float pow4(int k) { return __int_as_float((127 + 2 * k) << 23); }
__device__ __forceinline__ float inv_pow4(int k) { return __int_as_float((127 - 2 * k) << 23); }

// clip(floor(x), 0, 3) as int; NaN -> 0
__device__ __forceinline__ int cell_index(float x) {
    float f = floorf(x);
    if (f != f) return 0;
    return (int)fminf(fmaxf(f, 0.f), 3.f);
}

// the sectant of `off` in a block of edge 1 / inv_size (a power of two):
// (off * 4) * inv_size is (off * 4) / size, bit for bit
__device__ __forceinline__ int offset_sectant(const float off[3], float inv_size) {
    int ix = cell_index(__fmul_rn(__fmul_rn(off[0], 4.f), inv_size));
    int iy = cell_index(__fmul_rn(__fmul_rn(off[1], 4.f), inv_size));
    int iz = cell_index(__fmul_rn(__fmul_rn(off[2], 4.f), inv_size));
    return ix + iy * 4 + iz * 16;
}

__device__ __forceinline__ void sectant_offset(int s, float out[3]) {
    out[0] = (float)(s % 4) * 0.25f;
    out[1] = (float)((s / 4) % 4) * 0.25f;
    out[2] = (float)(s / 16) * 0.25f;
}

__device__ __forceinline__ int clamp63(int s) { return s < 0 ? 0 : (s > 63 ? 63 : s); }

__device__ __forceinline__ int step_sectant(int s, const float step[3]) {
    int x = s % 4 + (int)sgn(step[0]);
    int y = (s / 4) % 4 + (int)sgn(step[1]);
    int z = s / 16 + (int)sgn(step[2]);
    bool inside = x >= 0 && x < 4 && y >= 0 && y < 4 && z >= 0 && z < 4;
    return inside ? x + y * 4 + z * 16 : OOB;
}

__device__ __forceinline__ bool occ_bit(uint32_t lo, uint32_t hi, int s) {
    s = clamp63(s);
    uint32_t word = s < 32 ? lo : hi;
    return ((word >> (s & 31)) & 1u) != 0u;
}

// the sectants a ray entering at `t` with direction octant `octant` can
// still reach, as (lo, hi) words
__device__ __forceinline__ void reach_mask(int t, int octant, uint32_t& m_lo, uint32_t& m_hi) {
    const uint32_t ones = 0xFFFFFFFFu;
    int sx = t % 4, sy = (t / 4) % 4, sz = t / 16;
    uint32_t xm4 = (octant & 1) ? ((0xFu << sx) & 0xFu) : (0xFu >> (3 - sx));
    uint32_t x32 = xm4 * 0x11111111u;
    uint32_t ym16 = (octant & 4) ? ((0xFFFFu << (sy * 4)) & 0xFFFFu) : (0xFFFFu >> ((3 - sy) * 4));
    uint32_t y32 = ym16 * 0x00010001u;
    uint32_t z_lo, z_hi;
    if (octant & 2) {
        z_lo = sz < 2 ? (ones << (sz * 16)) : 0u;
        z_hi = sz < 2 ? ones : (ones << ((sz - 2) * 16));
    } else {
        z_lo = sz < 2 ? (ones >> ((1 - sz) * 16)) : ones;
        z_hi = sz < 2 ? 0u : (ones >> ((3 - sz) * 16));
    }
    m_lo = x32 & y32 & z_lo;
    m_hi = x32 & y32 & z_hi;
}

// one DDA step to the nearest face of the cell [cmin, cmin + csize)
__device__ __forceinline__ void dda_step(const float d[3], const float sf[3], const float p[3],
                                         const float cmin[3], float csize,
                                         float new_p[3], float step[3]) {
    float sg[3], dist[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        sg[c] = sgn(d[c]);
        float need = __fsub_rn(__fmul_rn(csize, xla_max(sg[c], 0.f)),
                               __fmul_rn(sg[c], __fsub_rn(p[c], cmin[c])));
        float dd = fabsf(__fmul_rn(need, sf[c]));
        if (d[c] == 0.f) dd = BIG;
        if (dd != dd) dd = BIG;
        dist[c] = dd;
    }
    float m = fminf(fminf(dist[0], dist[1]), dist[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        new_p[c] = __fmaf_rn(d[c], m, p[c]);
        step[c] = dist[c] == m ? sg[c] : 0.f;
    }
}

__device__ __forceinline__ void impact_normal(const float tmin[3], float tsize, const float p[3],
                                              float out[3]) {
    float mid[3], a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        mid[c] = __fsub_rn(__fadd_rn(tmin[c], __fmul_rn(tsize, 0.5f)), p[c]);  // tsize / 2
        a[c] = fabsf(mid[c]);
    }
    float m = fmaxf(fmaxf(a[0], a[1]), a[2]);
    float n[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = a[c] == m ? -mid[c] : 0.f;
    float sq = __fmaf_rn(n[2], n[2], __fmaf_rn(n[1], n[1], __fmul_rn(n[0], n[0])));
    float den = xla_max(__fsqrt_rn(sq), 1e-12f);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = __fdiv_rn(n[c], den);
}

// x - jnp.mod(x, y) for y = 1 / inv_y a power of two: the min corner of
// the y-block that holds x.  The reference computes jnp.mod with fmodf and
// a sign fix; x - floor(x * inv_y) * y is the same value without the
// software fmodf: x * inv_y and the product by y are exact (power-of-two
// scaling), and the difference is exact by Sterbenz's lemma for x >= 0, or
// is the same exact value rounded once for x < 0; a zero takes the sign
// fmodf gives it (that of x), and NaN and +-inf give NaN as fmodf does.  The
// one exception is a negative subnormal x, where x * inv_y can round to
// -0; the block minima this sees are non-negative multiples of the block
// edge, or NaN.
__device__ __forceinline__ float block_floor(float x, float y, float inv_y) {
    float r = __fsub_rn(x, __fmul_rn(floorf(__fmul_rn(x, inv_y)), y));
    if (r == 0.f) r = copysignf(0.f, x);
    return __fsub_rn(x, r);
}

// the (lo, hi) words of the level-`level` block whose min corner is `bmin`;
// `levels` holds (word-pair base, blocks per axis) of each level
__device__ __forceinline__ void fetch(const uint2* __restrict__ occ, const int2* levels,
                                      int n_blocks, int level, const float bmin[3],
                                      uint32_t& lo, uint32_t& hi) {
    const float inv_bs = inv_pow4(level + 1);  // 1 / block edge
    const int2 lv = levels[level];
    const int n = lv.y;
    int addr = lv.x + (int)floorf(__fmul_rn(bmin[0], inv_bs))
             + (int)floorf(__fmul_rn(bmin[1], inv_bs)) * n
             + (int)floorf(__fmul_rn(bmin[2], inv_bs)) * n * n;
    addr = addr < 0 ? 0 : (addr > n_blocks - 1 ? n_blocks - 1 : addr);
    uint2 w = __ldg(&occ[addr]);
    lo = w.x;
    hi = w.y;
}

// Copy the level table of `P` to shared memory `levels` and wait for the
// block.  Call it before any thread of the block returns.  One thread
// copies every entry, with constant indices into the parameters: indexed
// by a thread's id, the parameters would be copied to local memory first.
__device__ __forceinline__ void load_levels(const TraceParams& P, int2* levels) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < VHX_MAX_LEVELS; ++i) levels[i] = make_int2(P.bases[i], P.dims[i]);
    }
    __syncthreads();
}

// What one ray ends with
struct Hit {
    bool hit;
    int voxel;     // color index of the hit voxel, NO_COLOR_HIT, or EMPTY_DESC on a miss
    int hvox[3];   // the hit voxel
    float point[3];
    float normal[3];
};

// March the ray (o, d) through the pyramid: the reference's `trace` of one ray.
__device__ __forceinline__ Hit march(const float o[3], const float d[3],
                                     const uint2* __restrict__ occ,
                                     const unsigned short* __restrict__ colors,
                                     const int2* levels, int n_levels, int size, int n_blocks,
                                     int max_iters) {
    const float S = (float)size;
    const int top = n_levels - 1;
    const float top_cell = pow4(top);
    const float top_block = top_cell * 4.f;
    const float inv_top_block = inv_pow4(top + 1);

    // ---- init: clip to the world box, enter at the top level
    float sf[3];
    {
        float a = __fdiv_rn(d[2], d[0]), b = __fdiv_rn(d[1], d[0]);
        sf[0] = __fsqrt_rn(__fmaf_rn(b, b, __fmaf_rn(a, a, 1.f)));
        a = __fdiv_rn(d[0], d[1]);
        b = __fdiv_rn(d[2], d[1]);
        sf[1] = __fsqrt_rn(__fmaf_rn(b, b, __fmaf_rn(a, a, 1.f)));
        a = __fdiv_rn(d[0], d[2]);
        b = __fdiv_rn(d[1], d[2]);
        sf[2] = __fsqrt_rn(__fadd_rn(__fmaf_rn(a, a, __fmul_rn(b, b)), 1.f));
    }
    const int octant = (d[0] >= 0.f ? 1 : 0) + (d[2] >= 0.f ? 2 : 0) + (d[1] >= 0.f ? 4 : 0);
    float pmin[3], pmax[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float t_lo = __fdiv_rn(__fsub_rn(0.f, o[c]), d[c]);
        float t_hi = __fdiv_rn(__fsub_rn(S, o[c]), d[c]);
        pmin[c] = fmin_nan(t_lo, t_hi);
        pmax[c] = fmax_nan(t_lo, t_hi);
    }
    const float tmin_r = fmax_nan(fmax_nan(pmin[0], pmin[1]), pmin[2]);
    const float tmax_r = fmin_nan(fmin_nan(pmax[0], pmax[1]), pmax[2]);
    bool active = !((tmax_r < 0.f) || (tmin_r > tmax_r));
    const float enter = xla_max(tmin_r, 0.f);
    float p[3];
    // the reference fuses this multiply-add on x and y, not on z
    p[0] = __fmaf_rn(d[0], enter, o[0]);
    p[1] = __fmaf_rn(d[1], enter, o[1]);
    p[2] = __fadd_rn(o[2], __fmul_rn(d[2], enter));

    int level = top;  // the cell edge tsize is 4^level throughout
    float bmin[3] = {0.f, 0.f, 0.f};
    uint32_t lo, hi;
    fetch(occ, levels, n_blocks, top, bmin, lo, hi);
    int tsect = active ? offset_sectant(p, inv_top_block) : OOB;
    float tmin[3];
    sectant_offset(clamp63(tsect), tmin);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmin[c] = __fmul_rn(tmin[c], top_block);
    float tsize = top_cell;
    Hit out;
    out.hit = false;
    out.hvox[0] = out.hvox[1] = out.hvox[2] = 0;
    out.normal[0] = out.normal[1] = out.normal[2] = 0.f;
    int restarts = 0;

    // ---- the automaton, at most max_iters steps
    for (int it = 0; active && it < max_iters; ++it) {
        const bool inb = tsect < OOB;
        const bool occupied = occ_bit(lo, hi, tsect);
        const bool at_bottom = level <= 0;
        if (occupied && at_bottom && inb) {
            out.hit = true;
#pragma unroll
            for (int c = 0; c < 3; ++c) out.hvox[c] = (int)tmin[c];
            impact_normal(tmin, tsize, p, out.normal);
            break;
        }
        uint32_t m_lo, m_hi;
        reach_mask(clamp63(tsect), octant, m_lo, m_hi);
        const bool no_overlap = ((lo & m_lo) == 0u) && ((hi & m_hi) == 0u);
        const bool descend = occupied && !at_bottom && inb;
        const bool lateral = !inb && !descend;
        const bool ascend = no_overlap && !descend && !lateral;
        const float block = tsize * 4.f;
        const float inv_block = inv_pow4(level + 1);
        bool moved = true;
        if (descend) {
            float off[3], so[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) off[c] = __fsub_rn(p[c], tmin[c]);
            const int d_tsect = offset_sectant(off, inv_pow4(level));
            sectant_offset(d_tsect, so);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                bmin[c] = tmin[c];
                tmin[c] = __fadd_rn(tmin[c], __fmul_rn(so[c], tsize));
            }
            tsect = d_tsect;
            tsize = __fmul_rn(tsize, 0.25f);  // tsize / 4
            level -= 1;
        } else if (ascend) {
            const float parent_block = block * 4.f;
            const float inv_parent = inv_pow4(level + 2);
            float pmin_[3], off[3], np[3], st[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                pmin_[c] = block_floor(bmin[c], parent_block, inv_parent);
                off[c] = __fsub_rn(__fadd_rn(bmin[c], __fmul_rn(block, 0.5f)), pmin_[c]);
            }
            const int a_ts0 = offset_sectant(off, inv_parent);
            dda_step(d, sf, p, bmin, block, np, st);
            tsect = step_sectant(a_ts0, st);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                p[c] = np[c];
                tmin[c] = __fadd_rn(bmin[c], __fmul_rn(st[c], block));
                bmin[c] = pmin_[c];
            }
            tsize = block;
            level += 1;
        } else if (lateral) {
            float np[3], st[3], lb[3], off[3], so[3];
            dda_step(d, sf, p, bmin, block, np, st);
            bool outside = false;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                lb[c] = __fadd_rn(bmin[c], __fmul_rn(st[c], block));
                outside = outside || lb[c] < 0.f || lb[c] >= S;
            }
            if (outside) break;  // the neighbor block lies outside the world
#pragma unroll
            for (int c = 0; c < 3; ++c) off[c] = __fsub_rn(np[c], lb[c]);
            tsect = offset_sectant(off, inv_block);
            sectant_offset(clamp63(tsect), so);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                p[c] = np[c];
                tmin[c] = __fadd_rn(lb[c], __fmul_rn(so[c], block));
                bmin[c] = lb[c];
            }
        } else {  // ADVANCE inside the current block
            moved = false;
            for (int k = 0; k < ADVANCE_SUBSTEPS; ++k) {
                float np[3], st[3];
                dda_step(d, sf, p, tmin, tsize, np, st);
                const int s_ts = step_sectant(tsect, st);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    p[c] = np[c];
                    if (s_ts < OOB) tmin[c] = __fadd_rn(tmin[c], __fmul_rn(st[c], tsize));
                }
                tsect = s_ts;
                if (tsect >= OOB || occ_bit(lo, hi, tsect)) break;
            }
        }

        if (level > top) {  // ascended past the top: restart a little on
            float re[3];
            bool inside = true;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                re[c] = __fadd_rn(p[c], __fmul_rn(d[c], 0.1f));
                inside = inside && re[c] > 0.f && re[c] < S;
                p[c] = re[c];
            }
            const bool can_restart = inside && restarts < MAX_RESTARTS;
            restarts += 1;
            if (!can_restart) break;
            tsect = offset_sectant(p, inv_top_block);
            sectant_offset(clamp63(tsect), tmin);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                tmin[c] = __fmul_rn(tmin[c], top_block);
                bmin[c] = 0.f;
            }
            tsize = top_cell;
            level = top;
        }
        if (moved) fetch(occ, levels, n_blocks, level, bmin, lo, hi);
    }

#pragma unroll
    for (int c = 0; c < 3; ++c) out.point[c] = p[c];
    // the color of the hit voxel
    out.voxel = EMPTY_DESC;
    if (out.hit) {
        int v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
            v[c] = out.hvox[c] < 0 ? 0 : (out.hvox[c] > size - 1 ? size - 1 : out.hvox[c]);
        const int cidx = (int)__ldg(&colors[v[0] + v[1] * size + v[2] * size * size]);
        out.voxel = cidx >= COLOR_NONE ? NO_COLOR_HIT : cidx;
    }
    return out;
}

}  // namespace vhx
