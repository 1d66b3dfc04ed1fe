// BitGrid traversal: one thread marches one ray through the occupancy pyramid.
//
// Replaces the TPU kernel `make_kernel` / `traverse_tiles`
// (voxelhex_tpu/ops/traverse_pallas.py:79, :208), and computes what the
// production tracer computes (`make_bitgrid_tracer.trace`,
// voxelhex_tpu/render/bitgrid.py:482-808): clip to the world box, then the
// PUSH/POP/ADVANCE sectant automaton with restarts, lateral steps, DDA
// substeps inside a block, the impact normal and the color lookup.
//
// What bounds it on the H100: neither bytes nor arithmetic.  A ray reads
// 24 B of ray, one 8 B word pair per level change (the 2.1 MB pyramid of
// the benchmark scene stays in the 50 MB L2) and 2 B of color, and writes
// 41 B; its loop is a chain of dependent integer and f32 steps whose length
// differs from ray to ray, so the time is latency and warp divergence.
// The design keeps the whole automaton in registers, reads the pyramid
// through the read-only cache (__ldg), and lets every ray stop on its own
// (no lock-step rounds, so no compaction pass is needed).
//
// Exactness: the expressions keep the reference's operation order, and the
// file is built with -fmad=false so that only the multiply-adds written
// here as __fmaf_rn are fused: exactly those that XLA:CPU fuses in the
// reference.  The loop stops after `max_iters` iterations whatever the ray
// does, and a ray restarts at most MAX_RESTARTS times.
//
// The tracer settings are those of the reference renderer
// (BitGridRenderer.__init__): lateral steps on, MAX_RESTARTS restarts,
// ADVANCE_SUBSTEPS DDA substeps per ADVANCE.  They are fixed here; only
// `max_iters` is a launch parameter.

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

namespace {

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

// clip(floor(x), 0, 3) as int; NaN -> 0
__device__ __forceinline__ int cell_index(float x) {
    float f = floorf(x);
    if (f != f) return 0;
    return (int)fminf(fmaxf(f, 0.f), 3.f);
}

__device__ __forceinline__ int offset_sectant(const float off[3], float size) {
    int ix = cell_index(__fdiv_rn(__fmul_rn(off[0], 4.f), size));
    int iy = cell_index(__fdiv_rn(__fmul_rn(off[1], 4.f), size));
    int iz = cell_index(__fdiv_rn(__fmul_rn(off[2], 4.f), size));
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
        mid[c] = __fsub_rn(__fadd_rn(tmin[c], __fdiv_rn(tsize, 2.f)), p[c]);
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

__device__ __forceinline__ float floor_mod(float x, float y) {
    float r = fmodf(x, y);
    if (r != 0.f && ((r < 0.f) != (y < 0.f))) r = __fadd_rn(r, y);
    return r;
}

__device__ __forceinline__ float cell_size(int level) { return (float)(1 << (2 * level)); }

__device__ __forceinline__ void fetch(const uint2* __restrict__ occ, const TraceParams& P,
                                      int level, const float bmin[3], uint32_t& lo, uint32_t& hi) {
    float bs = cell_size(level) * 4.f;
    int n = P.dims[level];
    int addr = P.bases[level] + (int)floorf(__fdiv_rn(bmin[0], bs))
             + (int)floorf(__fdiv_rn(bmin[1], bs)) * n
             + (int)floorf(__fdiv_rn(bmin[2], bs)) * n * n;
    addr = addr < 0 ? 0 : (addr > P.n_blocks - 1 ? P.n_blocks - 1 : addr);
    uint2 w = __ldg(&occ[addr]);
    lo = w.x;
    hi = w.y;
}

__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const uint2* __restrict__ occ, const unsigned short* __restrict__ colors,
                const TraceParams P, int R,
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
    const float S = (float)P.size;
    const int top = P.n_levels - 1;
    const float top_cell = cell_size(top);
    const float top_block = top_cell * 4.f;

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

    int level = top;
    float bmin[3] = {0.f, 0.f, 0.f};
    uint32_t lo, hi;
    fetch(occ, P, top, bmin, lo, hi);
    int tsect = active ? offset_sectant(p, top_block) : OOB;
    float tmin[3];
    sectant_offset(clamp63(tsect), tmin);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmin[c] = __fmul_rn(tmin[c], top_block);
    float tsize = top_cell;
    bool hit = false;
    int hvox[3] = {0, 0, 0};
    float hn[3] = {0.f, 0.f, 0.f};
    int restarts = 0;

    // ---- the automaton, at most max_iters steps
    for (int it = 0; active && it < P.max_iters; ++it) {
        const bool inb = tsect < OOB;
        const bool occupied = occ_bit(lo, hi, tsect);
        const bool at_bottom = level <= 0;
        if (occupied && at_bottom && inb) {
            hit = true;
#pragma unroll
            for (int c = 0; c < 3; ++c) hvox[c] = (int)tmin[c];
            impact_normal(tmin, tsize, p, hn);
            active = false;
            break;
        }
        uint32_t m_lo, m_hi;
        reach_mask(clamp63(tsect), octant, m_lo, m_hi);
        const bool no_overlap = ((lo & m_lo) == 0u) && ((hi & m_hi) == 0u);
        const bool descend = occupied && !at_bottom && inb;
        const bool lateral = !inb && !descend;
        const bool ascend = no_overlap && !descend && !lateral;
        const float block = tsize * 4.f;
        bool moved = true;
        if (descend) {
            float off[3], so[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) off[c] = __fsub_rn(p[c], tmin[c]);
            const int d_tsect = offset_sectant(off, tsize);
            sectant_offset(d_tsect, so);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                bmin[c] = tmin[c];
                tmin[c] = __fadd_rn(tmin[c], __fmul_rn(so[c], tsize));
            }
            tsect = d_tsect;
            tsize = tsize / 4.f;
            level -= 1;
        } else if (ascend) {
            const float parent_block = block * 4.f;
            float pmin_[3], off[3], np[3], st[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                pmin_[c] = __fsub_rn(bmin[c], floor_mod(bmin[c], parent_block));
                off[c] = __fsub_rn(__fadd_rn(bmin[c], __fdiv_rn(block, 2.f)), pmin_[c]);
            }
            const int a_ts0 = offset_sectant(off, parent_block);
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
            bool out = false;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                lb[c] = __fadd_rn(bmin[c], __fmul_rn(st[c], block));
                out = out || lb[c] < 0.f || lb[c] >= S;
            }
            if (out) {  // the neighbor block lies outside the world
                active = false;
                break;
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) off[c] = __fsub_rn(np[c], lb[c]);
            tsect = offset_sectant(off, block);
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
            if (!can_restart) {
                active = false;
                break;
            }
            tsect = offset_sectant(p, top_block);
            sectant_offset(clamp63(tsect), tmin);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                tmin[c] = __fmul_rn(tmin[c], top_block);
                bmin[c] = 0.f;
            }
            tsize = top_cell;
            level = top;
        }
        if (moved) fetch(occ, P, level, bmin, lo, hi);
    }

    // ---- outputs, and the color of the hit voxel
    int voxel = EMPTY_DESC;
    if (hit) {
        const int Si = P.size;
        int v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = hvox[c] < 0 ? 0 : (hvox[c] > Si - 1 ? Si - 1 : hvox[c]);
        const int cidx = (int)__ldg(&colors[v[0] + v[1] * Si + v[2] * Si * Si]);
        voxel = cidx >= COLOR_NONE ? NO_COLOR_HIT : cidx;
    }
    hit_out[r] = hit ? 1 : 0;
    voxel_out[r] = voxel;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        hvox_out[3 * r + c] = hvox[c];
        point_out[3 * r + c] = p[c];
        hnormal_out[3 * r + c] = hn[c];
    }
}

}  // namespace

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
