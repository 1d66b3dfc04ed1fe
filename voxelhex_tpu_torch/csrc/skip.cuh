// The skip tracer of one ray: the fused-hierarchy march, beside the stack
// automaton of traverse.cuh, for the kernels that take the tracer as a
// template parameter (traverse.cu, frame.cu, frames.cu, prepass.cu,
// multihit.cu).
//
// It computes what the reference's skip tracer computes (`make_skip_tracer`,
// voxelhex_tpu/render/bitgrid.py:859-1017): the first occupied voxel along
// the ray, with no stack and no restart.  The pyramid is read as skip rows
// (`build_skip_rows`, bitgrid.py:811): for every level-0 block, one row of
// L word pairs, level k's the pair of the block's level-k ancestor, so one
// row fetch holds the occupancy of every level over a position.  The ray
// carries its point p (f32) and its voxel v (int32, kept in [0, S)), and
// the row of the level-0 block b0 it last fetched.  A body iteration takes
// up to `substeps` substeps, then fetches the row of the voxel reached.  A
// substep
//   (a) hits where the level-0 pair is valid for v (v's level-0 block is
//       b0) and v's bit is set;
//   (b) else takes the largest level k whose pair is valid for v (v >>
//       2k+2 == b0 >> 2k on each axis) and whose cell is empty; with none,
//       the row is stale and the ray waits for the fetch;
//   (c) makes one DDA step across that cell (edge 4^k, integer min corner
//       (v >> 2k) << 2k): on a crossed axis the new voxel is the first one
//       of the next cell, on the others floor(p) clipped into the cell; a
//       voxel outside [0, S) ends the march.
// A substep that does not step ends the body's substeps, as in the
// reference, where every later substep of that body repeats its outcome.
// At most `max_iters` body iterations a ray.
//
// Exactness: the entry point and the DDA's new point fuse their
// multiply-adds on x and y, not on z, as XLA:CPU compiles the reference's
// skip program (`enter_box<..., 3>`, `dda_step<3>`); the path lengths and
// the impact normal are the stack tracer's.  Voxel coordinates are integers,
// so the cell arithmetic is exact.
//
// The row is held in registers, one uint2 a level, for up to
// VHX_SKIP_MAX_LEVELS levels (a world of up to 4^VHX_SKIP_MAX_LEVELS voxels
// a side): every loop over the levels is unrolled to that bound and guarded
// by the grid's depth, so no index into the row is dynamic.  At L = 5 a row
// is 40 B and spans two 32 B sectors.

#pragma once

#include "traverse.cuh"

#define VHX_SKIP_MAX_LEVELS 8

namespace vhx {

// What the skip march reads besides the ray: the rows [n0^3, L] of word
// pairs, the pyramid's depth L, the world extent, the blocks a side of
// level 0 (n0 = ceil(S / 4)) and the substeps of a body iteration.
struct SkipGrid {
    const uint2* rows;
    int n_levels;
    int size;
    int n0;
    int substeps;
};

__device__ __forceinline__ SkipGrid skip_grid(const uint2* rows, int n_levels, int size,
                                              int substeps) {
    const int n0 = (size + 3) / 4;
    return SkipGrid{rows, n_levels, size, n0 < 1 ? 1 : n0, substeps};
}

// x.astype(int32) as XLA converts: toward zero, saturating, NaN to 0
__device__ __forceinline__ int sat_int(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.f) return 0x7fffffff;
    if (x <= -2147483648.f) return (int)0x80000000;
    return (int)x;
}

// One ray's skip march between body iterations, in registers.
struct Skip {
    float d[3];
    float sg[3];  // sgn(d)
    float sf[3];  // path length per unit step along each axis
    float p[3];   // the current point
    int v[3];     // the current voxel
    int b0[3];    // the level-0 block whose row is held
    uint2 row[VHX_SKIP_MAX_LEVELS];
    int iters;    // body iterations taken
    bool active;  // still marching
    bool hit;     // stopped on an occupied voxel (v)
};

// Fetch the row of the level-0 block of the ray's voxel.
__device__ __forceinline__ void skip_fetch(Skip& m, const SkipGrid& g) {
    long long addr = 0, scale = 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        int b = m.v[c] >> 2;
        b = b < 0 ? 0 : (b > g.n0 - 1 ? g.n0 - 1 : b);
        m.b0[c] = b;
        addr += (long long)b * scale;
        scale *= g.n0;
    }
    const uint2* row = g.rows + addr * g.n_levels;
#pragma unroll
    for (int k = 0; k < VHX_SKIP_MAX_LEVELS; ++k)
        if (k < g.n_levels) m.row[k] = __ldg(&row[k]);
}

// Clip the ray (o, d) to the world box and fetch the row of its entry
// voxel; with kStart and `use_start`, from `start_t` on (init's start form,
// bitgrid.py:907-913).
template <bool kStart = false>
__device__ __forceinline__ void skip_init(Skip& m, const float o[3], const float d[3],
                                          const SkipGrid& g, float start_t = 0.f,
                                          bool use_start = true) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.d[c] = d[c];
        m.sg[c] = sgn(d[c]);
    }
    path_lengths(d, m.sf);
    m.active = enter_box<kStart, 3>(o, d, (float)g.size, m.p, start_t, use_start);
    m.hit = false;
    m.iters = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const int v = sat_int(floorf(m.p[c]));
        m.v[c] = v < 0 ? 0 : (v > g.size - 1 ? g.size - 1 : v);
    }
    skip_fetch(m, g);
}

// The bit of voxel v in the row's level-k pair, and whether that pair is
// valid for v
__device__ __forceinline__ void skip_level(const Skip& m, int k, bool& valid, bool& occupied) {
    valid = true;
    int s = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        valid = valid && (m.v[c] >> (2 * k + 2)) == (m.b0[c] >> (2 * k));
        s += ((m.v[c] >> (2 * k)) & 3) << (2 * c);
    }
    const uint32_t word = s < 32 ? m.row[k].x : m.row[k].y;
    occupied = ((word >> (s & 31)) & 1u) != 0u;
}

// One substep: true if the ray stepped to the next cell, false if it hit
// (m.hit), left the world (inactive) or waits for the fetch.
__device__ __forceinline__ bool skip_substep(Skip& m, const SkipGrid& g) {
    int ksel = -1;
#pragma unroll
    for (int k = 0; k < VHX_SKIP_MAX_LEVELS; ++k) {
        if (k < g.n_levels) {
            bool valid, occupied;
            skip_level(m, k, valid, occupied);
            if (k == 0 && valid && occupied) {
                m.hit = true;
                m.active = false;
                return false;
            }
            if (valid && !occupied) ksel = k;
        }
    }
    if (ksel < 0) return false;
    const int shift = 2 * ksel;
    const int csz = 1 << shift;
    int cmin[3];
    float cminf[3], np[3], st[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        cmin[c] = (m.v[c] >> shift) << shift;
        cminf[c] = (float)cmin[c];
    }
    dda_step<3>(m.d, m.sg, m.sf, m.p, cminf, (float)csz, np, st);
    int nv[3];
    bool out = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const int sti = st[c] > 0.f ? 1 : (st[c] < 0.f ? -1 : 0);
        if (sti != 0) {
            nv[c] = ((m.v[c] >> shift) + sti) * csz + (sti > 0 ? 0 : csz - 1);
        } else {
            const int f = sat_int(floorf(np[c]));
            nv[c] = f < cmin[c] ? cmin[c] : (f > cmin[c] + csz - 1 ? cmin[c] + csz - 1 : f);
        }
        out = out || nv[c] < 0 || nv[c] >= g.size;
    }
    if (out) {
        m.active = false;
        return false;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.p[c] = np[c];
        m.v[c] = nv[c];
    }
    return true;
}

// The policy of the single-hit skip march: stop on the first hit.
struct SkipStopAtHit {
    __device__ __forceinline__ bool on_hit(Skip&) const { return true; }
};

// Clear the bit of the ray's voxel in the level-0 pair of its row, so that
// the march steps on past it (soft.py `_hit_step`'s skip branch).  Only the
// register row changes; the next fetch reads the bit again.
__device__ __forceinline__ void skip_clear_hit_voxel(Skip& m) {
    const int s = (m.v[0] & 3) + (m.v[1] & 3) * 4 + (m.v[2] & 3) * 16;
    if (s < 32) m.row[0].x &= ~(1u << s);
    else m.row[0].y &= ~(1u << (s - 32));
}

// Body iterations until the ray leaves the world (inactive), has taken
// `max_iters` of them, or the policy ends the march.  On a hit,
// `pol.on_hit(m)` either returns true, and the march stops there (hit,
// inactive), or returns false: then, as the reference's rounds do, the row
// of the hit voxel is fetched at the end of the body, the voxel's bit is
// cleared in it, and the march goes on from that voxel.
template <class Policy>
__device__ __forceinline__ void skip_run(Skip& m, const SkipGrid& g, int max_iters, Policy& pol) {
    while (m.active && m.iters < max_iters) {
        m.iters += 1;
#pragma unroll 1
        for (int j = 0; j < g.substeps; ++j)
            if (!skip_substep(m, g)) break;
        if (m.hit) {
            if (pol.on_hit(m)) return;
            skip_fetch(m, g);
            skip_clear_hit_voxel(m);
            m.hit = false;
            m.active = true;
            continue;
        }
        if (m.active) skip_fetch(m, g);
    }
}

// The color index of the hit voxel `hvox` (clipped to the world), or
// NO_COLOR_HIT for a voxel with no color
__device__ __forceinline__ int voxel_color(const int hvox[3],
                                           const unsigned short* __restrict__ colors, int size) {
    int v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = hvox[c] < 0 ? 0 : (hvox[c] > size - 1 ? size - 1 : hvox[c]);
    const int cidx = (int)__ldg(&colors[voxel_addr(v[0], v[1], v[2], size)]);
    return cidx >= COLOR_NONE ? NO_COLOR_HIT : cidx;
}

// What the single-hit skip march `m` ends with: on a hit, the hit voxel,
// its impact normal (the unit cell at v) and color.
__device__ __forceinline__ Hit skip_hit_of(const Skip& m, const unsigned short* __restrict__ colors,
                                           int size) {
    Hit out;
    out.hit = m.hit;
    out.hvox[0] = out.hvox[1] = out.hvox[2] = 0;
    out.normal[0] = out.normal[1] = out.normal[2] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) out.point[c] = m.p[c];
    out.voxel = EMPTY_DESC;
    if (m.hit) {
        float vmin[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            out.hvox[c] = m.v[c];
            vmin[c] = (float)m.v[c];
        }
        impact_normal(vmin, 1.f, m.p, out.normal);
        out.voxel = voxel_color(out.hvox, colors, size);
    }
    return out;
}

// March the ray (o, d) over the skip rows: the reference skip tracer's
// `trace` of one ray; with kStart, from `start_t` where `use_start`.
template <bool kStart = false>
__device__ __forceinline__ Hit skip_march(const float o[3], const float d[3], const SkipGrid& g,
                                          const unsigned short* __restrict__ colors,
                                          int max_iters, float start_t = 0.f,
                                          bool use_start = true) {
    Skip m;
    skip_init<kStart>(m, o, d, g, start_t, use_start);
    SkipStopAtHit stop;
    skip_run(m, g, max_iters, stop);
    return skip_hit_of(m, colors, g.size);
}

}  // namespace vhx
