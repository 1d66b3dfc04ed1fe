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
// The row is held in registers, one uint2 a level, and the pyramid's depth
// L is a template parameter: each depth from 1 to VHX_SKIP_MAX_LEVELS is an
// instance of its own (`skip_depth` picks it in the C entries), so the row
// is exactly L pairs and every loop over the levels is unrolled to L with
// no guard and no dynamic index.  A fetch loads the row as 16 B vectors:
// at even L every row starts on 16 B; at odd L the row of block a starts
// on 16 B where a is even and on 8 B where it is odd, so one 8 B load
// takes the unaligned end and 16 B loads the rest (the rows keep the
// reference's [n0^3, 2L] layout, 16 B aligned at their start).  A substep
// finds the lowest valid level with one __clz instead of testing each
// level's validity: level k's pair is valid for v exactly when
// ((v_c >> 2) ^ b0_c) >> 2k == 0 on every axis.
//
// What bounds it on the H100: neither bytes nor operations but each ray's
// chain of body iterations, each up to `substeps` substeps of L bit reads,
// a __clz and a DDA step, then a row fetch that the next body waits on (1
// MiB of rows at the bench, 640 MiB at the 1024 terrain).

#pragma once

#include <type_traits>

#include "traverse.cuh"

// The deepest pyramid with an instance: L = 6 covers worlds up to 4096 a
// side; a deeper world's colors alone (2 B a voxel, 137 GB at 4097^3) do
// not fit the card.  The plain skip tracer takes up to 8 levels.
#define VHX_SKIP_MAX_LEVELS 6

namespace vhx {

// What the skip march reads besides the ray: the rows [n0^3, L] of word
// pairs, the world extent, the blocks a side of level 0 (n0 = ceil(S /
// 4)) and the substeps of a body iteration.
struct SkipGrid {
    const uint2* rows;
    int size;
    int n0;
    int substeps;
};

__device__ __forceinline__ SkipGrid skip_grid(const uint2* rows, int size, int substeps) {
    const int n0 = (size + 3) / 4;
    return SkipGrid{rows, size, n0 < 1 ? 1 : n0, substeps};
}

// Call f(std::integral_constant<int, L>()) for the pyramid's depth L =
// n_levels, each depth its own instance; cudaErrorInvalidValue outside
// 1..VHX_SKIP_MAX_LEVELS
template <class F>
cudaError_t skip_depth(int n_levels, F&& f) {
    switch (n_levels) {
        case 1: return f(std::integral_constant<int, 1>());
        case 2: return f(std::integral_constant<int, 2>());
        case 3: return f(std::integral_constant<int, 3>());
        case 4: return f(std::integral_constant<int, 4>());
        case 5: return f(std::integral_constant<int, 5>());
        case 6: return f(std::integral_constant<int, 6>());
    }
    return cudaErrorInvalidValue;
}

// Whether the skip rows start on 16 B, as the row fetch's vector loads need
inline bool skip_rows_aligned(const void* rows) {
    return (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
}

// x.astype(int32) as XLA converts: toward zero, saturating, NaN to 0
__device__ __forceinline__ int sat_int(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.f) return 0x7fffffff;
    if (x <= -2147483648.f) return (int)0x80000000;
    return (int)x;
}

// One ray's skip march between body iterations, in registers, over a
// pyramid of L levels.
template <int L>
struct Skip {
    float d[3];
    float sg[3];  // sgn(d)
    float sf[3];  // path length per unit step along each axis
    float p[3];   // the current point
    int v[3];     // the current voxel
    int b0[3];    // the level-0 block whose row is held
    uint2 row[L];
    int iters;    // body iterations taken
    bool active;  // still marching
    bool hit;     // stopped on an occupied voxel (v)
};

__device__ __forceinline__ uint2 lo_pair(const uint4& w) { return make_uint2(w.x, w.y); }
__device__ __forceinline__ uint2 hi_pair(const uint4& w) { return make_uint2(w.z, w.w); }

// Fetch the row of the level-0 block of the ray's voxel.
template <int L>
__device__ __forceinline__ void skip_fetch(Skip<L>& m, const SkipGrid& g) {
    long long addr = 0, scale = 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        int b = m.v[c] >> 2;
        b = b < 0 ? 0 : (b > g.n0 - 1 ? g.n0 - 1 : b);
        m.b0[c] = b;
        addr += (long long)b * scale;
        scale *= g.n0;
    }
    const uint2* row = g.rows + addr * L;
    if constexpr (L == 1) {
        m.row[0] = __ldg(row);
    } else if constexpr (L % 2 == 0) {
        const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
        for (int i = 0; i < L / 2; ++i) {
            const uint4 w = __ldg(&q[i]);
            m.row[2 * i] = lo_pair(w);
            m.row[2 * i + 1] = hi_pair(w);
        }
    } else {
        // the 8 B end that is off 16 B: the first pair of an odd block's
        // row, the last of an even one's
        const bool odd = (addr & 1) != 0;
        const uint4* q = reinterpret_cast<const uint4*>(row + (odd ? 1 : 0));
        const uint2 end = __ldg(row + (odd ? 0 : L - 1));
        uint4 w[L / 2];
#pragma unroll
        for (int i = 0; i < L / 2; ++i) w[i] = __ldg(&q[i]);
#pragma unroll
        for (int k = 0; k < L; ++k) {
            const uint2 even_k = k == L - 1 ? end : (k % 2 ? hi_pair(w[k / 2]) : lo_pair(w[k / 2]));
            const uint2 odd_k =
                k == 0 ? end : ((k - 1) % 2 ? hi_pair(w[(k - 1) / 2]) : lo_pair(w[(k - 1) / 2]));
            m.row[k] = odd ? odd_k : even_k;
        }
    }
}

// Clip the ray (o, d) to the world box and fetch the row of its entry
// voxel; with kStart and `use_start`, from `start_t` on (init's start form,
// bitgrid.py:907-913).
template <bool kStart = false, int L>
__device__ __forceinline__ void skip_init(Skip<L>& m, const float o[3], const float d[3],
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

// One substep: true if the ray stepped to the next cell, false if it hit
// (m.hit), left the world (inactive) or waits for the fetch.  The valid
// levels are [kmin, L): kmin is half the bit length of the three axes'
// (v >> 2) ^ b0, rounded up.
template <int L>
__device__ __forceinline__ bool skip_substep(Skip<L>& m, const SkipGrid& g) {
    const int x = ((m.v[0] >> 2) ^ m.b0[0]) | ((m.v[1] >> 2) ^ m.b0[1]) | ((m.v[2] >> 2) ^ m.b0[2]);
    const int kmin = (33 - __clz(x)) >> 1;
    // bit k of `empty`: v's cell of level k is empty in the row
    unsigned empty = 0u;
    bool occupied0 = false;
#pragma unroll
    for (int k = 0; k < L; ++k) {
        const int s = ((m.v[0] >> (2 * k)) & 3) | (((m.v[1] >> (2 * k)) & 3) << 2)
                    | (((m.v[2] >> (2 * k)) & 3) << 4);
        const uint32_t word = s < 32 ? m.row[k].x : m.row[k].y;
        const unsigned bit = (word >> (s & 31)) & 1u;
        if (k == 0) occupied0 = bit != 0u;
        empty |= (bit ^ 1u) << k;
    }
    if (kmin == 0 && occupied0) {
        m.hit = true;
        m.active = false;
        return false;
    }
    empty &= ~0u << kmin;  // kmin <= 16
    if (empty == 0u) return false;
    const int shift = 2 * (31 - __clz((int)empty));  // the largest valid empty level
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
    template <int L>
    __device__ __forceinline__ bool on_hit(Skip<L>&) const { return true; }
};

// Clear the bit of the ray's voxel in the level-0 pair of its row, so that
// the march steps on past it (soft.py `_hit_step`'s skip branch).  Only the
// register row changes; the next fetch reads the bit again.
template <int L>
__device__ __forceinline__ void skip_clear_hit_voxel(Skip<L>& m) {
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
template <int L, class Policy>
__device__ __forceinline__ void skip_run(Skip<L>& m, const SkipGrid& g, int max_iters,
                                         Policy& pol) {
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

// What the single-hit skip march `m` ends with: on a hit, the hit voxel,
// its impact normal (the unit cell at v) and color (traverse.cuh hit_color,
// from a u16 or u8 grid).
template <int L, class TColor>
__device__ __forceinline__ Hit skip_hit_of(const Skip<L>& m, const TColor* __restrict__ colors,
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
        out.voxel = hit_color(out.hvox, colors, size);
    }
    return out;
}

// March the ray (o, d) over the skip rows of a pyramid of L levels: the
// reference skip tracer's `trace` of one ray; with kStart, from `start_t`
// where `use_start`.
template <bool kStart, int L, class TColor>
__device__ __forceinline__ Hit skip_march(const float o[3], const float d[3], const SkipGrid& g,
                                          const TColor* __restrict__ colors,
                                          int max_iters, float start_t = 0.f,
                                          bool use_start = true) {
    Skip<L> m;
    skip_init<kStart>(m, o, d, g, start_t, use_start);
    SkipStopAtHit stop;
    skip_run(m, g, max_iters, stop);
    return skip_hit_of(m, colors, g.size);
}

}  // namespace vhx
