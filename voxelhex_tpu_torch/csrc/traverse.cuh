// The BitGrid automaton of one ray, shared by the traversal kernel
// (traverse.cu), the frame kernels (frame.cu, frames.cu) and the multi-hit
// march (multihit.cu).
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
// loop stops after `max_iters` steps whatever the ray does, and a ray
// restarts at most MAX_RESTARTS times.
//
// One loop marches a ray: `init` puts the automaton's state in a `March`,
// and `run` steps it, asking a policy what to do on a hit.  The single-hit
// march (`march`, for traverse.cu, frame.cu and frames.cu) stops on the
// first hit; the multi-hit march (multihit.cu) records each hit, clears its
// bit and steps on in the same loop.
//
// What bounds the loop on the H100: the instructions a warp executes, not
// bytes (a frame reads the L2-resident 2.1 MB pyramid) and not idle lanes
// (8.8% of lane-steps under the 4 x 8 pixel tile).  A warp executes every
// branch that one of its lanes takes in a step, and most of a move's
// instructions are its DDA step: ascend and lateral steps take one through
// the block, an ADVANCE up to ADVANCE_SUBSTEPS through the cell.  Written as
// one branch a move, a warp whose lanes ascend, step sideways and advance
// in one step ran a DDA for each of them (six DDA steps inlined).  So the
// warp's lanes still take a step together, and each turn of the step's DDA
// loop runs one `dda_step` that all of them share: in the first, every
// lane that ascends, steps sideways or advances picks its box (the block or
// the cell) and takes its DDA step; in the others, the lanes whose ADVANCE
// goes on take their next substep (`March::sub`).  Then each move's short
// tail runs.  Each lane computes the same f32 operations in the same order
// on the same values as one branch a move would: only the loop's shape is
// the GPU's.  Letting each lane's turns run free of its warp's steps (a
// lane in an ADVANCE takes its next substep while others start a step) ran
// fewer DDA steps still, but in 69% more turns a warp, and was slower on
// the card (PERF.md).
//
// The tracer settings are those of the reference renderer
// (BitGridRenderer.__init__): lateral steps on, MAX_RESTARTS restarts,
// ADVANCE_SUBSTEPS DDA substeps per ADVANCE.  `max_iters` is a launch
// parameter; the substeps are a template parameter of `run`, ADVANCE_SUBSTEPS
// unless a kernel asks for another count (beam.cu marches the reference's
// `make_bitgrid_tracer` default of 2).
//
// The renderer's other automaton options (bitgrid.py make_bitgrid_tracer:
// `lateral_step`, `parent_skip`, `advance_substeps`) are read at run time
// from a TraceOptions by the optioned instances, `run<..., kOpt = true>`;
// the instances of the default options compile as they did without them.
// Without lateral steps an empty block exit ascends (and re-descends).
// With `parent_skip` a lateral step first looks up the target block's bit
// in its parent block's words, read from the pyramid at the parent's
// address on that step alone (no [B, 4] quad rows to store or refresh), and
// ascends where the target is empty.  An ADVANCE of `advance_substeps` <= 0
// moves nothing, as the reference's empty range: the ray spins to
// `max_iters`.
//
// The color grid is u16, or u8 where the reference's `color_u8` stored it
// so (254 and 255 the sentinels): the color reads take its type as a
// template parameter.
//
// The per-level table (word-pair base, blocks per axis) is read with a
// per-thread level.  Indexed that way inside the launch parameters it would
// be copied to each thread's local memory (a 112 B stack frame), so every
// kernel copies it to shared memory first (load_levels), with constant
// indices only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define VHX_MAX_LEVELS 12

struct TraceParams {
    int n_levels;
    int bases[VHX_MAX_LEVELS];  // word-pair offset of each level
    int dims[VHX_MAX_LEVELS];   // blocks per axis of each level
    int size;                   // world extent in voxels
    int n_blocks;               // rows of occ_pairs
    int max_iters;
};

// The automaton options of the optioned instances (see above); the default
// options are {1, 0, ADVANCE_SUBSTEPS}
struct TraceOptions {
    int lateral_step;      // 1: lateral steps; 0: an empty block exit ascends
    int parent_skip;       // 1: a lateral step into a block empty by its parent's words ascends
    int advance_substeps;  // DDA substeps an ADVANCE; <= 0 moves nothing
};

namespace vhx {

constexpr int MAX_RESTARTS = 4;
constexpr int ADVANCE_SUBSTEPS = 4;
constexpr int OOB = 64;
constexpr float BIG = 1e30f;
constexpr int NO_COLOR_HIT = 0x3FFFFFFE;
constexpr int EMPTY_DESC = -1;
constexpr int COLOR_NONE = 0xFFFE;

// The element of a color grid: u8 with kU8, else u16
template <bool kU8>
using color_t = std::conditional_t<kU8, unsigned char, unsigned short>;

// The least stored color index that means "no color" in a grid of TColor:
// COLOR_NONE in u16, 254 in u8 (the reference's resolve_color)
template <class TColor>
__device__ __forceinline__ constexpr int colorless() {
    return sizeof(TColor) == 1 ? 254 : COLOR_NONE;
}

// jnp.sign: +-1, and zero (with its sign) or NaN as given
__device__ __forceinline__ float sgn(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// XLA max: NaN propagates, +0 > -0
__device__ __forceinline__ float xla_max(float a, float b) {
    if (a != a || a > b || (a == b && !signbit(a))) return a;
    return b;
}

// XLA min: NaN propagates, -0 < +0
__device__ __forceinline__ float xla_min(float a, float b) {
    if (a != a || a < b || (a == b && signbit(a))) return a;
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

// one DDA step to the nearest face of the cell [cmin, cmin + csize), for
// the direction d whose signs are sg = sgn(d).  The reference's need,
// csize * max(sg, 0) - sg * (p - cmin), takes csize * 1 = csize where
// sg = 1 and csize * +0 = +0 where sg is -1 or +-0; where sg is NaN (so is
// d) the distance is BIG either way, as it is where d = +-0 (sg = +-0).
// Bit c of kFma fuses the new point's multiply-add on axis c, as XLA:CPU
// compiles the reference program being matched: all three in the stack
// tracer, x and y in the skip tracer (skip.cuh).
template <int kFma = 7>
__device__ __forceinline__ void dda_step(const float d[3], const float sg[3], const float sf[3],
                                         const float p[3], const float cmin[3], float csize,
                                         float new_p[3], float step[3]) {
    float dist[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float need = __fsub_rn(sg[c] > 0.f ? csize : 0.f,
                               __fmul_rn(sg[c], __fsub_rn(p[c], cmin[c])));
        float dd = fabsf(__fmul_rn(need, sf[c]));
        if (sg[c] == 0.f || dd != dd) dd = BIG;
        dist[c] = dd;
    }
    float m = fminf(fminf(dist[0], dist[1]), dist[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        new_p[c] = ((kFma >> c) & 1) ? __fmaf_rn(d[c], m, p[c])
                                     : __fadd_rn(p[c], __fmul_rn(d[c], m));
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

// The flat index x + y * size + z * size^2 of a voxel, in 64 bits: in
// 32 bits it wraps from size 1291 on.  Colors ([S^3]) and the soft params
// ([S^3] logits, [S^3 * 3] albedo) are addressed through it.
__device__ __forceinline__ long long voxel_addr(int x, int y, int z, int size) {
    return (long long)x + (long long)y * size + (long long)z * size * size;
}

// What the march reads besides the ray: the pyramid, its level table (in
// shared memory, load_levels), its depth, the world extent, its rows.
struct Grid {
    const uint2* occ;
    const int2* levels;
    int n_levels;
    int size;
    int n_blocks;
};

// One ray's automaton between steps, the loop state of the reference's
// trace.init / trace.run, held in registers.  On a hit the state is as the
// hit left it: the cell is the hit voxel's, the point the hit point.
struct March {
    float d[3];
    float sg[3];      // sgn(d), what the DDA reads of the direction besides d
    float sf[3];      // path length per unit step along each axis
    int octant;
    float p[3];       // the current point
    float tmin[3];    // min corner of the current cell
    float bmin[3];    // min corner of the current block
    float tsize;      // the cell edge, 4^level
    int level;
    int tsect;        // the cell's sectant in its block; OOB outside it
    uint32_t lo, hi;  // the block's occupancy words
    int restarts;
    int steps;        // automaton steps taken, each hit's step included
    int sub;          // DDA substeps the current ADVANCE step has taken; 0 between steps
    bool active;      // still marching
    bool hit;         // stopped on an occupied voxel
};

// The moves of one automaton step.  A step ascends or steps sideways with
// one DDA step and advances with one a substep; it hits or descends with
// none.
constexpr int MOVE_HIT = 1;
constexpr int MOVE_DESCEND = 2;
constexpr int MOVE_ASCEND = 3;
constexpr int MOVE_LATERAL = 4;
constexpr int MOVE_ADVANCE = 5;

// The path lengths `sf` of the direction d across a unit of each axis, as
// the reference computes them; shared with the skip tracer (skip.cuh).
__device__ __forceinline__ void path_lengths(const float d[3], float sf[3]) {
    float a = __fdiv_rn(d[2], d[0]), b = __fdiv_rn(d[1], d[0]);
    sf[0] = __fsqrt_rn(__fmaf_rn(b, b, __fmaf_rn(a, a, 1.f)));
    a = __fdiv_rn(d[0], d[1]);
    b = __fdiv_rn(d[2], d[1]);
    sf[1] = __fsqrt_rn(__fmaf_rn(b, b, __fmaf_rn(a, a, 1.f)));
    a = __fdiv_rn(d[0], d[2]);
    b = __fdiv_rn(d[1], d[2]);
    sf[2] = __fsqrt_rn(__fadd_rn(__fmaf_rn(a, a, __fmul_rn(b, b)), 1.f));
}

// The clip of init, shared with the skip tracer's (skip.cuh): the entry
// point `p` of the ray (o, d) into the world box [0, S)^3, and whether the
// ray meets the box (from `start_t` on, with kStart and `use_start`).
template <bool kStart, int kEntryFma>
__device__ __forceinline__ bool enter_box(const float o[3], const float d[3], float S, float p[3],
                                          float start_t, bool use_start) {
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
    float enter = xla_max(tmin_r, 0.f);
    if constexpr (kStart) {
        if (use_start) {
            // clip(max(enter, start_t), 0, max(tmax_r - 1e-3, 0))
            active = active && start_t < tmax_r;
            enter = xla_min(xla_max(0.f, xla_max(enter, start_t)),
                            xla_max(__fsub_rn(tmax_r, 1e-3f), 0.f));
        }
    }
    // the reference's frame fuses this multiply-add on x and y, not on z
    // (with start_t too)
#pragma unroll
    for (int c = 0; c < 3; ++c)
        p[c] = ((kEntryFma >> c) & 1) ? __fmaf_rn(d[c], enter, o[c])
                                      : __fadd_rn(o[c], __fmul_rn(d[c], enter));
    return active;
}

// Clip the ray (o, d) to the world box and enter it at the top level.
// With kStart and `use_start`, the ray starts at least `start_t` along,
// clipped to just inside its exit, and a ray that starts at or beyond its
// exit is inactive from the start: the reference's `start_t` (bitgrid.py
// init), in its order.  Without kStart the code is the form that every
// kernel but far.cu runs; far.cu picks the form of each layer at run time
// (`use_start`), so that one copy of the automaton serves both.  Bit c of
// kEntryFma fuses the entry point's multiply-add on axis c, as XLA:CPU
// compiles the reference program being matched: x and y in the renderer's
// frame, z alone in the beam prepass (beam.cu).
template <bool kStart = false, int kEntryFma = 3>
__device__ __forceinline__ void init(March& m, const float o[3], const float d[3], const Grid& g,
                                     float start_t = 0.f, bool use_start = true) {
    const float S = (float)g.size;
    const int top = g.n_levels - 1;
    const float top_block = pow4(top) * 4.f;
    const float inv_top_block = inv_pow4(top + 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.d[c] = d[c];
        m.sg[c] = sgn(d[c]);
    }
    path_lengths(d, m.sf);
    m.octant = (d[0] >= 0.f ? 1 : 0) + (d[2] >= 0.f ? 2 : 0) + (d[1] >= 0.f ? 4 : 0);
    m.active = enter_box<kStart, kEntryFma>(o, d, S, m.p, start_t, use_start);
    m.hit = false;

    m.level = top;  // the cell edge tsize is 4^level throughout
#pragma unroll
    for (int c = 0; c < 3; ++c) m.bmin[c] = 0.f;
    fetch(g.occ, g.levels, g.n_blocks, top, m.bmin, m.lo, m.hi);
    m.tsect = m.active ? offset_sectant(m.p, inv_top_block) : OOB;
    sectant_offset(clamp63(m.tsect), m.tmin);
#pragma unroll
    for (int c = 0; c < 3; ++c) m.tmin[c] = __fmul_rn(m.tmin[c], top_block);
    m.tsize = pow4(top);
    m.restarts = 0;
    m.steps = 0;
    m.sub = 0;
}

// The policy of the single-hit march: stop on the first hit.
struct StopAtHit {
    __device__ __forceinline__ bool on_hit(March&) const { return true; }
};


// The pieces of one step, each a function that `run` calls (and
// tools/automaton_probes.cu alone, to count its instructions).

// The move of a step that starts in the current cell.
__device__ __forceinline__ int choose_move(const March& m) {
    if (m.tsect >= OOB) return MOVE_LATERAL;
    if (occ_bit(m.lo, m.hi, m.tsect)) return m.level <= 0 ? MOVE_HIT : MOVE_DESCEND;
    // an empty cell: ascend if the ray can reach no occupied cell of the block
    uint32_t m_lo, m_hi;
    reach_mask(m.tsect, m.octant, m_lo, m_hi);
    return ((m.lo & m_lo) | (m.hi & m_hi)) == 0u ? MOVE_ASCEND : MOVE_ADVANCE;
}

// The move `run` takes under its policy: `choose_move`'s, but for the LOD
// frame's policy, whose overload (frame.cu) also stops above level 0 at a
// squared distance from the ray's origin
template <class Policy>
__device__ __forceinline__ int policy_move(const Policy&, const March& m) {
    return choose_move(m);
}

// DESCEND into the occupied cell
__device__ __forceinline__ void descend(March& m) {
    float off[3], so[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) off[c] = __fsub_rn(m.p[c], m.tmin[c]);
    const int d_tsect = offset_sectant(off, inv_pow4(m.level));
    sectant_offset(d_tsect, so);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.bmin[c] = m.tmin[c];
        m.tmin[c] = __fadd_rn(m.tmin[c], __fmul_rn(so[c], m.tsize));
    }
    m.tsect = d_tsect;
    m.tsize = __fmul_rn(m.tsize, 0.25f);  // tsize / 4
    m.level -= 1;
}

// The DDA step of every other move: through the cell for an ADVANCE
// substep, through the block for an ascend or a lateral step.  kFma: the
// axes whose multiply-add is fused (dda_step).
template <int kFma = 7>
__device__ __forceinline__ void move_dda(const March& m, int move, float np[3], float st[3]) {
    const bool advance = move == MOVE_ADVANCE;
    float cmin[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cmin[c] = advance ? m.tmin[c] : m.bmin[c];
    dda_step<kFma>(m.d, m.sg, m.sf, m.p, cmin, advance ? m.tsize : m.tsize * 4.f, np, st);
}

// An ADVANCE substep to the DDA's point; `m.sub` is 0 again when the step
// ends: the cell left the block or is occupied, or the `n_sub` substeps
// (kSubsteps, or the optioned instances' run-time count) are spent.
template <int kSubsteps = ADVANCE_SUBSTEPS>
__device__ __forceinline__ void advance_tail(March& m, const float np[3], const float st[3],
                                             int n_sub = kSubsteps) {
    const int s_ts = step_sectant(m.tsect, st);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.p[c] = np[c];
        if (s_ts < OOB) m.tmin[c] = __fadd_rn(m.tmin[c], __fmul_rn(st[c], m.tsize));
    }
    m.tsect = s_ts;
    m.sub += 1;
    if (m.sub == n_sub || s_ts >= OOB || occ_bit(m.lo, m.hi, s_ts)) m.sub = 0;
}

// ASCEND to the parent block, derived arithmetically
__device__ __forceinline__ void ascend_tail(March& m, const float np[3], const float st[3]) {
    const float block = m.tsize * 4.f;
    const float parent_block = block * 4.f;
    const float inv_parent = inv_pow4(m.level + 2);
    float pmin_[3], off[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        pmin_[c] = block_floor(m.bmin[c], parent_block, inv_parent);
        off[c] = __fsub_rn(__fadd_rn(m.bmin[c], __fmul_rn(block, 0.5f)), pmin_[c]);
    }
    m.tsect = step_sectant(offset_sectant(off, inv_parent), st);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.p[c] = np[c];
        m.tmin[c] = __fadd_rn(m.bmin[c], __fmul_rn(st[c], block));
        m.bmin[c] = pmin_[c];
    }
    m.tsize = block;
    m.level += 1;
}

// Whether the block that a lateral step of DDA step `st` enters is empty by
// its parent block's words (`parent_skip`): its sectant in the parent, as
// ascend_tail computes it, lies inside the parent and its bit is clear.  A
// top-level block has no parent (the reference's all-ones words).
__device__ __forceinline__ bool lateral_target_empty(const March& m, const Grid& g,
                                                     const float st[3]) {
    if (m.level >= g.n_levels - 1) return false;
    const float block = m.tsize * 4.f;
    const float parent_block = block * 4.f;
    const float inv_parent = inv_pow4(m.level + 2);
    float off[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        off[c] = __fsub_rn(__fadd_rn(m.bmin[c], __fmul_rn(block, 0.5f)),
                           block_floor(m.bmin[c], parent_block, inv_parent));
    const int a_ts = step_sectant(offset_sectant(off, inv_parent), st);
    if (a_ts >= OOB) return false;
    uint32_t lo, hi;
    fetch(g.occ, g.levels, g.n_blocks, m.level + 1, m.bmin, lo, hi);
    return !occ_bit(lo, hi, a_ts);
}

// After an ascend past the top level: restart a little on, at the top
// level, or leave the world (false).
__device__ __forceinline__ bool restart(March& m, const Grid& g) {
    const float S = (float)g.size;
    const int top = g.n_levels - 1;
    float re[3];
    bool inside = true;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        re[c] = __fadd_rn(m.p[c], __fmul_rn(m.d[c], 0.1f));
        inside = inside && re[c] > 0.f && re[c] < S;
        m.p[c] = re[c];
    }
    const bool can_restart = inside && m.restarts < MAX_RESTARTS;
    m.restarts += 1;
    if (!can_restart) return false;
    m.tsect = offset_sectant(m.p, inv_pow4(top + 1));
    sectant_offset(clamp63(m.tsect), m.tmin);
    const float top_block = pow4(top + 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.tmin[c] = __fmul_rn(m.tmin[c], top_block);
        m.bmin[c] = 0.f;
    }
    m.tsize = pow4(top);
    m.level = top;
    return true;
}

// A LATERAL step to the same-level neighbor block, or out of the world
// (false) when that block lies outside it.
__device__ __forceinline__ bool lateral_tail(March& m, const float np[3], const float st[3],
                                             float S) {
    const float block = m.tsize * 4.f;
    float lb[3], off[3], so[3];
    bool outside = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        lb[c] = __fadd_rn(m.bmin[c], __fmul_rn(st[c], block));
        outside = outside || lb[c] < 0.f || lb[c] >= S;
    }
    if (outside) return false;
#pragma unroll
    for (int c = 0; c < 3; ++c) off[c] = __fsub_rn(np[c], lb[c]);
    m.tsect = offset_sectant(off, inv_pow4(m.level + 1));
    sectant_offset(clamp63(m.tsect), so);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        m.p[c] = np[c];
        m.tmin[c] = __fadd_rn(lb[c], __fmul_rn(so[c], block));
        m.bmin[c] = lb[c];
    }
    return true;
}

// Step the automaton until the ray leaves the world (inactive), has taken
// `max_steps` steps in all, or the policy `pol` ends the march.  On a hit,
// `pol.on_hit(m)` either returns true, and the march stops there (hit,
// inactive), or changes the state (multihit.cu clears the voxel's bit) and
// returns false, and the march steps on from the same cell.
//
// Each turn of a step's DDA loop moves the ray by one DDA step, shared by
// the warp's lanes (the header's note).  A step is counted when it starts,
// and `max_steps` is tested only there: an ADVANCE's substeps belong to the
// step that began them, as in the reference, whose step runs all of them
// (`kSubsteps` of them at most).  With kOpt the step follows `opt` (the
// header's note), `opt.advance_substeps` in place of kSubsteps.
template <class Policy, int kSubsteps = ADVANCE_SUBSTEPS, bool kOpt = false>
__device__ __forceinline__ void run(March& m, const Grid& g, int max_steps, Policy& pol,
                                    const TraceOptions opt = TraceOptions{1, 0, kSubsteps}) {
    const int top = g.n_levels - 1;
    while (m.active && m.steps < max_steps) {
        m.steps += 1;
        int move = policy_move(pol, m);
        if constexpr (kOpt) {
            // the reference's ascend of tsect >= OOB without lateral steps,
            // and its ADVANCE of no substeps, which leaves the state as it is
            if (move == MOVE_LATERAL && !opt.lateral_step) move = MOVE_ASCEND;
            if (move == MOVE_ADVANCE && opt.advance_substeps <= 0) continue;
        }
        if (move == MOVE_HIT) {
            if (pol.on_hit(m)) {
                m.hit = true;
                m.active = false;
                return;
            }
            continue;
        }
        if (move == MOVE_DESCEND) {
            descend(m);
        } else {
            // the step's DDA steps, one a turn, each shared by the lanes that
            // need it: every moving lane's first, then an ADVANCE's others
            float np[3], st[3];
#pragma unroll 1
            do {
                // XLA:CPU fuses the block DDA's multiply-add on x only where
                // the reference's ADVANCE has substeps: with none, on y and z
                if constexpr (kOpt) {
                    if (opt.advance_substeps <= 0)
                        move_dda<6>(m, move, np, st);
                    else
                        move_dda(m, move, np, st);
                } else {
                    move_dda(m, move, np, st);
                }
                if (move != MOVE_ADVANCE) break;
                advance_tail<kSubsteps>(m, np, st, kOpt ? opt.advance_substeps : kSubsteps);
            } while (m.sub != 0);
            if (move != MOVE_ADVANCE) {
                bool on;
                bool skip = false;
                if constexpr (kOpt)
                    skip = move == MOVE_LATERAL && opt.parent_skip &&
                           lateral_target_empty(m, g, st);
                if (move == MOVE_ASCEND || skip) {
                    ascend_tail(m, np, st);
                    on = m.level <= top || restart(m, g);
                } else {
                    on = lateral_tail(m, np, st, (float)g.size);
                }
                if (!on) {
                    m.active = false;
                    return;
                }
            }
        }
        if (move != MOVE_ADVANCE) fetch(g.occ, g.levels, g.n_blocks, m.level, m.bmin, m.lo, m.hi);
    }
}

// Clear the bit of the voxel the ray stands on in its register words, so
// that the march steps on past it: the next hit it records is another
// voxel (soft.py `_hit_step`).  Only the register copy changes; a later
// fetch of the same block reads the bit again.
__device__ __forceinline__ void clear_hit_voxel(March& m) {
    const int s = clamp63(m.tsect);
    if (s < 32) m.lo &= ~(1u << s);
    else m.hi &= ~(1u << (s - 32));
}

// What one ray ends with
struct Hit {
    bool hit;
    int voxel;     // color index of the hit voxel, NO_COLOR_HIT, or EMPTY_DESC on a miss
    int hvox[3];   // the hit voxel
    float point[3];
    float normal[3];
};

// The hit cell of the single-hit march `m` that ended on a hit: the hit
// voxel and its impact normal (the hit step moved nothing: the cell and
// point are the hit's)
__device__ __forceinline__ void hit_cell(const March& m, int hvox[3], float normal[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hvox[c] = (int)m.tmin[c];
    impact_normal(m.tmin, m.tsize, m.p, normal);
}

// The color index of the hit voxel `hvox` (clipped to the world of edge
// `size`, `colors` of u16 or u8), or NO_COLOR_HIT where it has none
template <class TColor>
__device__ __forceinline__ int hit_color(const int hvox[3], const TColor* __restrict__ colors,
                                         int size) {
    int v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = hvox[c] < 0 ? 0 : (hvox[c] > size - 1 ? size - 1 : hvox[c]);
    const int cidx = (int)__ldg(&colors[voxel_addr(v[0], v[1], v[2], size)]);
    return cidx >= colorless<TColor>() ? NO_COLOR_HIT : cidx;
}

// What the single-hit march `m` ends with: on a hit, the hit voxel, its
// impact normal and color (`colors` of the world of edge `size`).
template <class TColor>
__device__ __forceinline__ Hit hit_of(const March& m, const TColor* __restrict__ colors,
                                      int size) {
    Hit out;
    out.hit = m.hit;
    out.hvox[0] = out.hvox[1] = out.hvox[2] = 0;
    out.normal[0] = out.normal[1] = out.normal[2] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) out.point[c] = m.p[c];
    out.voxel = EMPTY_DESC;
    if (m.hit) {
        hit_cell(m, out.hvox, out.normal);
        out.voxel = hit_color(out.hvox, colors, size);
    }
    return out;
}

// March the ray (o, d) through the pyramid: the reference's `trace` of one
// ray; with kStart, from `start_t` where `use_start` (init's start form);
// with kOpt, under the options `opt`.
template <bool kStart = false, bool kOpt = false, class TColor = unsigned short>
__device__ __forceinline__ Hit march(const float o[3], const float d[3],
                                     const uint2* __restrict__ occ,
                                     const TColor* __restrict__ colors,
                                     const int2* levels, int n_levels, int size, int n_blocks,
                                     int max_iters, float start_t = 0.f, bool use_start = true,
                                     const TraceOptions opt = TraceOptions{}) {
    const Grid g{occ, levels, n_levels, size, n_blocks};
    March m;
    init<kStart>(m, o, d, g, start_t, use_start);
    StopAtHit stop;
    run<StopAtHit, ADVANCE_SUBSTEPS, kOpt>(m, g, max_iters, stop, opt);
    return hit_of(m, colors, size);
}

}  // namespace vhx
