// The flat-tree tracers: one thread marches one ray through the FlatTree's
// node and brick pools, its whole state in registers.
//
// They replace no Pallas kernel: the reference's flat-tree renderers trace
// with XLA programs, and each becomes a kernel here.
//  * flat_vmap_kernel: the per-ray automaton that the reference vmaps
//    (`_make_trace_ray`, voxelhex_tpu/render/jax_renderer.py:140-400): up
//    to `max_restarts` passes from the root, each of at most `limit`
//    automaton steps; a brick probe marches at most `limit` cells, and an
//    ADVANCE takes its first DDA step and at most 16 more; the node stack
//    holds 4 keys and wraps around.
//  * flat_wavefront_kernel<kPow2>: the lock-step program of
//    voxelhex_tpu/render/wavefront.py:101-418, a body a turn (a BRICK cell
//    step, or a NODE probe, PUSH, POP or one ADVANCE step, then the
//    restart) for at most `limit` turns.  In the lock-step loop every live
//    ray takes one body a turn and no ray reads another's state, so a
//    thread that runs its own ray's bodies stops where the reference's ray
//    stops.
//  * flat_fast_kernel<kBitmap, kStart, kDepth, kPow2>: the same bodies over the
//    packed tree of voxelhex_tpu/render/fast.py:88-437 (child meta in bits
//    28/29 of the node entries, the stack of entries, the occupancy row of
//    the current node), with ADVANCE_SUBSTEPS steps an ADVANCE and the
//    voxel read once after the march.  kBitmap marches bricks of edge <= 4
//    on their occupancy word pair, fetched once a brick (BRICK_SUBSTEPS
//    cells a body, no voxel reads); without it a cell a body with a voxel
//    read.  kStart starts each ray from `start`: a start a ray, or (with
//    `half_h`) the half-res depth map of the prepassed frame, pooled here
//    (the 2x2 minimum with edge padding, less 2.0, at least 0) so the
//    pooling needs no launch of its own.  kDepth writes each ray's depth
//    instead (the prepass: norm(point - origin) on a hit, else 0).
//
// What bounds them on the H100: the instructions a warp runs.  A step
// reads one node row (8 B of occupancy, a 4 B child entry) or one voxel,
// and the bench tree's pools (0.9 MB of nodes, 1 MB of bricks) live in the
// 50 MB L2; the DDA steps are dependent f32 chains of ~40 operations.  The
// lanes of a warp take different moves in a turn: a wavefront body's moves
// that step (a BRICK cell, a POP, an ADVANCE) share one DDA step
// (shared_turn), while the fast tracer's bodies, whose cells and ADVANCE
// take substeps, keep a loop a move (brick_turn, node_turn), which was
// faster for them on the card; and a frame's launch gives each warp a 4 x
// 8 pixel tile (ray_index), whose rays take more alike bodies than 32 of a
// row.
// Where the host has checked that the world's edge and brick_dim are
// powers of two (`pow2`, the kPow2 instances), the batched tracers divide
// by an edge as a product by its exact inverse and take a parent's corner
// with block_floor (traverse.cuh), not fmodf: the same values.  The 4-deep
// stack is kept in registers with selects rather than indexed, so no
// thread has a stack frame.  The pools' reads go through the read-only
// cache, and brick offsets are 64-bit (a brick of edge 32 is 32,768
// voxels).
//
// Exactness: built with -fmad=false, so only the multiply-adds written here
// as __fmaf_rn are fused: those XLA:CPU fuses in each reference program
// (the entry point on x and y, and on z in the prepassed frame's full-res
// march; every DDA step on all three axes but the scalar tracer's first
// ADVANCE step on z; no restart nudge; the impact normal's sum of squares,
// not the prepass depth's).  Divisions and square roots are IEEE (no fast
// math) but for the kPow2 instances' products above, the float remainder
// is fmodf with jnp.mod's sign fix (block_floor in kPow2), and the
// min, max, fmin and fmax keep XLA's NaN and signed-zero rules
// (traverse.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse.cuh"

// The tree and caps of a launch: all that the tracers read
struct FlatTreeParams {
    const int* node_meta;       // [N] bit 0 leaf, bit 1 uniform (not packed)
    const int* node_children;   // [N, 64] child keys or brick descriptors
    const uint2* node_ocbits;   // [N] (lo, hi) occupancy words
    const int* bricks;          // [B, d^3] voxels
    const uint2* brick_ocbits;  // [B] brick occupancy words (fast tracer)
    const float* start;         // kStart: a start a ray, or the half-res depth map
    int n_bricks;
    int brick_dim;
    float size;        // world extent
    int root_meta;     // meta of node 0 (fast tracer)
    int limit;         // max_inner (scalar tracer) or max_iters
    int max_restarts;  // passes (scalar tracer) or restarts
    int start_w;       // with half_h: the frame's width, twice half_w
    int half_h, half_w;
};

// A launch: the tree, and the batched kernels' settings (the scalar tracer's
// kernel takes the tree alone)
struct FlatParams {
    FlatTreeParams tree;
    int pow2;            // 1: size and brick_dim are powers of two (the host checked)
    int tile_w, tile_h;  // > 0: the rays are a frame of tile_w x tile_h in row order
};

namespace vhx {
namespace flat {

constexpr int SOLID_FLAG = 1 << 30;
constexpr int META_SHIFT = 28;
constexpr int KEY_MASK = (1 << META_SHIFT) - 1;
constexpr int ADVANCE_STEPS = 16;    // the scalar tracer's ADVANCE: its first step and 16 more
constexpr int BRICK_SUBSTEPS = 4;    // the fast tracer's bitmap cells a body
constexpr int ADVANCE_SUBSTEPS = 2;  // the fast tracer's ADVANCE steps a body
constexpr int PH_NODE = 0, PH_BRICK = 1, PH_DONE = 2;

struct Out {
    bool hit;
    int voxel, brick, cell;
    float point[3], normal[3];
};

// the 4-deep stack of node keys or entries, indexed by a run-time head
__device__ __forceinline__ int stack_get(const int s[4], int i) {
    return i == 0 ? s[0] : (i == 1 ? s[1] : (i == 2 ? s[2] : s[3]));
}
__device__ __forceinline__ void stack_set(int s[4], int i, int v) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = i == k ? v : s[k];
}

// the sectant of `off` in a cell of edge `size`: clip(floor(off * 4 / size), 0, 3)
__device__ __forceinline__ int offset_sectant(const float off[3], float size) {
    return cell_index(__fdiv_rn(__fmul_rn(off[0], 4.f), size)) +
           cell_index(__fdiv_rn(__fmul_rn(off[1], 4.f), size)) * 4 +
           cell_index(__fdiv_rn(__fmul_rn(off[2], 4.f), size)) * 16;
}

// cmin + sectant_offset(s) * edge
__device__ __forceinline__ void sectant_min(const float cmin[3], int s, float edge, float out[3]) {
    float off[3];
    sectant_offset(s, off);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = __fadd_rn(cmin[c], __fmul_rn(off[c], edge));
}

// jnp.mod of floats: the exact remainder, moved into y's sign where the
// signs differ and it is not zero
__device__ __forceinline__ float xla_mod(float x, float y) {
    float r = fmodf(x, y);
    if (r != 0.f && ((r < 0.f) != (y < 0.f))) r = __fadd_rn(r, y);
    return r;
}

// (int)clip(trunc(x), 0, hi), NaN -> 0 (the reference's astype then clip)
__device__ __forceinline__ int clip_int(float x, int hi) {
    int i = (int)x;  // truncates and saturates; NaN -> 0
    return i < 0 ? 0 : (i > hi ? hi : i);
}

// the path lengths of the scalar tracer: each sum (a^2 + 1) + b^2 as two
// multiply-adds (the batched tracers' third is traverse.cuh's path_lengths)
__device__ __forceinline__ void path_lengths_scalar(const float d[3], float sf[3]) {
    const float pa[3] = {__fdiv_rn(d[2], d[0]), __fdiv_rn(d[0], d[1]), __fdiv_rn(d[0], d[2])};
    const float pb[3] = {__fdiv_rn(d[1], d[0]), __fdiv_rn(d[2], d[1]), __fdiv_rn(d[1], d[2])};
#pragma unroll
    for (int c = 0; c < 3; ++c)
        sf[c] = __fsqrt_rn(__fmaf_rn(pb[c], pb[c], __fmaf_rn(pa[c], pa[c], 1.f)));
}

// the ray's clip to the world box [0, S]^3: whether it meets it, its
// entry (from `start_t` on with `use_start`: clip(max(enter, start_t), 0,
// max(tmax - 1e-3, 0))) and the entry point, fused on x and y, and on z
// with `fuse_z` (the prepassed frame's full-res march)
__device__ __forceinline__ bool enter_root(const float o[3], const float d[3], float S,
                                           bool use_start, float start_t, bool fuse_z,
                                           float p[3]) {
    float pmin[3], pmax[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float t_lo = __fdiv_rn(__fsub_rn(0.f, o[c]), d[c]);
        const float t_hi = __fdiv_rn(__fsub_rn(S, o[c]), d[c]);
        pmin[c] = fmin_nan(t_lo, t_hi);
        pmax[c] = fmax_nan(t_lo, t_hi);
    }
    const float tmin_r = fmax_nan(fmax_nan(pmin[0], pmin[1]), pmin[2]);
    const float tmax_r = fmin_nan(fmin_nan(pmax[0], pmax[1]), pmax[2]);
    const bool hit = !((tmax_r < 0.f) || (tmin_r > tmax_r));
    float enter = xla_max(tmin_r, 0.f);
    if (use_start)
        enter = xla_min(xla_max(0.f, xla_max(enter, start_t)),
                        xla_max(__fsub_rn(tmax_r, 1e-3f), 0.f));
    p[0] = __fmaf_rn(d[0], enter, o[0]);
    p[1] = __fmaf_rn(d[1], enter, o[1]);
    p[2] = fuse_z ? __fmaf_rn(d[2], enter, o[2]) : __fadd_rn(o[2], __fmul_rn(d[2], enter));
    return hit;
}

__device__ __forceinline__ int octant_of(const float d[3]) {
    return (d[0] >= 0.f ? 1 : 0) + (d[2] >= 0.f ? 2 : 0) + (d[1] >= 0.f ? 4 : 0);
}

// the 0.1 nudge of a restart, not fused
__device__ __forceinline__ void nudge(const float d[3], float p[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(p[c], __fmul_rn(d[c], 0.1f));
}

__device__ __forceinline__ bool inside_world(const float p[3], float S) {
    return p[0] > 0.f && p[0] < S && p[1] > 0.f && p[1] < S && p[2] > 0.f && p[2] < S;
}

// cmin + (float)idx * unit
__device__ __forceinline__ void cell_min(const float bmin[3], const int idx[3], float unit,
                                         float out[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = __fadd_rn(bmin[c], __fmul_rn((float)idx[c], unit));
}

// the brick cell a ray enters at: clip(int((p - bmin) * d / bsize), 0, d - 1)
__device__ __forceinline__ void start_cell(const float p[3], const float bmin[3], float bsize,
                                           int d, int idx[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
        idx[c] = clip_int(__fdiv_rn(__fmul_rn(__fsub_rn(p[c], bmin[c]), (float)d), bsize), d - 1);
}

__device__ __forceinline__ bool in_brick(const int idx[3], int d) {
    return idx[0] >= 0 && idx[0] < d && idx[1] >= 0 && idx[1] < d && idx[2] >= 0 && idx[2] < d;
}

// ---------------------------------------------------------------------------
// the scalar tracer (jax_renderer.py _make_trace_ray)
// ---------------------------------------------------------------------------

__device__ void trace_scalar(const FlatTreeParams& P, const float o[3], const float d[3], Out& out) {
    const int D = P.brick_dim;
    const long long d3 = (long long)D * D * D;
    const float S = P.size;
    float sg[3], sf[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) sg[c] = sgn(d[c]);
    path_lengths_scalar(d, sf);
    const int octant = octant_of(d);

    float point[3];
    const bool root_hit = enter_root(o, d, S, false, 0.f, false, point);
    int tsect = root_hit ? offset_sectant(point, S) : OOB;

    out.hit = false;
    out.voxel = EMPTY_DESC;
    out.brick = out.cell = -1;
#pragma unroll
    for (int c = 0; c < 3; ++c) out.point[c] = out.normal[c] = 0.f;

    for (int pass = 0; tsect < OOB && !out.hit && pass < P.max_restarts; ++pass) {
        float cur_min[3] = {0.f, 0.f, 0.f}, tmin[3];
        float cur_size = S;
        sectant_min(cur_min, tsect, cur_size, tmin);
        float tsize = __fdiv_rn(cur_size, 4.f);
        int stack[4] = {0, 0, 0, 0};
        int head = 0, count = 1, cur_key = 0;
        for (int it = 0; count > 0 && !out.hit && it < P.limit; ++it) {
            const uint2 occ = __ldg(&P.node_ocbits[stack_get(stack, head)]);
            const int meta = __ldg(&P.node_meta[cur_key]);
            const bool is_leaf = (meta & 1) != 0, is_uniform = (meta & 2) != 0;
            const int tc = clamp63(tsect);
            const int desc = __ldg(&P.node_children[(long long)cur_key * 64 + tc]);

            // probe the sectant's brick on a leaf
            if (is_leaf && tsect < OOB) {
                float bmin[3];
                float bsize = cur_size;
                if (is_uniform) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) bmin[c] = cur_min[c];
                } else {
                    sectant_min(cur_min, tc, cur_size, bmin);
                    bsize = __fdiv_rn(cur_size, 4.f);
                }
                if (desc != EMPTY_DESC && (desc & SOLID_FLAG) != 0) {
                    out.hit = true;
                    out.voxel = desc & ~SOLID_FLAG;
                    out.brick = out.cell = -1;
                    impact_normal(bmin, bsize, point, out.normal);
#pragma unroll
                    for (int c = 0; c < 3; ++c) out.point[c] = point[c];
                } else if (desc != EMPTY_DESC) {
                    const float unit = __fdiv_rn(bsize, (float)D);
                    int idx[3];
                    start_cell(point, bmin, bsize, D, idx);
                    const int* row = P.bricks + (long long)(desc > 0 ? desc : 0) * d3;
                    bool found = false;
                    int v = EMPTY_DESC;
                    for (int k = 0; in_brick(idx, D) && !found && k < P.limit; ++k) {
                        const int vox = __ldg(&row[idx[0] + idx[1] * D + idx[2] * D * D]);
                        float cmin[3], np[3], st[3];
                        cell_min(bmin, idx, unit, cmin);
                        dda_step<7>(d, sg, sf, point, cmin, unit, np, st);
                        found = vox != EMPTY_DESC;
                        if (found) {
                            v = vox;
                        } else {
#pragma unroll
                            for (int c = 0; c < 3; ++c) {
                                point[c] = np[c];
                                idx[c] += (int)st[c];
                            }
                        }
                    }
                    if (found) {
                        float cmin[3];
                        cell_min(bmin, idx, unit, cmin);
                        int ic[3];
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            ic[c] = idx[c] < 0 ? 0 : (idx[c] > D - 1 ? D - 1 : idx[c]);
                            out.point[c] = point[c];
                        }
                        out.hit = true;
                        out.voxel = v;
                        out.brick = desc;
                        out.cell = ic[0] + ic[1] * D + ic[2] * D * D;
                        impact_normal(cmin, unit, point, out.normal);
                    }
                }
            }
            if (out.hit) break;

            uint32_t m_lo, m_hi;
            reach_mask(tc, octant, m_lo, m_hi);
            const bool want_pop = is_uniform || tsect >= OOB || (occ.x == 0u && occ.y == 0u) ||
                                  ((occ.x & m_lo) == 0u && (occ.y & m_hi) == 0u);
            const bool want_push = !is_leaf && occ_bit(occ.x, occ.y, tsect) && tsect < OOB;
            if (want_pop) {
                const int new_count = count - 1;
                const int new_head = (head + 3) & 3;
                const float p_size = __fmul_rn(cur_size, 4.f);
                float p_min[3], mid[3], np[3], st[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    p_min[c] = __fsub_rn(cur_min[c], xla_mod(cur_min[c], p_size));
                    mid[c] = __fsub_rn(__fadd_rn(cur_min[c], __fdiv_rn(cur_size, 2.f)), p_min[c]);
                }
                const int ts = offset_sectant(mid, p_size);
                dda_step<7>(d, sg, sf, point, cur_min, cur_size, np, st);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    point[c] = np[c];
                    tmin[c] = __fadd_rn(cur_min[c], __fmul_rn(st[c], cur_size));
                    cur_min[c] = p_min[c];
                }
                tsect = step_sectant(ts, st);
                tsize = cur_size;
                cur_size = p_size;
                if (new_count > 0) cur_key = stack_get(stack, new_head);
                head = new_head;
                count = new_count;
            } else if (want_push) {
                float off[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    cur_min[c] = tmin[c];
                    off[c] = __fsub_rn(point[c], tmin[c]);
                }
                cur_size = tsize;
                tsect = offset_sectant(off, cur_size);
                sectant_min(cur_min, tsect, cur_size, tmin);
                tsize = __fdiv_rn(cur_size, 4.f);
                head = (head + 1) & 3;
                stack_set(stack, head, desc);
                count = count + 1 < 4 ? count + 1 : 4;
                cur_key = desc;
            } else {
                // ADVANCE: a first DDA step (not fused on z), then up to 16
                // more until an occupied sectant or the node's edge
                float np[3], st[3];
                dda_step<3>(d, sg, sf, point, tmin, tsize, np, st);
                int ts = step_sectant(tsect, st);
                if (ts < OOB) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) tmin[c] = __fadd_rn(tmin[c], __fmul_rn(st[c], tsize));
                }
                for (int k = 0; !(ts >= OOB || occ_bit(occ.x, occ.y, ts)) && k < ADVANCE_STEPS; ++k) {
                    dda_step<7>(d, sg, sf, np, tmin, tsize, np, st);
                    ts = step_sectant(ts, st);
                    if (ts < OOB) {
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            tmin[c] = __fadd_rn(tmin[c], __fmul_rn(st[c], tsize));
                    }
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) point[c] = np[c];
                tsect = ts;
            }
        }
        // the restart: nudge on, and take the root's sectant there
        nudge(d, point);
        tsect = out.hit ? OOB : (inside_world(point, S) ? offset_sectant(point, S) : OOB);
    }
}

// ---------------------------------------------------------------------------
// the batched tracers (wavefront.py, fast.py), a ray's bodies in turn
// ---------------------------------------------------------------------------

// 1 / x for x a power of two whose inverse is a normal f32: exact, from the
// exponent bits
__device__ __forceinline__ float inv_pow2(float x) {
    return __int_as_float(0x7F000000 - __float_as_int(x));
}

// x / e for e an edge of the tree (S / 4^k, or a brick's cell): with kPow2
// (the host checked that S and brick_dim are powers of two) x * (1 / e),
// which rounds the same real number once as the division does, so it is
// the same value; else the IEEE division
template <bool kPow2>
__device__ __forceinline__ float div_edge(float x, float e) {
    if constexpr (kPow2) return __fmul_rn(x, inv_pow2(e));
    else return __fdiv_rn(x, e);
}

// the sectant of `off` in a cell of edge `size` (offset_sectant), by
// div_edge
template <bool kPow2>
__device__ __forceinline__ int sectant_in(const float off[3], float size) {
    if constexpr (kPow2) return vhx::offset_sectant(off, inv_pow2(size));
    else return offset_sectant(off, size);
}

// cmin - jnp.mod(cmin, p): the corner of the p-block that holds the node
// corner cmin; with kPow2 block_floor (traverse.cuh), exact for the
// non-negative corners a node has, else fmodf's remainder
template <bool kPow2>
__device__ __forceinline__ float parent_corner(float cmin, float p) {
    if constexpr (kPow2) return block_floor(cmin, p, inv_pow2(p));
    else return __fsub_rn(cmin, xla_mod(cmin, p));
}

// the brick cell a ray enters at: clip(int((p - bmin) * d / bsize), 0, d - 1)
template <bool kPow2>
__device__ __forceinline__ void enter_cell(const float p[3], const float bmin[3], float bsize,
                                           int d, int idx[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
        idx[c] = clip_int(div_edge<kPow2>(__fmul_rn(__fsub_rn(p[c], bmin[c]), (float)d), bsize),
                          d - 1);
}

struct Lockstep {
    float point[3], cur_min[3], tmin[3], bmin[3], hnormal[3];
    float cur_size, tsize, bsize;
    int stack[4];
    int tsect, head, count, cur, restarts, phase, bidx, bcell[3], voxel, hbrick, hcell;
    uint32_t b_lo, b_hi;
    bool probed, force_pop, b_uniform, hit;
};

// The moves of a body: none that steps (a probe, a PUSH, a hit), or one
// that takes DDA steps: a BRICK cell step, a POP, an ADVANCE
constexpr int MV_NONE = 0, MV_CELL = 1, MV_POP = 2, MV_ADV = 3;

// An edge / 4 or / 2 is written as a product by 0.25 or 0.5: the inverse of
// a power-of-two divisor is exact, so it is the same value for any edge.
template <bool kPacked>
__device__ __forceinline__ void restart_at_root(Lockstep& s, const FlatTreeParams& P) {
    const float zero[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) s.cur_min[c] = 0.f;
    s.cur_size = P.size;
    sectant_min(zero, clamp63(s.tsect), P.size, s.tmin);
    s.tsize = __fmul_rn(P.size, 0.25f);
    s.head = 0;
    s.cur = kPacked ? P.root_meta << META_SHIFT : 0;
    s.stack[0] = s.cur;
    s.stack[1] = s.stack[2] = s.stack[3] = 0;
}

// A hit in the box (bmin, size): the wavefront takes its impact normal
// now; the fast tracer keeps the box in the brick's fields, which a done
// ray no longer reads, and takes the normal after the march (lockstep_out:
// none for the depth form), which was faster on the card for it alone
// (PERF.md)
template <bool kPacked>
__device__ __forceinline__ void hit_box(Lockstep& s, const float bmin[3], float size) {
    if constexpr (kPacked) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s.bmin[c] = bmin[c];
        s.bsize = size;
    } else {
        impact_normal(bmin, size, s.point, s.hnormal);
    }
}

// A BRICK cell's test, before its step: a hit ends the march, a cell
// outside the brick sends the ray back to its node (probed); else the
// cell's corner `cmin` for the step, and true.  `unit` is the cell's edge.
template <bool kPacked, bool kBitmap>
__device__ __forceinline__ bool brick_cell(Lockstep& s, const FlatTreeParams& P, float unit,
                                           float cmin[3]) {
    const int D = P.brick_dim;
    const bool inb = in_brick(s.bcell, D);
    const int flat = s.bcell[0] + s.bcell[1] * D + s.bcell[2] * D * D;
    bool occupied;
    int vox = EMPTY_DESC;
    if constexpr (kBitmap) {
        const int scale = 4 / D;
        occupied = occ_bit(s.b_lo, s.b_hi,
                           s.bcell[0] * scale + s.bcell[1] * scale * 4 + s.bcell[2] * scale * 16);
    } else {
        const long long d3 = (long long)D * D * D;
        const int b = s.bidx < 0 ? 0 : (s.bidx > P.n_bricks - 1 ? P.n_bricks - 1 : s.bidx);
        const long long f = flat < 0 ? 0 : (flat > d3 - 1 ? d3 - 1 : flat);
        vox = __ldg(&P.bricks[(long long)b * d3 + f]);
        occupied = vox != EMPTY_DESC;
    }
    cell_min(s.bmin, s.bcell, unit, cmin);
    if (inb && occupied) {
        s.hit = true;
        if (!kPacked) s.voxel = vox;
        s.hbrick = s.bidx;
        s.hcell = flat;
        hit_box<kPacked>(s, cmin, unit);
        s.phase = PH_DONE;
        return false;
    }
    if (!inb) {
        s.phase = PH_NODE;
        s.probed = true;
        s.force_pop = s.force_pop || s.b_uniform;
        return false;
    }
    return true;
}

// The start of a NODE body: probe the sectant's brick once (a hit, or the
// ray enters the brick), else PUSH, all done here (MV_NONE); or a POP or
// an ADVANCE, returned with the box of its DDA step (`box`, `edge`) and the
// node's occupancy words `occ`
template <bool kPacked, bool kPow2>
__device__ __forceinline__ int node_start(Lockstep& s, const FlatTreeParams& P, int octant,
                                          uint2& occ, float box[3], float& edge) {
    const int D = P.brick_dim;
    const int key = kPacked ? (s.cur & KEY_MASK) : s.cur;
    occ = __ldg(&P.node_ocbits[kPacked ? key : stack_get(s.stack, s.head)]);
    const int meta = kPacked ? (s.cur >> META_SHIFT) & 3 : __ldg(&P.node_meta[key]);
    const bool is_leaf = (meta & 1) != 0, is_uniform = (meta & 2) != 0;
    const int tc = clamp63(s.tsect);
    const int desc = __ldg(&P.node_children[(long long)key * 64 + tc]);

    const bool can_probe = is_leaf && s.tsect < OOB && !s.probed;
    if (can_probe && desc != EMPTY_DESC) {
        float bmin[3];
        float bsize = s.cur_size;
        if (is_uniform) {
#pragma unroll
            for (int c = 0; c < 3; ++c) bmin[c] = s.cur_min[c];
        } else {
            sectant_min(s.cur_min, tc, s.cur_size, bmin);
            bsize = __fmul_rn(s.cur_size, 0.25f);
        }
        if ((desc & SOLID_FLAG) != 0) {
            s.hit = true;
            s.voxel = kPacked ? desc & (SOLID_FLAG - 1) : desc & ~SOLID_FLAG;
            s.hbrick = s.hcell = -1;
            hit_box<kPacked>(s, bmin, bsize);
            s.phase = PH_DONE;
        } else {
            if (kPacked) {
                const int b = desc > P.n_bricks - 1 ? P.n_bricks - 1 : desc;
                const uint2 w = __ldg(&P.brick_ocbits[b]);
                s.b_lo = w.x;
                s.b_hi = w.y;
            }
            enter_cell<kPow2>(s.point, bmin, bsize, D, s.bcell);
            s.bidx = desc;
#pragma unroll
            for (int c = 0; c < 3; ++c) s.bmin[c] = bmin[c];
            s.bsize = bsize;
            s.b_uniform = is_uniform;
            s.phase = PH_BRICK;
        }
        return MV_NONE;
    }
    if (can_probe) {  // an empty sectant, probed once
        s.force_pop = s.force_pop || is_uniform;
        s.probed = true;
    }

    uint32_t m_lo, m_hi;
    reach_mask(tc, octant, m_lo, m_hi);
    const bool want_pop = s.force_pop || s.tsect >= OOB || (occ.x == 0u && occ.y == 0u) ||
                          ((occ.x & m_lo) == 0u && (occ.y & m_hi) == 0u);
    const bool want_push = !want_pop && !is_leaf && occ_bit(occ.x, occ.y, s.tsect) && s.tsect < OOB;
    s.probed = false;
    s.force_pop = false;
    if (want_pop) {
#pragma unroll
        for (int c = 0; c < 3; ++c) box[c] = s.cur_min[c];
        edge = s.cur_size;
        return MV_POP;
    }
    if (want_push) {
        float off[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            s.cur_min[c] = s.tmin[c];
            off[c] = __fsub_rn(s.point[c], s.tmin[c]);
        }
        s.cur_size = s.tsize;
        s.tsect = sectant_in<kPow2>(off, s.cur_size);
        sectant_min(s.cur_min, s.tsect, s.cur_size, s.tmin);
        s.tsize = __fmul_rn(s.cur_size, 0.25f);
        s.head = (s.head + 1) & 3;
        stack_set(s.stack, s.head, desc);
        s.count = s.count + 1 < 4 ? s.count + 1 : 4;
        s.cur = desc;
        return MV_NONE;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) box[c] = s.tmin[c];
    edge = s.tsize;
    return MV_ADV;
}

// A POP's tail, after its DDA step (np, st) through the node: up to the
// parent, derived arithmetically
template <bool kPow2>
__device__ __forceinline__ void pop_tail(Lockstep& s, const float np[3], const float st[3]) {
    const int new_count = s.count - 1;
    const int new_head = (s.head + 3) & 3;
    const float p_size = __fmul_rn(s.cur_size, 4.f);
    float p_min[3], mid[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        p_min[c] = parent_corner<kPow2>(s.cur_min[c], p_size);
        mid[c] = __fsub_rn(__fadd_rn(s.cur_min[c], __fmul_rn(s.cur_size, 0.5f)), p_min[c]);
    }
    const int ts = sectant_in<kPow2>(mid, p_size);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        s.point[c] = np[c];
        s.tmin[c] = __fadd_rn(s.cur_min[c], __fmul_rn(st[c], s.cur_size));
        s.cur_min[c] = p_min[c];
    }
    s.tsect = step_sectant(ts, st);
    s.tsize = s.cur_size;
    s.cur_size = p_size;
    if (new_count > 0) s.cur = stack_get(s.stack, new_head);
    s.head = new_head;
    s.count = new_count;
}

// An ADVANCE substep to the DDA step's point (np, st); true where the
// ADVANCE stops: the sectant left the node or is occupied
__device__ __forceinline__ bool advance_sub(Lockstep& s, const float np[3], const float st[3],
                                           uint2 occ) {
    const int ts = step_sectant(s.tsect, st);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        s.point[c] = np[c];
        if (ts < OOB) s.tmin[c] = __fadd_rn(s.tmin[c], __fmul_rn(st[c], s.tsize));
    }
    s.tsect = ts;
    return ts >= OOB || occ_bit(occ.x, occ.y, ts);
}

// the edge of a brick's cell: bsize / brick_dim
template <bool kPow2>
__device__ __forceinline__ float brick_unit(const Lockstep& s, const FlatTreeParams& P) {
    return kPow2 ? __fmul_rn(s.bsize, inv_pow2((float)P.brick_dim))
                 : __fdiv_rn(s.bsize, (float)P.brick_dim);
}

// One wavefront body: each of its moves that steps (a BRICK cell, a POP,
// an ADVANCE) takes one DDA step, so the lanes of a warp share one: each
// picks its move and the box of its step (the cell, the node, the
// sectant), all take the step, then each move's tail runs.
template <bool kPow2>
__device__ __forceinline__ void shared_turn(Lockstep& s, const FlatTreeParams& P, const float d[3],
                                            const float sg[3], const float sf[3], int octant) {
    float box[3], edge, np[3], st[3];
    uint2 occ = make_uint2(0u, 0u);
    int move;
    if (s.phase == PH_BRICK) {
        edge = brick_unit<kPow2>(s, P);
        move = brick_cell<false, false>(s, P, edge, box) ? MV_CELL : MV_NONE;
    } else {
        move = node_start<false, kPow2>(s, P, octant, occ, box, edge);
    }
    if (move == MV_NONE) return;
    dda_step<7>(d, sg, sf, s.point, box, edge, np, st);
    if (move == MV_CELL) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            s.point[c] = np[c];
            s.bcell[c] += (int)st[c];
        }
    } else if (move == MV_ADV) {
        advance_sub(s, np, st, occ);
    } else {
        pop_tail<kPow2>(s, np, st);
    }
}

// One fast-tracer BRICK body: up to kCells cell steps (BRICK_SUBSTEPS on the
// brick's occupancy bits with kBitmap, else one with a voxel read), each
// tested before its step.  Its loop runs apart from the NODE body's: shared
// with the node's moves, a turn of the loop ran every move's tail for the
// warp and lost on the card (PERF.md).
template <bool kBitmap, bool kPow2>
__device__ __forceinline__ void brick_turn(Lockstep& s, const FlatTreeParams& P, const float d[3],
                                           const float sg[3], const float sf[3]) {
    const float unit = brick_unit<kPow2>(s, P);
    constexpr int kCells = kBitmap ? BRICK_SUBSTEPS : 1;
#pragma unroll 1
    for (int k = 0; k < kCells; ++k) {
        float cmin[3], np[3], st[3];
        if (!brick_cell<true, kBitmap>(s, P, unit, cmin)) return;
        dda_step<7>(d, sg, sf, s.point, cmin, unit, np, st);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            s.point[c] = np[c];
            s.bcell[c] += (int)st[c];
        }
    }
}

// One fast-tracer NODE body: a probe or PUSH, a POP's one DDA step, or up
// to ADVANCE_SUBSTEPS substeps of an ADVANCE
template <bool kPow2>
__device__ __forceinline__ void node_turn(Lockstep& s, const FlatTreeParams& P, const float d[3],
                                          const float sg[3], const float sf[3], int octant) {
    float box[3], edge, np[3], st[3];
    uint2 occ;
    const int move = node_start<true, kPow2>(s, P, octant, occ, box, edge);
    if (move == MV_POP) {
        dda_step<7>(d, sg, sf, s.point, box, edge, np, st);
        pop_tail<kPow2>(s, np, st);
    } else if (move == MV_ADV) {
#pragma unroll 1
        for (int k = 0; k < ADVANCE_SUBSTEPS; ++k) {
            dda_step<7>(d, sg, sf, s.point, s.tmin, s.tsize, np, st);
            if (advance_sub(s, np, st, occ)) break;
        }
    }
}

// The march of one ray by the batched tracers' bodies, one a turn; its
// start from `start_t` with kStart.  Each lane computes the same f32
// operations in the same order on the same values as the plain tracer's
// body: only the loop's shape is the GPU's (shared_turn, brick_turn,
// node_turn).
template <bool kPacked, bool kBitmap, bool kStart, bool kPow2>
__device__ void trace_lockstep(const FlatTreeParams& P, const float o[3], const float d[3],
                               float start_t, Lockstep& s) {
    const float S = P.size;
    float sg[3], sf[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) sg[c] = sgn(d[c]);
    path_lengths(d, sf);
    const int octant = octant_of(d);

    const bool root_hit =
        enter_root(o, d, S, kStart, start_t, kStart && P.half_h > 0, s.point);
    s.tsect = root_hit ? sectant_in<kPow2>(s.point, S) : OOB;
    restart_at_root<kPacked>(s, P);
    s.count = root_hit ? 1 : 0;
    s.probed = s.force_pop = s.b_uniform = s.hit = false;
    s.restarts = 0;
    s.phase = root_hit ? PH_NODE : PH_DONE;
    s.b_lo = s.b_hi = 0u;
    s.bidx = 0;
    s.bsize = 1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        s.bcell[c] = 0;
        s.bmin[c] = s.hnormal[c] = 0.f;
    }
    s.voxel = EMPTY_DESC;
    s.hbrick = s.hcell = -1;

#pragma unroll 1
    for (int it = 0; it < P.limit && s.phase != PH_DONE; ++it) {
        if constexpr (!kPacked)
            shared_turn<kPow2>(s, P, d, sg, sf, octant);
        else if (s.phase == PH_BRICK)
            brick_turn<kBitmap, kPow2>(s, P, d, sg, sf);
        else
            node_turn<kPow2>(s, P, d, sg, sf, octant);
        // a stack run dry: nudge on and start again from the root, or stop
        if (s.phase == PH_NODE && s.count <= 0) {
            nudge(d, s.point);
            const bool again = inside_world(s.point, S) && s.restarts < P.max_restarts;
            s.restarts += 1;
            if (again) {
                s.tsect = sectant_in<kPow2>(s.point, S);
                restart_at_root<kPacked>(s, P);
                s.count = 1;
                s.probed = s.force_pop = false;
            } else {
                s.phase = PH_DONE;
            }
        }
    }
}

__device__ __forceinline__ void load_ray(const float* o, const float* d, int r, float ro[3],
                                         float rd[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        ro[c] = o[3 * r + c];
        rd[c] = d[3 * r + c];
    }
}

__device__ __forceinline__ void store(const Out& v, int r, bool* hit, int* voxel, int* brick,
                                      int* cell, float* point, float* normal) {
    hit[r] = v.hit;
    voxel[r] = v.voxel;
    brick[r] = v.brick;
    cell[r] = v.cell;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        point[3 * r + c] = v.point[c];
        normal[3 * r + c] = v.normal[c];
    }
}

// the start of ray r of a frame `start_w` wide from the half-res depth
// map: the minimum of its half-res pixel's 2x2 neighbourhood (the map's
// last row and column repeated past its edge), less 2.0, at least 0
__device__ __forceinline__ float pooled_start(const FlatTreeParams& P, int r) {
    const int y2 = (r / P.start_w) / 2, x2 = (r % P.start_w) / 2;
    const int y3 = y2 + 1 < P.half_h ? y2 + 1 : y2, x3 = x2 + 1 < P.half_w ? x2 + 1 : x2;
    const float* m = P.start;
    const float a = __ldg(&m[y2 * P.half_w + x2]), b = __ldg(&m[y3 * P.half_w + x2]);
    const float c = __ldg(&m[y2 * P.half_w + x3]), e = __ldg(&m[y3 * P.half_w + x3]);
    return xla_max(__fsub_rn(xla_min(xla_min(a, b), xla_min(c, e)), 2.f), 0.f);
}

// A frame's launch gives each warp a 4-column x 8-row pixel tile of the
// frame (frame.cuh's shape): its lanes' rays are neighbours, so they take
// similar bodies and fewer lanes wait on the warp's slowest ray.  A block's
// four warps sit side by side, so block (bx, by) covers 16 x 8 pixels.
constexpr int WARP_W = 4;
constexpr int WARP_H = 8;
constexpr int BLOCK_W = WARP_W * 4;

// The ray of this thread, or -1: in row order (a warp 32 rays of a row)
// without a frame, else for a frame `tile_w` x `tile_h` in row order the
// ray of the lane's pixel in its warp's tile (-1 past the frame's edge)
__device__ __forceinline__ int ray_index(const FlatParams& P, int R) {
    if (P.tile_w <= 0) {
        const int r = blockIdx.x * blockDim.x + threadIdx.x;
        return r < R ? r : -1;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = blockIdx.x * BLOCK_W + warp * WARP_W + lane % WARP_W;
    const int y = blockIdx.y * WARP_H + lane / WARP_W;
    return x < P.tile_w && y < P.tile_h ? y * P.tile_w + x : -1;
}

}  // namespace flat
}  // namespace vhx

using vhx::flat::Lockstep;
using vhx::flat::Out;

__global__ void __launch_bounds__(128)
flat_vmap_kernel(const FlatTreeParams P, const float* __restrict__ o, const float* __restrict__ d,
                 int R, bool* hit, int* voxel, int* brick, int* cell, float* point,
                 float* normal) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float ro[3], rd[3];
    vhx::flat::load_ray(o, d, r, ro, rd);
    Out v;
    vhx::flat::trace_scalar(P, ro, rd, v);
    vhx::flat::store(v, r, hit, voxel, brick, cell, point, normal);
}

// The batched kernels' output of a march; the fast tracer's (kPacked) reads
// the voxel of a parted hit from its brick once, after the march, and takes
// the hit's impact normal from its box (hit_box)
template <bool kPacked>
__device__ __forceinline__ Out lockstep_out(const FlatTreeParams& P, const Lockstep& s) {
    Out v;
    v.hit = s.hit;
    v.voxel = s.voxel;
    if (kPacked && s.hit && s.hbrick >= 0) {
        const int D = P.brick_dim;
        const long long d3 = (long long)D * D * D;
        const int b = s.hbrick > P.n_bricks - 1 ? P.n_bricks - 1 : s.hbrick;
        const long long f = s.hcell < 0 ? 0 : (s.hcell > d3 - 1 ? d3 - 1 : s.hcell);
        v.voxel = __ldg(&P.bricks[(long long)b * d3 + f]);
    }
    v.brick = s.hbrick;
    v.cell = s.hcell;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        v.point[c] = s.point[c];
        v.normal[c] = kPacked ? 0.f : s.hnormal[c];
    }
    if (kPacked && s.hit) vhx::impact_normal(s.bmin, s.bsize, s.point, v.normal);
    return v;
}

template <bool kPow2>
__global__ void __launch_bounds__(128)
flat_wavefront_kernel(const FlatParams F, const float* __restrict__ o,
                      const float* __restrict__ d, int R, bool* hit, int* voxel, int* brick,
                      int* cell, float* point, float* normal) {
    const int r = vhx::flat::ray_index(F, R);
    if (r < 0) return;
    const FlatTreeParams& P = F.tree;
    float ro[3], rd[3];
    vhx::flat::load_ray(o, d, r, ro, rd);
    Lockstep s;
    vhx::flat::trace_lockstep<false, false, false, kPow2>(P, ro, rd, 0.f, s);
    vhx::flat::store(lockstep_out<false>(P, s), r, hit, voxel, brick, cell, point, normal);
}

// kDepth: `hit` is the depth map [R] (f32) and the other outputs are unused
template <bool kBitmap, bool kStart, bool kDepth, bool kPow2>
__global__ void __launch_bounds__(128)
flat_fast_kernel(const FlatParams F, const float* __restrict__ o, const float* __restrict__ d,
                 int R, void* hit, int* voxel, int* brick, int* cell, float* point,
                 float* normal) {
    const int r = vhx::flat::ray_index(F, R);
    if (r < 0) return;
    const FlatTreeParams& P = F.tree;
    float ro[3], rd[3];
    vhx::flat::load_ray(o, d, r, ro, rd);
    float start_t = 0.f;
    if constexpr (kStart)
        start_t = P.half_h > 0 ? vhx::flat::pooled_start(P, r) : __ldg(&P.start[r]);
    Lockstep s;
    vhx::flat::trace_lockstep<true, kBitmap, kStart, kPow2>(P, ro, rd, start_t, s);
    if constexpr (kDepth) {
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = __fsub_rn(s.point[c], ro[c]);
        const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                                   __fmul_rn(x[2], x[2]));
        static_cast<float*>(hit)[r] = s.hit ? __fsqrt_rn(sq) : 0.f;
        return;
    }
    vhx::flat::store(lockstep_out<true>(P, s), r, static_cast<bool*>(hit), voxel, brick, cell,
                     point, normal);
}

namespace {

constexpr int kThreads = 128;

// The grid of a batched launch: a thread a ray in row order, or a frame's
// 16 x 8 pixel blocks (ray_index)
dim3 lockstep_grid(const FlatParams& P, int R) {
    if (P.tile_w > 0)
        return dim3((P.tile_w + vhx::flat::BLOCK_W - 1) / vhx::flat::BLOCK_W,
                    (P.tile_h + vhx::flat::WARP_H - 1) / vhx::flat::WARP_H);
    return dim3((R + kThreads - 1) / kThreads);
}

// Whether the batched entries can launch with P: a brick row, and a frame
// (tile_w, tile_h) of exactly R rays where one is given
bool lockstep_params_ok(const FlatParams* P, int R) {
    return P->tree.brick_dim >= 1 && P->tree.n_bricks >= 1 &&
           (P->tile_w <= 0 || (P->tile_h >= 1 && (long long)P->tile_w * P->tile_h == R));
}

template <bool kBitmap, bool kStart, bool kDepth, bool kPow2>
void launch_fast(const FlatParams& P, const float* o, const float* d, int R, void* hit,
                 int* voxel, int* brick, int* cell, float* point, float* normal,
                 cudaStream_t stream) {
    flat_fast_kernel<kBitmap, kStart, kDepth, kPow2><<<lockstep_grid(P, R), kThreads, 0, stream>>>(
        P, o, d, R, hit, voxel, brick, cell, point, normal);
}

template <bool kDepth, bool kPow2>
void launch_fast_form(const FlatParams& P, const float* o, const float* d, int R, void* hit,
                      int* voxel, int* brick, int* cell, float* point, float* normal,
                      cudaStream_t stream) {
    const bool bitmap = P.tree.brick_dim <= 4, start = P.tree.start != nullptr;
    if (bitmap && start)
        launch_fast<true, true, kDepth, kPow2>(P, o, d, R, hit, voxel, brick, cell, point, normal,
                                               stream);
    else if (bitmap)
        launch_fast<true, false, kDepth, kPow2>(P, o, d, R, hit, voxel, brick, cell, point,
                                                normal, stream);
    else if (start)
        launch_fast<false, true, kDepth, kPow2>(P, o, d, R, hit, voxel, brick, cell, point,
                                                normal, stream);
    else
        launch_fast<false, false, kDepth, kPow2>(P, o, d, R, hit, voxel, brick, cell, point,
                                                 normal, stream);
}

template <bool kDepth>
cudaError_t fast_entry(const FlatParams* P, const float* o, const float* d, int R, void* hit,
                       int* voxel, int* brick, int* cell, float* point, float* normal,
                       int device, cudaStream_t stream) {
    const FlatTreeParams& T = P->tree;
    if (!lockstep_params_ok(P, R) ||
        (T.start && T.half_h > 0 && (T.start_w != 2 * T.half_w || R != 4 * T.half_h * T.half_w)))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (R <= 0) return cudaSuccess;
    if (P->pow2)
        launch_fast_form<kDepth, true>(*P, o, d, R, hit, voxel, brick, cell, point, normal, stream);
    else
        launch_fast_form<kDepth, false>(*P, o, d, R, hit, voxel, brick, cell, point, normal,
                                        stream);
    return cudaGetLastError();
}

}  // namespace

extern "C" int vhx_flat_params_size() { return (int)sizeof(FlatParams); }

extern "C" cudaError_t vhx_flat_vmap(const FlatParams* P, const float* o, const float* d, int R,
                                     void* hit, int* voxel, int* brick, int* cell, float* point,
                                     float* normal, int device, cudaStream_t stream) {
    if (P->tree.brick_dim < 1 || P->tree.n_bricks < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (R <= 0) return cudaSuccess;
    const int blocks = (R + kThreads - 1) / kThreads;
    flat_vmap_kernel<<<blocks, kThreads, 0, stream>>>(P->tree, o, d, R, static_cast<bool*>(hit),
                                                      voxel, brick, cell, point, normal);
    return cudaGetLastError();
}

extern "C" cudaError_t vhx_flat_wavefront(const FlatParams* P, const float* o, const float* d,
                                          int R, void* hit, int* voxel, int* brick, int* cell,
                                          float* point, float* normal, int device,
                                          cudaStream_t stream) {
    if (!lockstep_params_ok(P, R)) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (R <= 0) return cudaSuccess;
    const dim3 grid = lockstep_grid(*P, R);
    if (P->pow2)
        flat_wavefront_kernel<true><<<grid, kThreads, 0, stream>>>(
            *P, o, d, R, static_cast<bool*>(hit), voxel, brick, cell, point, normal);
    else
        flat_wavefront_kernel<false><<<grid, kThreads, 0, stream>>>(
            *P, o, d, R, static_cast<bool*>(hit), voxel, brick, cell, point, normal);
    return cudaGetLastError();
}

extern "C" cudaError_t vhx_flat_fast(const FlatParams* P, const float* o, const float* d, int R,
                                     void* hit, int* voxel, int* brick, int* cell, float* point,
                                     float* normal, int device, cudaStream_t stream) {
    return fast_entry<false>(P, o, d, R, hit, voxel, brick, cell, point, normal, device, stream);
}

// the prepass: each ray's depth into `depth` [R]
extern "C" cudaError_t vhx_flat_fast_depth(const FlatParams* P, const float* o, const float* d,
                                           int R, float* depth, int device, cudaStream_t stream) {
    return fast_entry<true>(P, o, d, R, depth, nullptr, nullptr, nullptr, nullptr, nullptr,
                            device, stream);
}
