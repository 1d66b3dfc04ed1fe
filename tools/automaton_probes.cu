// One kernel for each piece of the BitGrid automaton's loop (`vhx::run`,
// voxelhex_tpu_torch/csrc/traverse.cuh), so that its instructions can be
// counted in the SASS: tools/automaton_ab.py --sass builds this file with
// the kernels' flags and counts each kernel's instructions, leaving out
// loads, stores and the kernel's own frame (what every probe has).
//
// `probe_dda_before` is the DDA step as the loop computed it before the
// signs of d moved into the ray's state: sgn(d) and max(sg, 0) in each
// evaluation.  The others call traverse.cuh's functions as `run` does.

#include "../voxelhex_tpu_torch/csrc/traverse.cuh"

using vhx::March;

namespace {

__device__ __forceinline__ void dda_before(const float d[3], const float sf[3], const float p[3],
                                           const float cmin[3], float csize, float new_p[3],
                                           float step[3]) {
    float sg[3], dist[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        sg[c] = vhx::sgn(d[c]);
        float need = __fsub_rn(__fmul_rn(csize, vhx::xla_max(sg[c], 0.f)),
                               __fmul_rn(sg[c], __fsub_rn(p[c], cmin[c])));
        float dd = fabsf(__fmul_rn(need, sf[c]));
        if (d[c] == 0.f) dd = vhx::BIG;
        if (dd != dd) dd = vhx::BIG;
        dist[c] = dd;
    }
    float m = fminf(fminf(dist[0], dist[1]), dist[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        new_p[c] = __fmaf_rn(d[c], m, p[c]);
        step[c] = dist[c] == m ? sg[c] : 0.f;
    }
}

}  // namespace

extern "C" __global__ void probe_choose_move(const March* in, int* move) {
    const int i = threadIdx.x;
    move[i] = vhx::choose_move(in[i]);
}

extern "C" __global__ void probe_reach_mask(const int* t, const int* octant, uint2* out) {
    const int i = threadIdx.x;
    uint32_t lo, hi;
    vhx::reach_mask(t[i], octant[i], lo, hi);
    out[i] = make_uint2(lo, hi);
}

extern "C" __global__ void probe_descend(const March* in, March* out) {
    const int i = threadIdx.x;
    March m = in[i];
    vhx::descend(m);
    out[i] = m;
}

extern "C" __global__ void probe_move_dda(const March* in, const int* move, float* out) {
    const int i = threadIdx.x;
    float np[3], st[3];
    vhx::move_dda(in[i], move[i], np, st);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        out[6 * i + c] = np[c];
        out[6 * i + 3 + c] = st[c];
    }
}

extern "C" __global__ void probe_dda_before(const March* in, float* out) {
    const int i = threadIdx.x;
    const March& m = in[i];
    float np[3], st[3];
    dda_before(m.d, m.sf, m.p, m.tmin, m.tsize, np, st);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        out[6 * i + c] = np[c];
        out[6 * i + 3 + c] = st[c];
    }
}

extern "C" __global__ void probe_advance_tail(const March* in, const float* ds, March* out) {
    const int i = threadIdx.x;
    March m = in[i];
    vhx::advance_tail(m, ds + 6 * i, ds + 6 * i + 3);
    out[i] = m;
}

extern "C" __global__ void probe_ascend_tail(const March* in, const float* ds, March* out) {
    const int i = threadIdx.x;
    March m = in[i];
    vhx::ascend_tail(m, ds + 6 * i, ds + 6 * i + 3);
    out[i] = m;
}

extern "C" __global__ void probe_lateral_tail(const March* in, const float* ds, float size,
                                              March* out) {
    const int i = threadIdx.x;
    March m = in[i];
    m.active = vhx::lateral_tail(m, ds + 6 * i, ds + 6 * i + 3, size);
    out[i] = m;
}

extern "C" __global__ void probe_restart(const March* in, int n_levels, int size, March* out) {
    const int i = threadIdx.x;
    March m = in[i];
    const vhx::Grid g{nullptr, nullptr, n_levels, size, 0};
    m.active = vhx::restart(m, g);
    out[i] = m;
}

extern "C" __global__ void probe_fetch(const March* in, const uint2* occ, const int2* levels,
                                       int n_blocks, March* out) {
    const int i = threadIdx.x;
    March m = in[i];
    vhx::fetch(occ, levels, n_blocks, m.level, m.bmin, m.lo, m.hi);
    out[i] = m;
}
