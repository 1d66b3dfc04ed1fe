// The beam prepass: one conservative ray a pixel tile, marched over a
// dilated coarse occupancy grid, whose hit distance every ray of the tile
// may start from.
//
// Replaces the reference's beam prepass (`_beam_body`,
// voxelhex_tpu/render/bitgrid.py:1491, with `_beam_spec` :1528 and
// `beam_start` :1561), an XLA program with no Pallas source that runs the
// production tracer (the ported `make_kernel` / `traverse_tiles` of
// voxelhex_tpu/ops/traverse_pallas.py) over the beam grid.  Each thread is
// one tile's beam (frame k, tile row ty, tile column tx), each warp a 4 x 8
// patch of a frame's tiles (frame.cuh tile_pixel over the beam grid):
//   prologue  the tile's ray: frame.cuh pixel_ray at the beam resolution
//             (w / tile, h / tile), the plain raygen of the camera at that
//             resolution, as the reference's `device_rays(cam_b)`; its
//             origin in beam-grid coordinates, o / cell + 1 (a 1-cell
//             ring), where 1 / cell is exact;
//   body      the automaton (traverse.cuh) over the level-L dilated grid
//             with the reference's `make_bitgrid_tracer` defaults for it:
//             2 DDA substeps an ADVANCE, 128 steps, 4 restarts;
//   epilogue  the start: on a hit max(|p - o_b| * cell - 1.5 cell, 0), the
//             norm's squares summed in order by fused multiply-adds, as
//             XLA:CPU compiles the reference's (so is the entry point on z
//             alone, init's kEntryFma); 0 for a beam still active after its steps
//             or past its restarts (it proved nothing); 1e8 for a clean
//             miss (the tile is dead: its rays start past the world).
// The frame kernels read the start map through traverse.cuh init's start
// form, one value a tile (frame.cu, frames.cu, far.cu).
//
// A batch launches once: each camera has its own level L, and so its own
// grid, picked by `grid_of` (the reference takes cameras[0]'s level for the
// whole batch, which breaks the bound `_beam_level` enforces for a camera
// farther from the world's corners).  A camera with no level (grid -1)
// writes 0s that the frame kernel does not read: its frame marches from its
// entry, with no start.
//
// What bounds it: not bytes or operations (0.3 us of them at 1080p) but its
// launch and the chains of dependent steps of its longest beams: at the
// bench pose 32,400 beams take 5.9 steps on average and at most 30, and a
// warp steps as long as its longest lane, executing every move one of its
// lanes takes.  The grid's word pairs are few (5,047 at 66^3 cells) and stay
// in each SM's L1, so a fetch is not what a step waits on: staging the
// grid in shared memory ran slower (PERF.md).  A warp covers a 4 x 8 patch
// of beams, as the frame kernels' warps cover pixels: neighbouring beams
// take similar steps and moves, where a row of 32 mixes dead tiles with
// live ones.

#include "frame.cuh"

#define VHX_KMAX 32
#define VHX_BEAM_MAX_GRIDS 8
#define VHX_BEAM_SUBSTEPS 2

// One dilated grid: its pyramid and level table, its cell edge in world
// voxels (4^L) and that edge's reciprocal
struct BeamGrid {
    TraceParams trace;
    const uint2* occ;
    float cell;
    float inv_cell;
};

struct BeamParams {
    float cw, ch;  // 1 / tw * 2 and 1 / th * 2, folded as the plain raygen folds them
    int tw, th;    // beams a row, rows
    int n_frames;  // 1 .. VHX_KMAX
    int n_grids;   // 0 .. VHX_BEAM_MAX_GRIDS
    int grid_of[VHX_KMAX];  // each frame's grid, -1 for none
    BeamGrid grids[VHX_BEAM_MAX_GRIDS];
    FrameCam cams[VHX_KMAX];
};

namespace {

constexpr int THREADS = vhx::FRAME_THREADS;
constexpr float DEAD = 1e8f;  // a clean miss: past every ray's exit

// The entry point's multiply-add, fused on z alone (traverse.cuh init), as
// XLA:CPU compiles the reference's beam program
constexpr int ENTRY_FMA = 4;

// |p - o| as XLA:CPU computes the reference's jnp.linalg.norm of a
// 3-vector in the beam program: the squares summed in order, each added by
// a fused multiply-add (frame.cuh ray_length is the unfused form)
__device__ __forceinline__ float fused_length(const float p[3], const float o[3]) {
    const float x = __fsub_rn(p[0], o[0]), y = __fsub_rn(p[1], o[1]), z = __fsub_rn(p[2], o[2]);
    return __fsqrt_rn(__fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
}

__global__ void __launch_bounds__(THREADS)
beam_kernel(const __grid_constant__ BeamParams P, float* __restrict__ out) {
    // every grid's level table in shared memory, copied by one thread with
    // constant indices (traverse.cuh load_levels)
    __shared__ int2 levels[VHX_BEAM_MAX_GRIDS * VHX_MAX_LEVELS];
    if (threadIdx.x == 0) {
        for (int g = 0; g < P.n_grids; ++g) {
#pragma unroll
            for (int l = 0; l < VHX_MAX_LEVELS; ++l)
                levels[g * VHX_MAX_LEVELS + l] =
                    make_int2(P.grids[g].trace.bases[l], P.grids[g].trace.dims[l]);
        }
    }
    __syncthreads();
    int tx, ty;
    vhx::tile_pixel(tx, ty);
    if (tx >= P.tw || ty >= P.th) return;
    const int k = blockIdx.z;
    const long long i = ((long long)k * P.th + ty) * P.tw + tx;
    const int gi = P.grid_of[k];
    if (gi < 0) {
        out[i] = 0.f;
        return;
    }
    const BeamGrid& G = P.grids[gi];
    const FrameCam& cam = P.cams[k];
    float o[3], d[3], ob[3];
    vhx::pixel_ray(cam.origin, cam.right, cam.up, cam.forward, cam.scale, P.cw, P.ch, tx, ty, o,
                   d);
#pragma unroll
    for (int c = 0; c < 3; ++c) ob[c] = __fadd_rn(__fmul_rn(o[c], G.inv_cell), 1.f);
    const vhx::Grid g{G.occ, levels + gi * VHX_MAX_LEVELS, G.trace.n_levels, G.trace.size,
                      G.trace.n_blocks};
    vhx::March m;
    vhx::init<false, ENTRY_FMA>(m, ob, d, g);
    vhx::StopAtHit stop;
    vhx::run<vhx::StopAtHit, VHX_BEAM_SUBSTEPS>(m, g, G.trace.max_iters, stop);
    float s;
    if (m.hit) {
        const float dist = __fmul_rn(fused_length(m.p, ob), G.cell);
        s = vhx::xla_max(__fsub_rn(dist, __fmul_rn(G.cell, 1.5f)), 0.f);
    } else {
        s = (m.active || m.restarts > vhx::MAX_RESTARTS) ? 0.f : DEAD;
    }
    out[i] = s;
}

}  // namespace

extern "C" int vhx_beam_params_size() { return (int)sizeof(BeamParams); }
extern "C" int vhx_beam_max_grids() { return VHX_BEAM_MAX_GRIDS; }

// Write each frame's beam starts, f32 [n_frames, th, tw], into `out`.
extern "C" cudaError_t vhx_beam(const BeamParams* params, float* out, int device,
                                cudaStream_t stream) {
    const BeamParams& P = *params;
    if (P.n_frames < 1 || P.n_frames > VHX_KMAX || P.n_grids < 0 ||
        P.n_grids > VHX_BEAM_MAX_GRIDS || P.tw < 1 || P.th < 1 || !out)
        return cudaErrorInvalidValue;
    for (int k = 0; k < P.n_frames; ++k)
        if (P.grid_of[k] >= P.n_grids) return cudaErrorInvalidValue;
    for (int g = 0; g < P.n_grids; ++g)
        if (P.grids[g].trace.n_levels < 1 || P.grids[g].trace.n_levels > VHX_MAX_LEVELS)
            return cudaErrorInvalidValue;
    const dim3 grid((P.tw + vhx::BLOCK_W - 1) / vhx::BLOCK_W,
                    (P.th + vhx::WARP_H - 1) / vhx::WARP_H, P.n_frames);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    beam_kernel<<<grid, THREADS, 0, stream>>>(P, out);
    return cudaGetLastError();
}
