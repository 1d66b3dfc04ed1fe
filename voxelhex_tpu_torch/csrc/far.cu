// A streaming view's frame with its far field in one launch: the window,
// then each LOD ring behind it, folded by hit distance.
//
// Replaces the reference's `_render_far` (voxelhex_tpu/render/streaming.py:
// 1479): the window's `trace_compacted`, then one `trace_compacted` a ring
// with `start_t` from `_far_kill_hits` (:144), the ring's world distance
// (`_hit_dist`, :183) and the nearest-hit composite (`_far_accum`, :160),
// all XLA programs, on the path of the two ported TPU kernels (the
// traversal of voxelhex_tpu/ops/traverse_pallas.py and the shading of
// ops/shade_pallas.py).  Each thread takes one pixel through every layer
// in turn (the window, then rings 0 .. n - 1, each a BitGrid with its own
// camera params, level table and palette, passed by value):
//   prologue  the pixel's ray in the layer's frame (frame.cuh pixel_ray);
//   body      the automaton (traverse.cuh): the window's march as frame.cu
//             runs it; a ring's from start_t = 0 when the camera is inside
//             the window, as the reference's, and from its entry otherwise;
//   epilogue  shading (frame.cuh shade_hit), the distance |point - o| * F
//             in world voxels (the squares summed in order, unfused, as
//             XLA:CPU sums the reference's norm), and the fold: the ring's
//             hit replaces what the pixel holds if nothing was hit yet or
//             it is nearer.
// With the camera inside the window the reference starts a ray that hit
// already at 1e9, which makes it inactive from init on (a ring contains the
// window, so the ray's exit from a ring's box is nearer than 1e9 cells):
// here that ray skips the ring.  After the last layer, the u8 step
// (frame.cuh to_u8) or the f32 color.
//
// What bounds it on the H100: the automaton's instructions, as in frame.cu
// (the layers' pyramids are L2-resident: 2.1 MB at a 256 window, as much
// again for a 256-cell ring).  A pixel marches once a layer it reaches;
// the 4 x 8 warp tile (frame.cuh) keeps a warp's lanes on neighbouring rays,
// which end in the same layer more often than not.

#include "frame.cuh"

#define VHX_FAR_MAX_LAYERS 8

// One layer: a BitGrid and the camera in its frame
struct FarLayer {
    TraceParams trace;
    const uint2* occ;
    const unsigned short* colors;
    const float4* palette;
    int n_colors;
    float factor;  // world voxels a cell of the layer
    float origin[3];
    float right[3];
    float up[3];
    float forward[3];
    float scale[2];  // (tan(fov_y / 2) * w / h, tan(fov_y / 2))
};

struct FarParams {
    float cw, ch;  // 1 / w * 2 and 1 / h * 2, folded as the plain raygen folds them
    float bg[3];   // background color of a miss
    int w, h;
    int inside;    // the camera is inside the window
    int n_layers;  // 1 .. VHX_FAR_MAX_LAYERS: the window, then the rings
    FarLayer layers[VHX_FAR_MAX_LAYERS];
};

namespace {

constexpr int THREADS = vhx::FRAME_THREADS;
constexpr int WARP_H = vhx::WARP_H;
constexpr int BLOCK_W = vhx::BLOCK_W;

// |point - o| as XLA:CPU computes the reference's jnp.linalg.norm of a
// 3-vector there: the squares summed in order, unfused
__device__ __forceinline__ float ray_length(const float p[3], const float o[3]) {
    const float x = __fsub_rn(p[0], o[0]), y = __fsub_rn(p[1], o[1]), z = __fsub_rn(p[2], o[2]);
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

__global__ void __launch_bounds__(THREADS)
far_kernel(const __grid_constant__ FarParams P, float* __restrict__ rgb_out,
           unsigned char* __restrict__ u8_out) {
    __shared__ int2 levels[VHX_FAR_MAX_LAYERS * VHX_MAX_LEVELS];
    if (threadIdx.x == 0) {
        for (int l = 0; l < P.n_layers; ++l)
            for (int i = 0; i < VHX_MAX_LEVELS; ++i)
                levels[l * VHX_MAX_LEVELS + i] =
                    make_int2(P.layers[l].trace.bases[i], P.layers[l].trace.dims[i]);
    }
    __syncthreads();
    int x, y;
    vhx::tile_pixel(x, y);
    if (x >= P.w || y >= P.h) return;

    bool hit = false;
    float dist = INFINITY, rgb[3] = {P.bg[0], P.bg[1], P.bg[2]};
    for (int l = 0; l < P.n_layers; ++l) {
        const FarLayer& L = P.layers[l];
        const bool ring = l > 0;
        if (ring && P.inside && hit) continue;  // the reference's start_t = 1e9
        float o[3], d[3];
        vhx::pixel_ray(L.origin, L.right, L.up, L.forward, L.scale, P.cw, P.ch, x, y, o, d);
        const int2* lv = levels + l * VHX_MAX_LEVELS;
        const vhx::Hit h =
            ring && P.inside
                ? vhx::march<true>(o, d, L.occ, L.colors, lv, L.trace.n_levels, L.trace.size,
                                   L.trace.n_blocks, L.trace.max_iters, 0.f)
                : vhx::march(o, d, L.occ, L.colors, lv, L.trace.n_levels, L.trace.size,
                             L.trace.n_blocks, L.trace.max_iters);
        if (!h.hit) continue;
        const float hd = __fmul_rn(ray_length(h.point, o), L.factor);
        if (hit && !(hd < dist)) continue;
        vhx::shade_hit(h, L.palette, L.n_colors, P.bg, rgb);
        hit = true;
        dist = hd;
    }
    const long long r = (long long)y * P.w + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (rgb_out) rgb_out[3 * r + k] = rgb[k];
        if (u8_out) u8_out[3 * r + k] = vhx::to_u8(rgb[k]);
    }
}

}  // namespace

extern "C" int vhx_far_params_size() { return (int)sizeof(FarParams); }
extern "C" int vhx_far_max_layers() { return VHX_FAR_MAX_LAYERS; }

extern "C" cudaError_t vhx_render_far(const FarParams* params, float* rgb, void* u8, int device,
                                      cudaStream_t stream) {
    const FarParams& P = *params;
    if (P.n_layers < 1 || P.n_layers > VHX_FAR_MAX_LAYERS || P.w < 1 || P.h < 1)
        return cudaErrorInvalidValue;
    for (int l = 0; l < P.n_layers; ++l)
        if (P.layers[l].trace.n_levels < 1 || P.layers[l].trace.n_levels > VHX_MAX_LEVELS ||
            P.layers[l].n_colors < 1)
            return cudaErrorInvalidValue;
    const dim3 grid((P.w + BLOCK_W - 1) / BLOCK_W, (P.h + WARP_H - 1) / WARP_H);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    far_kernel<<<grid, THREADS, 0, stream>>>(P, rgb, static_cast<unsigned char*>(u8));
    return cudaGetLastError();
}
