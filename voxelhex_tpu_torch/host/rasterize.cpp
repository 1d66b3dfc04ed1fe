// Host kernels of the port's scene model, built with g++ into a plain-C
// shared library and bound with ctypes (voxelhex_tpu_torch/native.py).
//
// Flat arrays are x fastest: idx = x + y*S + z*S^2.
//
//  * bulk_group_sort / bulk_group_fill: group point voxels into bricks for
//    tree/build.py's from_voxels (sort by brick, last duplicate wins, fill
//    the brick pool, 4x4x4 occupancy and solid flags per brick).
//  * rasterize_flat: walk a FlatTree (tree/flat.py's descriptors: -1 empty,
//    bit 30 solid, else a brick pool index; an internal node's children are
//    node keys) and paint the dense occupancy and color grids, stretching a
//    brick over a larger cell or taking the low corner of a smaller one;
//    a node key or brick index out of range fails the call.
//  * pack_level: fold a dense cell grid into the 64-bit occupancy words of
//    its 4x4x4 blocks (bit s = cx + 4*cy + 16*cz) and the next grid up.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr int32_t EMPTY_DESC = -1;
constexpr int32_t SOLID_FLAG = 1 << 30;
constexpr uint16_t COLOR_NONE = 0xFFFE;

// rasterize_flat's results (voxelhex_tpu_torch/native.py names them)
constexpr int32_t RASTER_OK = 0;
constexpr int32_t RASTER_BAD_NODE = 1;   // a node key out of range
constexpr int32_t RASTER_BAD_BRICK = 2;  // a brick descriptor out of range
constexpr int32_t RASTER_TOO_DEEP = 3;   // a node below the voxel level

struct Frame {
    int32_t key;
    int32_t x, y, z;
    int32_t size;
};

inline uint16_t color_of(int32_t v) { return v >= COLOR_NONE ? COLOR_NONE : (uint16_t)v; }

// Paint one brick descriptor spanning `extent` voxels at (x0, y0, z0).
int32_t paint_desc(const int32_t* bricks, int d, int32_t n_bricks, int32_t desc, int x0,
                   int y0, int z0, int extent, int S, uint8_t* occ, uint16_t* colors) {
    if (desc == EMPTY_DESC) return RASTER_OK;
    const int64_t S2 = (int64_t)S * S;
    if (desc & SOLID_FLAG) {
        const uint16_t c = color_of(desc & (SOLID_FLAG - 1));
        for (int z = z0; z < z0 + extent; ++z)
            for (int y = y0; y < y0 + extent; ++y) {
                const int64_t base = (int64_t)x0 + (int64_t)y * S + (int64_t)z * S2;
                for (int x = 0; x < extent; ++x) {
                    occ[base + x] = 1;
                    colors[base + x] = c;
                }
            }
        return RASTER_OK;
    }
    if (desc < 0 || desc >= n_bricks) return RASTER_BAD_BRICK;
    const int32_t* brick = bricks + (int64_t)desc * d * d * d;
    // a cell at least a brick wide stretches each voxel f times; a smaller
    // one takes the brick's low corner
    const int f = extent >= d ? extent / d : 1;
    const int n = extent >= d ? d : extent;
    for (int bz = 0; bz < n; ++bz)
        for (int by = 0; by < n; ++by)
            for (int bx = 0; bx < n; ++bx) {
                const int32_t v = brick[bx + by * d + bz * d * d];
                if (v == EMPTY_DESC) continue;
                const uint16_t c = color_of(v);
                for (int dz = 0; dz < f; ++dz)
                    for (int dy = 0; dy < f; ++dy) {
                        const int64_t base = (int64_t)(x0 + bx * f) +
                                             (int64_t)(y0 + by * f + dy) * S +
                                             (int64_t)(z0 + bz * f + dz) * S2;
                        for (int dx = 0; dx < f; ++dx) {
                            occ[base + dx] = 1;
                            colors[base + dx] = c;
                        }
                    }
            }
    return RASTER_OK;
}

}  // namespace

extern "C" {

// Paint a FlatTree into dense occ (u8) and colors (u16) grids of S^3
// entries; the caller fills occ with 0 and colors with 0xFFFF.  Returns
// RASTER_OK, or the first fault met, with the grids partly painted.
int32_t rasterize_flat(const uint32_t* node_meta, const int32_t* node_children,
                       const int32_t* bricks, int32_t n_nodes, int32_t n_bricks,
                       int32_t brick_dim, int32_t S, uint8_t* occ, uint16_t* colors) {
    std::vector<Frame> stack;
    stack.push_back({0, 0, 0, 0, S});
    while (!stack.empty()) {
        const Frame f = stack.back();
        stack.pop_back();
        if (f.key >= n_nodes) return RASTER_BAD_NODE;
        if (f.size < 1) return RASTER_TOO_DEEP;
        const uint32_t meta = node_meta[f.key];
        const int cell = f.size / 4;
        const int32_t* row = node_children + (int64_t)f.key * 64;
        if (meta & 2) {  // uniform: one brick over the whole node
            const int32_t r = paint_desc(bricks, brick_dim, n_bricks, row[0], f.x, f.y, f.z,
                                         f.size, S, occ, colors);
            if (r != RASTER_OK) return r;
            continue;
        }
        for (int s = 0; s < 64; ++s) {
            const int x = f.x + (s % 4) * cell, y = f.y + ((s / 4) % 4) * cell,
                      z = f.z + (s / 16) * cell;
            if (meta & 1) {  // leaf: 64 bricks
                const int32_t r =
                    paint_desc(bricks, brick_dim, n_bricks, row[s], x, y, z, cell, S, occ, colors);
                if (r != RASTER_OK) return r;
            } else if (row[s] >= 0) {  // internal
                stack.push_back({row[s], x, y, z, cell});
            }
        }
    }
    return RASTER_OK;
}

// Fold a dense c^3 cell grid (u8; c a multiple of 4) into the (lo, hi)
// occupancy words of its (c/4)^3 blocks and the coarser grid (u8, 1 where a
// block holds any cell), block index bx + by*n + bz*n^2.
void pack_level(const uint8_t* grid, int32_t c, uint32_t* lo, uint32_t* hi, uint8_t* coarse) {
    const int n = c / 4;
    const int64_t c2 = (int64_t)c * c;
    for (int bz = 0; bz < n; ++bz)
        for (int by = 0; by < n; ++by)
            for (int bx = 0; bx < n; ++bx) {
                uint64_t w = 0;
                for (int z = 0; z < 4; ++z)
                    for (int y = 0; y < 4; ++y) {
                        const uint8_t* cells =
                            grid + (int64_t)(bx * 4) + (int64_t)(by * 4 + y) * c +
                            (int64_t)(bz * 4 + z) * c2;
                        for (int x = 0; x < 4; ++x)
                            if (cells[x]) w |= 1ull << (x + y * 4 + z * 16);
                    }
                const int64_t b = (int64_t)bx + (int64_t)by * n + (int64_t)bz * n * n;
                lo[b] = (uint32_t)(w & 0xFFFFFFFFu);
                hi[b] = (uint32_t)(w >> 32);
                coarse[b] = w != 0;
            }
}

// Step 1 of grouping n point voxels (int64 [n, 3]) into bricks of edge d in
// a world of edge `size`: each voxel's key, cell * d^3 + its index in the
// brick, sorted (ties keep the input order); `order` the input index of
// each sorted key; m_out[0] the number of distinct bricks.
void bulk_group_sort(const int64_t* pos, int64_t n, int32_t size, int32_t d, int64_t* keys,
                     int64_t* order, int64_t* m_out) {
    const int64_t cpa = size / d;
    const int64_t d3 = (int64_t)d * d * d;
    std::vector<std::pair<int64_t, int64_t>> kv(n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t x = pos[i * 3], y = pos[i * 3 + 1], z = pos[i * 3 + 2];
        const int64_t cell = (x / d) + (y / d) * cpa + (z / d) * cpa * cpa;
        kv[i] = {cell * d3 + (x % d) + (y % d) * d + (z % d) * d * d, i};
    }
    std::sort(kv.begin(), kv.end());
    int64_t m = 0, prev_cell = -1;
    for (int64_t i = 0; i < n; ++i) {
        keys[i] = kv[i].first;
        order[i] = kv[i].second;
        const int64_t cell = kv[i].first / d3;
        if (cell != prev_cell) {
            ++m;
            prev_cell = cell;
        }
    }
    m_out[0] = m;
}

// Step 2: one pass over the sorted keys.  For each of the M bricks, its
// cell id, its voxels (the last of equal keys wins; `bricks` [M, d^3] is
// filled with empty_voxel by the caller), its 4x4x4-downsampled occupancy
// and whether it is solid (all d^3 voxels present and equal).
void bulk_group_fill(const uint32_t* packed, const int64_t* keys_sorted, const int64_t* order,
                     int64_t n, int32_t d, uint32_t empty_voxel, int64_t* uniq_cells,
                     uint32_t* bricks, uint64_t* occ, uint8_t* solid) {
    const int64_t d3 = (int64_t)d * d * d;
    int64_t m = -1, prev_cell = -1, count = 0;
    uint32_t first_val = 0;
    bool all_equal = true;
    for (int64_t i = 0; i < n; ++i) {
        if (i + 1 < n && keys_sorted[i + 1] == keys_sorted[i]) continue;
        const int64_t cell = keys_sorted[i] / d3;
        const int64_t flat = keys_sorted[i] % d3;
        const uint32_t v = packed[order[i]];
        if (cell != prev_cell) {
            if (m >= 0) solid[m] = all_equal && count == d3;
            ++m;
            uniq_cells[m] = cell;
            occ[m] = 0;
            first_val = v;
            all_equal = true;
            count = 0;
            prev_cell = cell;
        }
        if (v == empty_voxel) continue;
        bricks[m * d3 + flat] = v;
        ++count;
        if (v != first_val) all_equal = false;
        const int wx = (int)(flat % d), wy = (int)((flat / d) % d), wz = (int)(flat / (d * d));
        if (d >= 4) {
            const int f = d / 4;
            occ[m] |= 1ull << ((wx / f) + (wy / f) * 4 + (wz / f) * 16);
        } else if (d == 2) {
            for (int dz = 0; dz < 2; ++dz)
                for (int dy = 0; dy < 2; ++dy)
                    for (int dx = 0; dx < 2; ++dx)
                        occ[m] |= 1ull << ((wx * 2 + dx) + (wy * 2 + dy) * 4 + (wz * 2 + dz) * 16);
        } else {
            occ[m] = ~0ull;
        }
    }
    if (m >= 0) solid[m] = all_equal && count == d3;
}

}  // extern "C"
