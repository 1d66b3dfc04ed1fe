// The port's single-voxel / LOD edit engine for the sparse voxel-brick
// 64-tree, built with g++ into a plain-C shared library and bound with
// ctypes (voxelhex_tpu_torch/native.py, voxelhex_tpu_torch/tree/native_edit.py).
//
// Mirrors the semantics of voxelhex_tpu_torch/tree/boxtree.py at native edit
// latency for single-voxel insert/clear/get workloads.  Palettes stay on the
// Python side; this engine works in packed u32 palette-index values and
// receives per-index emptiness tables.
//
// Handle-based C API at the bottom.  Differential tests against the Python
// tree: tests/test_torch_native_edit.py.

#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <memory>
#include <algorithm>

namespace {

constexpr int DIM = 4;           // BOX_NODE_DIMENSION
constexpr int NCHILD = 64;       // BOX_NODE_CHILDREN_COUNT
constexpr uint32_t EMPTY_VOXEL = 0xFFFFFFFFu;
constexpr uint16_t EMPTY_U16 = 0xFFFFu;
constexpr int32_t EMPTY_KEY = -1;
constexpr uint64_t U64MAX = ~0ull;

enum NType : uint8_t { NOTHING = 0, INTERNAL = 1, LEAF = 2, UNIFORM = 3 };
enum BKind : uint8_t { B_NONE = 0, B_SOLID = 1, B_PARTED = 2 };

// sides (occlusion bit indices), matching boxtree.py SIDE_*
constexpr int SIDE_BACK = 0, SIDE_FRONT = 1, SIDE_TOP = 2, SIDE_BOTTOM = 3,
              SIDE_LEFT = 4, SIDE_RIGHT = 5;

struct Brick {
    uint8_t kind = B_NONE;
    uint32_t solid = 0;
    std::vector<uint32_t> v;  // d^3, x-fastest, when kind == B_PARTED
};

struct Node {
    uint8_t type = NOTHING;
    uint8_t occlusion = 0;
    uint64_t occupied = 0;
    std::unique_ptr<std::array<int32_t, NCHILD>> children;  // INTERNAL
    std::vector<Brick> bricks;  // 64 for LEAF, 1 for UNIFORM, else empty

    int32_t child(int sectant) const {
        return children ? (*children)[sectant] : EMPTY_KEY;
    }
    void set_child(int sectant, int32_t key) {
        if (!children) {
            children = std::make_unique<std::array<int32_t, NCHILD>>();
            children->fill(EMPTY_KEY);
        }
        (*children)[sectant] = key;
    }
};

struct Cell {
    int64_t pos[3];
    int64_t size[3];
    int sectant;
    double cmin[3];
    double csize;
};

struct Tree {
    int64_t size = 0;
    int brick_dim = 0;
    bool auto_simplify = true;
    std::vector<std::unique_ptr<Node>> nodes;
    std::vector<int32_t> free_list;
    // palette emptiness tables (index -> is-empty), synced from Python
    std::vector<uint8_t> color_empty;
    std::vector<uint8_t> data_empty;
    // last-op outputs for update triggers
    std::vector<int32_t> last_stack;
    std::vector<int32_t> last_sectants;

    Node& node(int32_t key) { return *nodes[key]; }
    bool key_is_valid(int32_t key) const {
        return key >= 0 && key < (int32_t)nodes.size() && nodes[key] != nullptr;
    }
    int32_t push_node() {
        if (!free_list.empty()) {
            int32_t key = free_list.back();
            free_list.pop_back();
            nodes[key] = std::make_unique<Node>();
            return key;
        }
        nodes.push_back(std::make_unique<Node>());
        return (int32_t)nodes.size() - 1;
    }
    void free_node(int32_t key) {
        if (key_is_valid(key)) {
            nodes[key].reset();
            free_list.push_back(key);
        }
    }
};

// ---------------------------------------------------------------- pix helpers

inline uint16_t pix_color_index(uint32_t packed) { return packed & 0xFFFFu; }
inline uint16_t pix_data_index(uint32_t packed) { return packed >> 16; }
inline bool pix_color_is_some(uint32_t p) { return pix_color_index(p) != EMPTY_U16; }
inline bool pix_data_is_some(uint32_t p) { return pix_data_index(p) != EMPTY_U16; }

inline bool pix_points_to_empty(const Tree& t, uint32_t packed) {
    uint16_t ci = pix_color_index(packed), di = pix_data_index(packed);
    bool ce = ci == EMPTY_U16 ||
              (ci < t.color_empty.size() ? t.color_empty[ci] != 0 : true);
    bool de = di == EMPTY_U16 ||
              (di < t.data_empty.size() ? t.data_empty[di] != 0 : true);
    return ce && de;
}

// --------------------------------------------------------------- brick helpers

inline Brick new_parted(int d, uint32_t fill) {
    Brick b;
    b.kind = B_PARTED;
    b.v.assign((size_t)d * d * d, fill);
    return b;
}

inline bool brick_homogeneous(const Brick& b, uint32_t* value) {
    if (b.kind == B_NONE) return false;  // Python returns None for None brick
    if (b.kind == B_SOLID) { *value = b.solid; return true; }
    uint32_t first = b.v[0];
    for (uint32_t x : b.v)
        if (x != first) return false;
    *value = first;
    return true;
}

inline bool brick_contains_nothing(const Tree& t, const Brick& b) {
    if (b.kind == B_NONE) return true;
    if (b.kind == B_SOLID) return pix_points_to_empty(t, b.solid);
    for (uint32_t x : b.v)
        if (!pix_points_to_empty(t, x)) return false;
    return true;
}

// collapse homogeneous parted bricks; returns changed
inline bool brick_simplify(const Tree& t, Brick& b) {
    uint32_t v;
    if (!brick_homogeneous(b, &v)) return false;
    if (b.kind != B_PARTED) return false;
    if (pix_points_to_empty(t, v)) {
        b = Brick{};  // -> None
        return true;
    }
    b.kind = B_SOLID;
    b.solid = v;
    b.v.clear();
    b.v.shrink_to_fit();
    return true;
}

// 64-bit occupancy of a brick (spatial/math.py brick_occupied_bits port)
inline uint64_t brick_occupied(const Tree& t, const Brick& b) {
    if (b.kind == B_NONE) return 0;
    if (b.kind == B_SOLID)
        return pix_points_to_empty(t, b.solid) ? 0 : U64MAX;
    const int d = t.brick_dim;
    uint64_t bits = 0;
    if (d == 1)
        return pix_points_to_empty(t, b.v[0]) ? 0 : U64MAX;
    if (d >= DIM) {
        const int f = d / DIM;
        for (int z = 0; z < DIM; ++z)
            for (int y = 0; y < DIM; ++y)
                for (int x = 0; x < DIM; ++x) {
                    bool any = false;
                    for (int zz = z * f; zz < (z + 1) * f && !any; ++zz)
                        for (int yy = y * f; yy < (y + 1) * f && !any; ++yy)
                            for (int xx = x * f; xx < (x + 1) * f && !any; ++xx)
                                any = !pix_points_to_empty(
                                    t, b.v[(size_t)xx + (size_t)yy * d +
                                           (size_t)zz * d * d]);
                    if (any) bits |= 1ull << (x + y * 4 + z * 16);
                }
    } else {  // d == 2: each voxel covers 2x2x2 bits
        const int r = DIM / d;
        for (int z = 0; z < DIM; ++z)
            for (int y = 0; y < DIM; ++y)
                for (int x = 0; x < DIM; ++x) {
                    size_t idx = (size_t)(x / r) + (size_t)(y / r) * d +
                                 (size_t)(z / r) * d * d;
                    if (!pix_points_to_empty(t, b.v[idx]))
                        bits |= 1ull << (x + y * 4 + z * 16);
                }
    }
    return bits;
}

inline void sectant_offset(int sectant, double out[3]) {
    out[0] = (sectant % 4) * 0.25;
    out[1] = ((sectant / 4) % 4) * 0.25;
    out[2] = (sectant / 16) * 0.25;
}

// map one brick onto 64 child bricks (boxtree.py dilute_brick port)
inline void dilute_brick(const Tree& t, const Brick& src,
                         std::vector<Brick>& out) {
    const int d = t.brick_dim;
    out.assign(NCHILD, Brick{});
    for (int sect = 0; sect < NCHILD; ++sect) {
        double off[3];
        sectant_offset(sect, off);
        Brick child;
        child.kind = B_PARTED;
        child.v.resize((size_t)d * d * d);
        std::vector<int> sx(d), sy(d), sz(d);
        for (int i = 0; i < d; ++i) {
            sx[i] = std::min<int>(
                d - 1, std::max<int>(0, (int)std::floor(off[0] * d + (double)i / DIM)));
            sy[i] = std::min<int>(
                d - 1, std::max<int>(0, (int)std::floor(off[1] * d + (double)i / DIM)));
            sz[i] = std::min<int>(
                d - 1, std::max<int>(0, (int)std::floor(off[2] * d + (double)i / DIM)));
        }
        for (int z = 0; z < d; ++z)
            for (int y = 0; y < d; ++y)
                for (int x = 0; x < d; ++x)
                    child.v[(size_t)x + (size_t)y * d + (size_t)z * d * d] =
                        src.v[(size_t)sx[x] + (size_t)sy[y] * d +
                              (size_t)sz[z] * d * d];
        out[sect] = std::move(child);
    }
}

// ---------------------------------------------------------------- visit cells

// boxtree.py _visit_cells port; fills cells and actual_update
inline void visit_cells(const double node_min[3], double node_size,
                        const int64_t pos[3], int64_t update_size,
                        std::vector<Cell>& cells, int64_t actual_update[3]) {
    cells.clear();
    const double mx = node_min[0], my = node_min[1], mz = node_min[2];
    const double ns = node_size;
    const double px = (double)pos[0], py = (double)pos[1], pz = (double)pos[2];
    actual_update[0] = actual_update[1] = actual_update[2] = 0;
    if (px > mx + ns || py > my + ns || pz > mz + ns) return;

    const double sx = std::max(px, mx), sy = std::max(py, my),
                 sz = std::max(pz, mz);
    const double u = (double)update_size;
    const double ux = px + u - sx, uy = py + u - sy, uz = pz + u - sz;
    const double cell_size = ns / DIM;
    const double csize = std::ceil(cell_size);
    actual_update[0] = (int64_t)ux;
    actual_update[1] = (int64_t)uy;
    actual_update[2] = (int64_t)uz;

    for (double x = sx; x <= sx + ux; x += cell_size)
        for (double y = sy; y <= sy + uy; y += cell_size)
            for (double z = sz; z <= sz + uz; z += cell_size) {
                if (!(mx <= x && x < mx + ns && my <= y && y < my + ns &&
                      mz <= z && z < mz + ns))
                    continue;
                int ix = std::min((int)((x - mx) * DIM / ns), 3);
                int iy = std::min((int)((y - my) * DIM / ns), 3);
                int iz = std::min((int)((z - mz) * DIM / ns), 3);
                double cx = std::floor(mx + ix * 0.25 * ns);
                double cy = std::floor(my + iy * 0.25 * ns);
                double cz = std::floor(mz + iz * 0.25 * ns);
                double pix = std::max(sx, cx), piy = std::max(sy, cy),
                       piz = std::max(sz, cz);
                double six = std::min(cx + csize - pix, sx + ux - pix);
                double siy = std::min(cy + csize - piy, sy + uy - piy);
                double siz = std::min(cz + csize - piz, sz + uz - piz);
                if (six > 0 && siy > 0 && siz > 0) {
                    Cell c;
                    c.pos[0] = (int64_t)pix; c.pos[1] = (int64_t)piy;
                    c.pos[2] = (int64_t)piz;
                    c.size[0] = (int64_t)six; c.size[1] = (int64_t)siy;
                    c.size[2] = (int64_t)siz;
                    c.sectant = ix + iy * 4 + iz * 16;
                    c.cmin[0] = cx; c.cmin[1] = cy; c.cmin[2] = cz;
                    c.csize = csize;
                    cells.push_back(c);
                }
            }
}

// ------------------------------------------------------------- node emptiness

bool node_empty_at(Tree& t, int32_t key, int sectant);

bool node_all_sectants_empty(Tree& t, int32_t key) {
    for (int s = 0; s < NCHILD; ++s)
        if (!node_empty_at(t, key, s)) return false;
    return true;
}

// boxtree.py node_empty_at port
bool node_empty_at(Tree& t, int32_t key, int sectant) {
    Node& n = t.node(key);
    if (n.type == NOTHING) return true;
    if (n.type == LEAF) {
        const Brick& b = n.bricks[sectant];
        if (b.kind == B_NONE) return true;
        if (b.kind == B_SOLID) return pix_points_to_empty(t, b.solid);
        uint32_t v;
        return brick_homogeneous(b, &v) && pix_points_to_empty(t, v);
    }
    if (n.type == UNIFORM) {
        const Brick& b = n.bricks[0];
        if (b.kind == B_NONE) return true;
        if (b.kind == B_SOLID) return pix_points_to_empty(t, b.solid);
        const int d = t.brick_dim;
        double off[3];
        sectant_offset(sectant, off);
        int x0 = (int)std::floor(off[0] * d), y0 = (int)std::floor(off[1] * d),
            z0 = (int)std::floor(off[2] * d);
        int span = std::max(1, d / DIM);
        for (int z = z0; z < z0 + span; ++z)
            for (int y = y0; y < y0 + span; ++y)
                for (int x = x0; x < x0 + span; ++x)
                    if (!pix_points_to_empty(
                            t, b.v[(size_t)x + (size_t)y * d + (size_t)z * d * d]))
                        return false;
        return true;
    }
    // INTERNAL
    int32_t child = n.child(sectant);
    if (!t.key_is_valid(child)) return true;
    return node_all_sectants_empty(t, child);
}

bool content_is_all(Tree& t, int32_t key, uint32_t packed) {
    Node& n = t.node(key);
    if (n.type == UNIFORM) {
        uint32_t v;
        return brick_homogeneous(n.bricks[0], &v) && v == packed;
    }
    if (n.type == LEAF) {
        for (const Brick& b : n.bricks) {
            uint32_t v;
            if (!brick_homogeneous(b, &v) || v != packed) return false;
        }
        return true;
    }
    return false;
}

bool content_is_empty(Tree& t, int32_t key) {
    Node& n = t.node(key);
    if (n.type == NOTHING) return true;
    if (n.type == LEAF) {
        for (const Brick& b : n.bricks)
            if (!brick_contains_nothing(t, b)) return false;
        return true;
    }
    if (n.type == UNIFORM) return brick_contains_nothing(t, n.bricks[0]);
    return false;
}

void deallocate_children_of(Tree& t, int32_t key) {
    Node& n = t.node(key);
    if (n.children) {
        for (int32_t child : *n.children)
            if (t.key_is_valid(child)) {
                deallocate_children_of(t, child);
                t.free_node(child);
            }
        n.children.reset();
    }
}

// best-effort brick from a child node when re-leafing a parent
Brick try_brick_from_node(Tree& t, int32_t key) {
    if (!t.key_is_valid(key)) return Brick{};
    Node& n = t.node(key);
    if (n.type == UNIFORM) return n.bricks[0];  // copy
    return Brick{};
}

// boxtree.py subdivide_leaf_to_nodes port
void subdivide_leaf_to_nodes(Tree& t, int32_t key, int target_sectant) {
    Node& n = t.node(key);
    auto children = std::make_unique<std::array<int32_t, NCHILD>>();
    children->fill(EMPTY_KEY);

    if (n.type == LEAF) {
        for (int sectant = 0; sectant < NCHILD; ++sectant) {
            Brick& b = n.bricks[sectant];
            if (!brick_contains_nothing(t, b) || sectant == target_sectant) {
                int32_t ck = t.push_node();
                Node& c = t.node(ck);
                if (b.kind != B_NONE) {
                    c.type = UNIFORM;
                    c.bricks.resize(1);
                    c.bricks[0] = std::move(b);
                    c.occupied = brick_occupied(t, c.bricks[0]);
                }
                (*children)[sectant] = ck;
            }
        }
    } else {  // UNIFORM
        Brick& b = n.bricks[0];
        if (b.kind == B_NONE) {
            (*children)[target_sectant] = t.push_node();
        } else if (b.kind == B_SOLID) {
            for (int sectant = 0; sectant < NCHILD; ++sectant) {
                int32_t ck = t.push_node();
                Node& c = t.node(ck);
                c.type = UNIFORM;
                c.bricks.resize(1);
                c.bricks[0].kind = B_SOLID;
                c.bricks[0].solid = b.solid;
                c.occupied = U64MAX;
                (*children)[sectant] = ck;
            }
        } else {
            std::vector<Brick> diluted;
            dilute_brick(t, b, diluted);
            for (int sectant = 0; sectant < NCHILD; ++sectant) {
                int32_t ck = t.push_node();
                Node& c = t.node(ck);
                c.type = UNIFORM;
                c.bricks.resize(1);
                c.bricks[0] = std::move(diluted[sectant]);
                c.occupied = brick_occupied(t, c.bricks[0]);
                (*children)[sectant] = ck;
            }
        }
    }
    Node& n2 = t.node(key);  // push_node may have reallocated the pool
    n2.type = INTERNAL;
    n2.bricks.clear();
    n2.children = std::move(children);
}

// ---------------------------------------------------------------- brick write

// boxtree.py _update_brick port (overwrite / merge semantics)
void update_brick(const Tree& t, bool overwrite_if_empty, Brick& brick,
                  const double brick_min[3], double brick_size,
                  const int64_t position[3], const int64_t size[3],
                  uint32_t packed) {
    const int d = t.brick_dim;
    int x0 = (int)std::floor(((double)position[0] - brick_min[0]) * d / brick_size);
    int y0 = (int)std::floor(((double)position[1] - brick_min[1]) * d / brick_size);
    int z0 = (int)std::floor(((double)position[2] - brick_min[2]) * d / brick_size);
    int x1 = std::min<int>(x0 + (int)size[0], d);
    int y1 = std::min<int>(y0 + (int)size[1], d);
    int z1 = std::min<int>(z0 + (int)size[2], d);
    for (int z = z0; z < z1; ++z)
        for (int y = y0; y < y1; ++y)
            for (int x = x0; x < x1; ++x) {
                uint32_t& cell =
                    brick.v[(size_t)x + (size_t)y * d + (size_t)z * d * d];
                if (overwrite_if_empty) {
                    cell = packed;
                } else {
                    if (pix_color_is_some(packed))
                        cell = (cell & 0xFFFF0000u) | (packed & 0x0000FFFFu);
                    if (pix_data_is_some(packed))
                        cell = (cell & 0x0000FFFFu) | (packed & 0xFFFF0000u);
                }
            }
}

// boxtree.py leaf_update port
bool leaf_update(Tree& t, bool overwrite_if_empty, int32_t key,
                 const double node_min[3], double node_size,
                 const double cell_min[3], double cell_size, int sectant,
                 const int64_t position[3], const int64_t size[3],
                 uint32_t packed) {
    Node& n = t.node(key);
    const int d = t.brick_dim;
    const bool target_empty = pix_points_to_empty(t, packed);

    if (n.type == LEAF) {
        Brick& b = n.bricks[sectant];
        if (b.kind == B_NONE) {
            b = new_parted(d, EMPTY_VOXEL);
            update_brick(t, overwrite_if_empty, b, cell_min, cell_size,
                         position, size, packed);
            return true;
        }
        if (b.kind == B_SOLID) {
            uint32_t voxel = b.solid;
            bool voxel_empty = pix_points_to_empty(t, voxel);
            if ((target_empty && !voxel_empty) ||
                (!target_empty && voxel != packed)) {
                Brick nb = new_parted(d, voxel);
                update_brick(t, overwrite_if_empty, nb, cell_min, cell_size,
                             position, size, packed);
                b = std::move(nb);
                return true;
            }
            return false;
        }
        update_brick(t, overwrite_if_empty, b, cell_min, cell_size, position,
                     size, packed);
        return true;
    }

    if (n.type == UNIFORM) {
        Brick& b = n.bricks[0];
        if (b.kind == B_NONE) {
            if (target_empty) return false;
            Brick nb = new_parted(d, EMPTY_VOXEL);
            update_brick(t, overwrite_if_empty, nb, cell_min, cell_size,
                         position, size, packed);
            n.bricks.assign(NCHILD, Brick{});
            n.bricks[sectant] = std::move(nb);
            n.type = LEAF;
            return true;
        }
        if (b.kind == B_SOLID) {
            uint32_t voxel = b.solid;
            bool voxel_empty = pix_points_to_empty(t, voxel);
            if (target_empty && voxel_empty) {
                n.type = NOTHING;
                n.bricks.clear();
                return false;
            }
            if ((!target_empty && voxel != packed) ||
                (target_empty && !voxel_empty)) {
                b = new_parted(d, voxel);
                return leaf_update(t, overwrite_if_empty, key, node_min,
                                   node_size, cell_min, cell_size, sectant,
                                   position, size, packed);
            }
            return false;
        }
        // parted uniform brick: index from the NODE bounds
        int mx = (int)std::floor(((double)position[0] - node_min[0]) * d / node_size);
        int my = (int)std::floor(((double)position[1] - node_min[1]) * d / node_size);
        int mz = (int)std::floor(((double)position[2] - node_min[2]) * d / node_size);
        uint32_t current =
            b.v[(size_t)mx + (size_t)my * d + (size_t)mz * d * d];
        if (d > 1 && ((target_empty && pix_points_to_empty(t, current)) ||
                      (!target_empty && current == packed)))
            return false;
        if (node_size <= d && d > 1) {
            update_brick(t, overwrite_if_empty, b, node_min, node_size,
                         position, size, packed);
            return true;
        }
        std::vector<Brick> diluted;
        dilute_brick(t, b, diluted);
        update_brick(t, overwrite_if_empty, diluted[sectant], cell_min,
                     cell_size, position, size, packed);
        n.bricks = std::move(diluted);
        n.type = LEAF;
        return true;
    }

    // INTERNAL / NOTHING: convert to leaf by absorbing child bricks
    std::vector<Brick> new_bricks(NCHILD);
    for (int s = 0; s < NCHILD; ++s)
        new_bricks[s] = try_brick_from_node(t, n.child(s));
    deallocate_children_of(t, key);
    Node& n2 = t.node(key);
    n2.type = LEAF;
    n2.children.reset();
    n2.bricks = std::move(new_bricks);
    return leaf_update(t, overwrite_if_empty, key, node_min, node_size,
                       cell_min, cell_size, sectant, position, size, packed);
}

// ------------------------------------------------------------------ simplify

// boxtree.py simplify port
bool simplify(Tree& t, int32_t key, bool recursive) {
    if (!t.key_is_valid(key)) return false;
    Node& n = t.node(key);
    if (n.type == NOTHING) return true;
    if (n.type == UNIFORM) {
        Brick& b = n.bricks[0];
        if (b.kind == B_NONE) return true;
        if (b.kind == B_SOLID) {
            if (pix_points_to_empty(t, b.solid)) {
                n.type = NOTHING;
                n.bricks.clear();
                n.children.reset();
                return true;
            }
            return false;
        }
        return brick_simplify(t, b);
    }
    if (n.type == LEAF) {
        bool simplified = false;
        bool uniform_solid = true, has_parted = false, all_same = true;
        uint32_t first_solid = 0;
        bool first_set = false;
        for (int i = 0; i < NCHILD; ++i) {
            simplified |= brick_simplify(t, n.bricks[i]);
            const Brick& b = n.bricks[i];
            if (b.kind == B_SOLID) {
                if (!first_set) { first_solid = b.solid; first_set = true; }
                else if (b.solid != first_solid) all_same = false;
            } else {
                uniform_solid = false;
                has_parted |= b.kind == B_PARTED;
            }
        }
        if (uniform_solid && first_set && all_same) {
            Brick solid;
            solid.kind = B_SOLID;
            solid.solid = first_solid;
            n.bricks.assign(1, solid);
            n.type = UNIFORM;
            return true;
        }
        const int d = t.brick_dim;
        if (d == 1) return simplified;
        if (d <= DIM && has_parted) return simplified;
        // try uniting 64 bricks into one brick at 1/4 resolution: possible
        // when every DIM^3 voxel block of the super-grid is constant
        const int sd = d * DIM;
        std::vector<uint32_t> full((size_t)sd * sd * sd);
        for (int sectant = 0; sectant < NCHILD; ++sectant) {
            const Brick& b = n.bricks[sectant];
            double off[3];
            sectant_offset(sectant, off);
            int ox = (int)(off[0] * sd), oy = (int)(off[1] * sd),
                oz = (int)(off[2] * sd);
            for (int z = 0; z < d; ++z)
                for (int y = 0; y < d; ++y)
                    for (int x = 0; x < d; ++x) {
                        uint32_t val =
                            b.kind == B_NONE ? EMPTY_VOXEL
                            : b.kind == B_SOLID
                                ? b.solid
                                : b.v[(size_t)x + (size_t)y * d + (size_t)z * d * d];
                        full[(size_t)(ox + x) + (size_t)(oy + y) * sd +
                             (size_t)(oz + z) * sd * sd] = val;
                    }
        }
        Brick unified;
        unified.kind = B_PARTED;
        unified.v.resize((size_t)d * d * d);
        for (int zb = 0; zb < d; ++zb)
            for (int yb = 0; yb < d; ++yb)
                for (int xb = 0; xb < d; ++xb) {
                    uint32_t v0 = full[(size_t)(xb * DIM) +
                                       (size_t)(yb * DIM) * sd +
                                       (size_t)(zb * DIM) * sd * sd];
                    for (int zi = 0; zi < DIM; ++zi)
                        for (int yi = 0; yi < DIM; ++yi)
                            for (int xi = 0; xi < DIM; ++xi)
                                if (full[(size_t)(xb * DIM + xi) +
                                         (size_t)(yb * DIM + yi) * sd +
                                         (size_t)(zb * DIM + zi) * sd * sd] != v0)
                                    return simplified;
                    unified.v[(size_t)xb + (size_t)yb * d + (size_t)zb * d * d] = v0;
                }
        n.bricks.assign(1, std::move(unified));
        n.type = UNIFORM;
        return true;
    }
    // INTERNAL: degenerate collapse only
    if (n.occupied == 0 || !n.children) {
        deallocate_children_of(t, key);
        Node& n2 = t.node(key);
        n2.type = NOTHING;
        n2.children.reset();
        return true;
    }
    if (recursive && n.children) {
        std::array<int32_t, NCHILD> kids = *n.children;
        for (int32_t child : kids)
            if (t.key_is_valid(child)) simplify(t, child, true);
    }
    return false;
}

// ------------------------------------------------------------- sibling lookup

// boxtree.py _sibling_at port
int32_t sibling_at(Tree& t, const double node_min[3], double node_size,
                   int dx, int dy, int dz) {
    const double ns = node_size;
    double tx = node_min[0] + ns / 2.0 + dx * ns;
    double ty = node_min[1] + ns / 2.0 + dy * ns;
    double tz = node_min[2] + ns / 2.0 + dz * ns;
    double bsize = (double)t.size;
    double bx = 0, by = 0, bz = 0;
    if (!(0.0 <= tx && tx < bsize && 0.0 <= ty && ty < bsize && 0.0 <= tz &&
          tz < bsize))
        return EMPTY_KEY;
    int32_t key = 0;  // ROOT
    while (bsize > ns) {
        Node& n = t.node(key);
        if (n.type != INTERNAL) return EMPTY_KEY;
        int ix = std::min((int)((tx - bx) * DIM / bsize), 3);
        int iy = std::min((int)((ty - by) * DIM / bsize), 3);
        int iz = std::min((int)((tz - bz) * DIM / bsize), 3);
        int32_t child = n.child(ix + iy * 4 + iz * 16);
        if (!t.key_is_valid(child)) return EMPTY_KEY;
        bsize /= DIM;
        bx += ix * bsize;
        by += iy * bsize;
        bz += iz * bsize;
        key = child;
    }
    return key;
}

void set_sibling_occlusions(Tree& t, const double node_min[3],
                            double node_size, bool occluded) {
    static const int dirs[6][4] = {
        {-1, 0, 0, SIDE_RIGHT}, {1, 0, 0, SIDE_LEFT},
        {0, -1, 0, SIDE_TOP},   {0, 1, 0, SIDE_BOTTOM},
        {0, 0, -1, SIDE_FRONT}, {0, 0, 1, SIDE_BACK},
    };
    for (const auto& dir : dirs) {
        int32_t sib = sibling_at(t, node_min, node_size, dir[0], dir[1], dir[2]);
        if (sib != EMPTY_KEY) {
            Node& n = t.node(sib);
            if (occluded)
                n.occlusion |= (uint8_t)(1 << dir[3]);
            else
                n.occlusion &= (uint8_t)~(1 << dir[3]);
        }
    }
}

// -------------------------------------------------------------- post-process

// visit only the sectants (allocation-light _visit_sectants analog)
template <typename F>
void visit_sectants(const double node_min[3], double node_size,
                    const int64_t pos[3], int64_t update_size, F&& f) {
    const double mx = node_min[0], my = node_min[1], mz = node_min[2];
    const double ns = node_size;
    const double px = (double)pos[0], py = (double)pos[1], pz = (double)pos[2];
    if (px > mx + ns || py > my + ns || pz > mz + ns) return;
    const double sx = std::max(px, mx), sy = std::max(py, my),
                 sz = std::max(pz, mz);
    const double u = (double)update_size;
    const double ux = px + u - sx, uy = py + u - sy, uz = pz + u - sz;
    const double cell_size = ns / DIM;
    const double csize = std::ceil(cell_size);
    for (double x = sx; x <= sx + ux; x += cell_size)
        for (double y = sy; y <= sy + uy; y += cell_size)
            for (double z = sz; z <= sz + uz; z += cell_size) {
                if (!(mx <= x && x < mx + ns && my <= y && y < my + ns &&
                      mz <= z && z < mz + ns))
                    continue;
                int ix = std::min((int)((x - mx) * DIM / ns), 3);
                int iy = std::min((int)((y - my) * DIM / ns), 3);
                int iz = std::min((int)((z - mz) * DIM / ns), 3);
                double cx = std::floor(mx + ix * 0.25 * ns);
                double cy = std::floor(my + iy * 0.25 * ns);
                double cz = std::floor(mz + iz * 0.25 * ns);
                if (std::min(cx + csize, sx + ux) > std::max(sx, cx) &&
                    std::min(cy + csize, sy + uy) > std::max(sy, cy) &&
                    std::min(cz + csize, sz + uz) > std::max(sz, cz))
                    f(ix + iy * 4 + iz * 16);
            }
}

void post_process_insert(Tree& t, int32_t key, const double node_min[3],
                         double node_size, const int64_t actual_update[3],
                         const int64_t pos[3], int64_t insert_size) {
    Node& n = t.node(key);
    if (n.type == NOTHING) {
        n.type = INTERNAL;
        n.occupied = 0;
    }
    uint64_t new_occupied = n.occupied;
    if (actual_update[0] == (int64_t)node_size &&
        actual_update[1] == (int64_t)node_size &&
        actual_update[2] == (int64_t)node_size) {
        new_occupied = U64MAX;
    } else {
        visit_sectants(node_min, node_size, pos, insert_size, [&](int sectant) {
            if (!node_empty_at(t, key, sectant))
                new_occupied |= 1ull << sectant;
        });
    }
    if (new_occupied == U64MAX)
        set_sibling_occlusions(t, node_min, node_size, true);
    t.node(key).occupied = new_occupied;
}

// returns true when the node became empty
bool post_process_clear(Tree& t, int32_t key, const double node_min[3],
                        double node_size, const int64_t actual_update[3],
                        const int64_t pos[3], int64_t clear_size,
                        const std::vector<int32_t>& removed_children) {
    if (!t.key_is_valid(key)) return true;

    for (int32_t sectant : removed_children) {
        Node& n = t.node(key);
        int32_t child_key = n.child(sectant);
        if (t.key_is_valid(child_key)) {
            if (t.node(child_key).occupied == U64MAX) {
                double off[3];
                sectant_offset(sectant, off);
                double cmin[3] = {node_min[0] + off[0] * node_size,
                                  node_min[1] + off[1] * node_size,
                                  node_min[2] + off[2] * node_size};
                set_sibling_occlusions(t, cmin, node_size / DIM, false);
            }
            t.free_node(child_key);
        }
        Node& n2 = t.node(key);
        if (n2.children) (*n2.children)[sectant] = EMPTY_KEY;
    }

    Node& n = t.node(key);
    uint64_t new_occupied = n.occupied;
    bool whole = actual_update[0] == (int64_t)node_size &&
                 actual_update[1] == (int64_t)node_size &&
                 actual_update[2] == (int64_t)node_size &&
                 (int64_t)node_min[0] == pos[0] &&
                 (int64_t)node_min[1] == pos[1] &&
                 (int64_t)node_min[2] == pos[2];
    if (whole) {
        new_occupied = 0;
    } else {
        visit_sectants(node_min, node_size, pos, clear_size, [&](int sectant) {
            if (node_empty_at(t, key, sectant))
                new_occupied &= ~(1ull << sectant);
        });
    }
    if (new_occupied == 0) {
        deallocate_children_of(t, key);
        Node& n2 = t.node(key);
        n2.children.reset();
        n2.type = NOTHING;
        n2.bricks.clear();
    }
    Node& n3 = t.node(key);
    if (n3.occupied == U64MAX && new_occupied != U64MAX)
        set_sibling_occlusions(t, node_min, node_size, false);
    n3.occupied = new_occupied;
    return new_occupied == 0;
}

// -------------------------------------------------------------- insert/clear

struct StackEntry {
    int32_t key;
    int target_sectant;
    double bmin[3];
    double bsize;
};

inline int offset_sectant_d(const double p[3], const double bmin[3],
                            double bsize) {
    int ix = std::max(0, std::min((int)((p[0] - bmin[0]) * DIM / bsize), 3));
    int iy = std::max(0, std::min((int)((p[1] - bmin[1]) * DIM / bsize), 3));
    int iz = std::max(0, std::min((int)((p[2] - bmin[2]) * DIM / bsize), 3));
    return ix + iy * 4 + iz * 16;
}

// boxtree.py _insert_at_lod_internal port; returns updated
bool insert_at_lod_internal(Tree& t, bool overwrite_if_empty,
                            const int64_t pos[3], int64_t insert_size,
                            uint32_t packed) {
    t.last_stack.clear();
    t.last_sectants.clear();
    if (pos[0] < 0 || pos[1] < 0 || pos[2] < 0 || pos[0] >= t.size ||
        pos[1] >= t.size || pos[2] >= t.size || insert_size == 0)
        return false;

    const double posd[3] = {(double)pos[0], (double)pos[1], (double)pos[2]};
    std::vector<StackEntry> stack;
    {
        StackEntry e;
        e.key = 0;
        e.bmin[0] = e.bmin[1] = e.bmin[2] = 0.0;
        e.bsize = (double)t.size;
        e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
        stack.push_back(e);
    }
    std::vector<int32_t> modified_bottom_sectants;
    int64_t actual_update[3] = {0, 0, 0};
    bool updated = false;
    std::vector<Cell> cells;

    while (true) {
        StackEntry& top = stack.back();
        int32_t key = top.key;
        int target_sectant = top.target_sectant;
        double tmin[3];
        {
            double off[3];
            sectant_offset(target_sectant, off);
            tmin[0] = top.bmin[0] + off[0] * top.bsize;
            tmin[1] = top.bmin[1] + off[1] * top.bsize;
            tmin[2] = top.bmin[2] + off[2] * top.bsize;
        }
        double tsize = top.bsize / DIM;
        Node& n = t.node(key);
        int32_t target_child = n.child(target_sectant);

        // whole-node overwrite fast path
        if (tsize > 1.0 && insert_size > 1 && tsize <= (double)insert_size &&
            posd[0] <= tmin[0] && posd[1] <= tmin[1] && posd[2] <= tmin[2]) {
            visit_cells(top.bmin, top.bsize, pos, insert_size, cells,
                        actual_update);
            for (const Cell& c : cells) {
                if (!(c.pos[0] == (int64_t)c.cmin[0] &&
                      c.pos[1] == (int64_t)c.cmin[1] &&
                      c.pos[2] == (int64_t)c.cmin[2] &&
                      c.size[0] == (int64_t)c.csize &&
                      c.size[1] == (int64_t)c.csize &&
                      c.size[2] == (int64_t)c.csize))
                    continue;
                updated = true;
                if (t.node(key).type == LEAF || t.node(key).type == UNIFORM)
                    subdivide_leaf_to_nodes(t, key, c.sectant);
                int32_t child_key = t.node(key).child(c.sectant);
                if (t.key_is_valid(child_key)) {
                    deallocate_children_of(t, child_key);
                    Node& child = t.node(child_key);
                    child.type = UNIFORM;
                    child.bricks.assign(1, Brick{});
                    child.bricks[0].kind = B_SOLID;
                    child.bricks[0].solid = packed;
                    child.children.reset();
                    child.occupied = U64MAX;
                } else {
                    int32_t ck = t.push_node();
                    Node& child = t.node(ck);
                    child.type = UNIFORM;
                    child.bricks.assign(1, Brick{});
                    child.bricks[0].kind = B_SOLID;
                    child.bricks[0].solid = packed;
                    child.occupied = U64MAX;
                    t.node(key).set_child(c.sectant, ck);
                }
                modified_bottom_sectants.push_back(c.sectant);
            }
            break;
        }

        if (tsize > 1.0 &&
            (tsize > (double)t.brick_dim || t.key_is_valid(target_child))) {
            if (t.key_is_valid(target_child)) {
                StackEntry e;
                e.key = target_child;
                e.bmin[0] = tmin[0]; e.bmin[1] = tmin[1]; e.bmin[2] = tmin[2];
                e.bsize = tsize;
                e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
                stack.push_back(e);
            } else if (n.type == LEAF || n.type == UNIFORM) {
                bool target_match = false;
                const int d = t.brick_dim;
                if (n.type == UNIFORM) {
                    const Brick& b = n.bricks[0];
                    if (b.kind == B_SOLID) {
                        target_match = b.solid == packed;
                    } else if (b.kind == B_PARTED) {
                        int mx = (int)std::floor((posd[0] - top.bmin[0]) * d / top.bsize);
                        int my = (int)std::floor((posd[1] - top.bmin[1]) * d / top.bsize);
                        int mz = (int)std::floor((posd[2] - top.bmin[2]) * d / top.bsize);
                        target_match =
                            b.v[(size_t)mx + (size_t)my * d + (size_t)mz * d * d] ==
                            packed;
                    }
                } else {
                    const Brick& b = n.bricks[target_sectant];
                    if (b.kind == B_SOLID) {
                        target_match = b.solid == packed;
                    } else if (b.kind == B_PARTED) {
                        int mx = (int)std::floor((posd[0] - tmin[0]) * d / tsize);
                        int my = (int)std::floor((posd[1] - tmin[1]) * d / tsize);
                        int mz = (int)std::floor((posd[2] - tmin[2]) * d / tsize);
                        target_match =
                            b.v[(size_t)mx + (size_t)my * d + (size_t)mz * d * d] ==
                            packed;
                    }
                }
                if (target_match || content_is_all(t, key, packed)) break;
                subdivide_leaf_to_nodes(t, key, target_sectant);
                int32_t child_key = t.node(key).child(target_sectant);
                StackEntry e;
                e.key = child_key;
                e.bmin[0] = tmin[0]; e.bmin[1] = tmin[1]; e.bmin[2] = tmin[2];
                e.bsize = tsize;
                e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
                stack.push_back(e);
            } else {
                if (n.type == NOTHING) {
                    n.type = INTERNAL;
                    n.occupied = 0;
                }
                int32_t new_child = t.push_node();
                t.node(key).set_child(target_sectant, new_child);
                StackEntry e;
                e.key = new_child;
                e.bmin[0] = tmin[0]; e.bmin[1] = tmin[1]; e.bmin[2] = tmin[2];
                e.bsize = tsize;
                e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
                stack.push_back(e);
            }
        } else {
            visit_cells(top.bmin, top.bsize, pos, insert_size, cells,
                        actual_update);
            for (const Cell& c : cells) {
                updated |= leaf_update(t, overwrite_if_empty, key, top.bmin,
                                       top.bsize, c.cmin, c.csize, c.sectant,
                                       c.pos, c.size, packed);
                modified_bottom_sectants.push_back(c.sectant);
            }
            break;
        }
    }

    for (const StackEntry& e : stack) t.last_stack.push_back(e.key);
    t.last_sectants = modified_bottom_sectants;
    if (!updated) return false;

    bool simplifyable = t.auto_simplify;

    // bottom-level post-processing per modified sectant
    {
        const StackEntry& bottom = stack.back();
        for (int32_t sectant : modified_bottom_sectants) {
            int32_t child_key = t.node(bottom.key).child(sectant);
            if (t.key_is_valid(child_key)) {
                double off[3];
                sectant_offset(sectant, off);
                double cmin[3] = {bottom.bmin[0] + off[0] * bottom.bsize,
                                  bottom.bmin[1] + off[1] * bottom.bsize,
                                  bottom.bmin[2] + off[2] * bottom.bsize};
                post_process_insert(t, child_key, cmin, bottom.bsize / DIM,
                                    actual_update, pos, insert_size);
            } else {
                post_process_insert(t, bottom.key, bottom.bmin, bottom.bsize,
                                    actual_update, pos, insert_size);
            }
            if (simplifyable) simplifyable &= simplify(t, child_key, false);
        }
    }

    // upper levels (deepest first)
    for (int i = (int)stack.size() - 1; i >= 0; --i) {
        const StackEntry& e = stack[i];
        if (t.key_is_valid(e.key)) {
            post_process_insert(t, e.key, e.bmin, e.bsize, actual_update, pos,
                                insert_size);
            if (simplifyable) simplifyable = simplify(t, e.key, false);
        }
    }
    return true;
}

// boxtree.py clear_at_lod port; returns updated
bool clear_at_lod_internal(Tree& t, const int64_t pos[3], int64_t clear_size) {
    t.last_stack.clear();
    t.last_sectants.clear();
    if (pos[0] < 0 || pos[1] < 0 || pos[2] < 0 || pos[0] >= t.size ||
        pos[1] >= t.size || pos[2] >= t.size || clear_size == 0)
        return false;

    const double posd[3] = {(double)pos[0], (double)pos[1], (double)pos[2]};
    std::vector<StackEntry> stack;
    {
        StackEntry e;
        e.key = 0;
        e.bmin[0] = e.bmin[1] = e.bmin[2] = 0.0;
        e.bsize = (double)t.size;
        e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
        stack.push_back(e);
    }
    std::vector<int32_t> erased_whole_sectants;
    std::vector<int32_t> modified_bottom_sectants;
    int64_t actual_update[3] = {0, 0, 0};
    bool updated = false;
    std::vector<Cell> cells;

    while (true) {
        StackEntry& top = stack.back();
        int32_t key = top.key;
        int target_sectant = top.target_sectant;
        double tmin[3];
        {
            double off[3];
            sectant_offset(target_sectant, off);
            tmin[0] = top.bmin[0] + off[0] * top.bsize;
            tmin[1] = top.bmin[1] + off[1] * top.bsize;
            tmin[2] = top.bmin[2] + off[2] * top.bsize;
        }
        double tsize = top.bsize / DIM;
        Node& n = t.node(key);
        int32_t target_child = n.child(target_sectant);

        // whole-node erase fast path
        if (clear_size > 1 && tsize <= (double)clear_size &&
            posd[0] <= tmin[0] && posd[1] <= tmin[1] && posd[2] <= tmin[2] &&
            n.type == INTERNAL) {
            visit_cells(top.bmin, top.bsize, pos, clear_size, cells,
                        actual_update);
            for (const Cell& c : cells) {
                if (!(c.pos[0] == (int64_t)c.cmin[0] &&
                      c.pos[1] == (int64_t)c.cmin[1] &&
                      c.pos[2] == (int64_t)c.cmin[2] &&
                      c.size[0] == (int64_t)c.csize &&
                      c.size[1] == (int64_t)c.csize &&
                      c.size[2] == (int64_t)c.csize))
                    continue;
                int32_t child_key = t.node(key).child(c.sectant);
                if (t.key_is_valid(child_key)) {
                    updated = true;
                    deallocate_children_of(t, child_key);
                    Node& child = t.node(child_key);
                    child.type = NOTHING;
                    child.bricks.clear();
                    child.children.reset();
                    erased_whole_sectants.push_back(c.sectant);
                }
            }
            break;
        }

        if (tsize > (double)std::max(clear_size, (int64_t)t.brick_dim) ||
            t.key_is_valid(target_child)) {
            if (t.key_is_valid(target_child)) {
                StackEntry e;
                e.key = target_child;
                e.bmin[0] = tmin[0]; e.bmin[1] = tmin[1]; e.bmin[2] = tmin[2];
                e.bsize = tsize;
                e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
                stack.push_back(e);
            } else if (n.type == LEAF || n.type == UNIFORM) {
                const int d = t.brick_dim;
                bool target_match = false;
                const Brick& b =
                    n.type == UNIFORM ? n.bricks[0] : n.bricks[target_sectant];
                if (b.kind == B_NONE) {
                    target_match = true;
                } else if (b.kind == B_SOLID) {
                    target_match = pix_points_to_empty(t, b.solid);
                } else {
                    int rx = (int)(pos[0] - (int64_t)top.bmin[0]);
                    int ry = (int)(pos[1] - (int64_t)top.bmin[1]);
                    int rz = (int)(pos[2] - (int64_t)top.bmin[2]);
                    target_match = pix_points_to_empty(
                        t, b.v[(size_t)rx + (size_t)ry * d + (size_t)rz * d * d]);
                }
                if (target_match || content_is_empty(t, key)) break;
                subdivide_leaf_to_nodes(t, key, target_sectant);
                int32_t child_key = t.node(key).child(target_sectant);
                StackEntry e;
                e.key = child_key;
                e.bmin[0] = tmin[0]; e.bmin[1] = tmin[1]; e.bmin[2] = tmin[2];
                e.bsize = tsize;
                e.target_sectant = offset_sectant_d(posd, e.bmin, e.bsize);
                stack.push_back(e);
            } else {
                break;  // nothing to clear
            }
        } else {
            visit_cells(top.bmin, top.bsize, pos, clear_size, cells,
                        actual_update);
            for (const Cell& c : cells) {
                updated |= leaf_update(t, true, key, top.bmin, top.bsize,
                                       c.cmin, c.csize, c.sectant, c.pos,
                                       c.size, EMPTY_VOXEL);
                modified_bottom_sectants.push_back(c.sectant);
            }
            break;
        }
    }

    for (const StackEntry& e : stack) t.last_stack.push_back(e.key);
    if (!updated) {
        t.last_sectants = modified_bottom_sectants;
        return false;
    }

    bool simplifyable = t.auto_simplify;

    {
        const StackEntry& bottom = stack.back();
        std::vector<int32_t> none;
        for (int32_t sectant : modified_bottom_sectants) {
            int32_t child_key = t.node(bottom.key).child(sectant);
            if (t.key_is_valid(child_key)) {
                double off[3];
                sectant_offset(sectant, off);
                double cmin[3] = {bottom.bmin[0] + off[0] * bottom.bsize,
                                  bottom.bmin[1] + off[1] * bottom.bsize,
                                  bottom.bmin[2] + off[2] * bottom.bsize};
                post_process_clear(t, child_key, cmin, bottom.bsize / DIM,
                                   actual_update, pos, clear_size, none);
            } else {
                post_process_clear(t, bottom.key, bottom.bmin, bottom.bsize,
                                   actual_update, pos, clear_size, none);
            }
            if (simplifyable) simplifyable &= simplify(t, child_key, false);
        }
    }

    for (int i = (int)stack.size() - 1; i >= 0; --i) {
        const StackEntry& e = stack[i];
        bool depleted =
            post_process_clear(t, e.key, e.bmin, e.bsize, actual_update, pos,
                               clear_size, erased_whole_sectants);
        // report a depleted node to its PARENT at the node's sectant within
        // the parent (= the parent's stored path sectant)
        erased_whole_sectants.clear();
        if (depleted && i >= 1)
            erased_whole_sectants.push_back(stack[i - 1].target_sectant);
        if (simplifyable) simplifyable = simplify(t, e.key, true);
    }

    t.last_sectants = erased_whole_sectants;
    t.last_sectants.insert(t.last_sectants.end(),
                           modified_bottom_sectants.begin(),
                           modified_bottom_sectants.end());
    return true;
}

// --------------------------------------------------------------------- query

uint32_t get_packed(Tree& t, const int64_t pos[3]) {
    if (pos[0] < 0 || pos[1] < 0 || pos[2] < 0 || pos[0] >= t.size ||
        pos[1] >= t.size || pos[2] >= t.size)
        return EMPTY_VOXEL;
    const double posd[3] = {(double)pos[0], (double)pos[1], (double)pos[2]};
    double bmin[3] = {0, 0, 0};
    double bsize = (double)t.size;
    int32_t key = 0;
    while (true) {
        Node& n = t.node(key);
        if (n.type != INTERNAL) break;
        int sectant = offset_sectant_d(posd, bmin, bsize);
        int32_t child = n.child(sectant);
        if (!t.key_is_valid(child)) break;
        double off[3];
        sectant_offset(sectant, off);
        bmin[0] += off[0] * bsize;
        bmin[1] += off[1] * bsize;
        bmin[2] += off[2] * bsize;
        bsize /= DIM;
        key = child;
    }
    Node& n = t.node(key);
    const int d = t.brick_dim;
    if (n.type == NOTHING || n.type == INTERNAL) return EMPTY_VOXEL;
    if (n.type == LEAF) {
        int sectant = offset_sectant_d(posd, bmin, bsize);
        const Brick& b = n.bricks[sectant];
        if (b.kind == B_NONE) return EMPTY_VOXEL;
        if (b.kind == B_SOLID) return b.solid;
        double off[3];
        sectant_offset(sectant, off);
        double cmin[3] = {bmin[0] + off[0] * bsize, bmin[1] + off[1] * bsize,
                          bmin[2] + off[2] * bsize};
        double csize = bsize / DIM;
        int mx = (int)std::floor((posd[0] - cmin[0]) * d / csize);
        int my = (int)std::floor((posd[1] - cmin[1]) * d / csize);
        int mz = (int)std::floor((posd[2] - cmin[2]) * d / csize);
        uint32_t packed = b.v[(size_t)mx + (size_t)my * d + (size_t)mz * d * d];
        return pix_points_to_empty(t, packed) ? EMPTY_VOXEL : packed;
    }
    // UNIFORM
    const Brick& b = n.bricks[0];
    if (b.kind == B_NONE) return EMPTY_VOXEL;
    if (b.kind == B_SOLID) return b.solid;
    int mx = (int)std::floor((posd[0] - bmin[0]) * d / bsize);
    int my = (int)std::floor((posd[1] - bmin[1]) * d / bsize);
    int mz = (int)std::floor((posd[2] - bmin[2]) * d / bsize);
    return b.v[(size_t)mx + (size_t)my * d + (size_t)mz * d * d];
}

}  // namespace

// ------------------------------------------------------------------- C API

extern "C" {

void* edit_tree_new(int64_t size, int32_t brick_dim, int32_t auto_simplify) {
    Tree* t = new Tree();
    t->size = size;
    t->brick_dim = brick_dim;
    t->auto_simplify = auto_simplify != 0;
    t->nodes.push_back(std::make_unique<Node>());  // ROOT
    return t;
}

void edit_tree_free(void* tp) { delete (Tree*)tp; }

// full palette-emptiness re-sync (append-mostly in practice)
void edit_tree_set_palette(void* tp, const uint8_t* color_empty,
                           int64_t n_colors, const uint8_t* data_empty,
                           int64_t n_data) {
    Tree* t = (Tree*)tp;
    t->color_empty.assign(color_empty, color_empty + n_colors);
    t->data_empty.assign(data_empty, data_empty + n_data);
}

int32_t edit_tree_insert(void* tp, int64_t x, int64_t y, int64_t z,
                         int64_t insert_size, uint32_t packed,
                         int32_t overwrite) {
    Tree* t = (Tree*)tp;
    const int64_t pos[3] = {x, y, z};
    return insert_at_lod_internal(*t, overwrite != 0, pos, insert_size, packed)
               ? 1 : 0;
}

int32_t edit_tree_clear(void* tp, int64_t x, int64_t y, int64_t z,
                        int64_t clear_size) {
    Tree* t = (Tree*)tp;
    const int64_t pos[3] = {x, y, z};
    return clear_at_lod_internal(*t, pos, clear_size) ? 1 : 0;
}

// batched single-voxel ops: one call, N edits — amortizes the binding cost
int64_t edit_tree_insert_batch(void* tp, const int64_t* pos,
                               const uint32_t* packed, int64_t n,
                               int32_t overwrite) {
    Tree* t = (Tree*)tp;
    int64_t updated = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p[3] = {pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2]};
        updated += insert_at_lod_internal(*t, overwrite != 0, p, 1, packed[i])
                       ? 1 : 0;
    }
    return updated;
}

int64_t edit_tree_clear_batch(void* tp, const int64_t* pos, int64_t n) {
    Tree* t = (Tree*)tp;
    int64_t updated = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p[3] = {pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2]};
        updated += clear_at_lod_internal(*t, p, 1) ? 1 : 0;
    }
    return updated;
}

void edit_tree_get_batch(void* tp, const int64_t* pos, int64_t n,
                         uint32_t* out) {
    Tree* t = (Tree*)tp;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p[3] = {pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2]};
        out[i] = get_packed(*t, p);
    }
}

uint32_t edit_tree_get(void* tp, int64_t x, int64_t y, int64_t z) {
    Tree* t = (Tree*)tp;
    const int64_t pos[3] = {x, y, z};
    return get_packed(*t, pos);
}

int64_t edit_tree_node_count(void* tp) {
    Tree* t = (Tree*)tp;
    return (int64_t)t->nodes.size() - (int64_t)t->free_list.size();
}

int64_t edit_tree_slot_count(void* tp) {
    return (int64_t)((Tree*)tp)->nodes.size();
}

// node introspection for differential tests / conversion.
// returns 0 when the slot is freed; children filled with EMPTY_KEY when absent
int32_t edit_tree_node_info(void* tp, int32_t key, uint8_t* type,
                            uint64_t* occupied, uint8_t* occlusion,
                            int32_t* children) {
    Tree* t = (Tree*)tp;
    if (!t->key_is_valid(key)) return 0;
    Node& n = t->node(key);
    *type = n.type;
    *occupied = n.occupied;
    *occlusion = n.occlusion;
    for (int s = 0; s < NCHILD; ++s) children[s] = n.child(s);
    return 1;
}

// brick introspection: sectant = -1 for UNIFORM. returns kind (0/1/2);
// fills out (d^3 u32) for parted, out[0] = solid value for solid
int32_t edit_tree_node_brick(void* tp, int32_t key, int32_t sectant,
                             uint32_t* out) {
    Tree* t = (Tree*)tp;
    if (!t->key_is_valid(key)) return 0;
    Node& n = t->node(key);
    const Brick* b = nullptr;
    if (sectant < 0) {
        if (n.type != UNIFORM) return 0;
        b = &n.bricks[0];
    } else {
        if (n.type != LEAF) return 0;
        b = &n.bricks[sectant];
    }
    if (b->kind == B_SOLID) out[0] = b->solid;
    if (b->kind == B_PARTED)
        std::memcpy(out, b->v.data(), b->v.size() * sizeof(uint32_t));
    return b->kind;
}

// -------- direct structure loading (the from_boxtree bridge): callers set
// node content wholesale instead of replaying edits

// ensure slot `key` exists and is alive; grows the pool as needed
void edit_tree_load_reserve(void* tp, int32_t n_slots) {
    Tree* t = (Tree*)tp;
    while ((int32_t)t->nodes.size() < n_slots)
        t->nodes.push_back(nullptr);
}

void edit_tree_load_node(void* tp, int32_t key, uint8_t type,
                         uint64_t occupied, uint8_t occlusion,
                         const int32_t* children) {
    Tree* t = (Tree*)tp;
    if (!t->nodes[key]) t->nodes[key] = std::make_unique<Node>();
    Node& n = *t->nodes[key];
    n.type = type;
    n.occupied = occupied;
    n.occlusion = occlusion;
    n.children.reset();
    n.bricks.clear();
    if (type == INTERNAL) {
        n.children = std::make_unique<std::array<int32_t, NCHILD>>();
        for (int s = 0; s < NCHILD; ++s) (*n.children)[s] = children[s];
    } else if (type == LEAF) {
        n.bricks.assign(NCHILD, Brick{});
    } else if (type == UNIFORM) {
        n.bricks.assign(1, Brick{});
    }
}

// kind: 1 solid (data[0]), 2 parted (data = d^3 words); sectant -1 = uniform
void edit_tree_load_brick(void* tp, int32_t key, int32_t sectant,
                          int32_t kind, const uint32_t* data) {
    Tree* t = (Tree*)tp;
    Node& n = *t->nodes[key];
    Brick& b = sectant < 0 ? n.bricks[0] : n.bricks[sectant];
    b.kind = (uint8_t)kind;
    if (kind == B_SOLID) {
        b.solid = data[0];
    } else if (kind == B_PARTED) {
        const size_t d = (size_t)t->brick_dim;
        b.v.assign(data, data + d * d * d);
    }
}

// rebuild the free list after loading (freed = still-null slots)
void edit_tree_load_finish(void* tp) {
    Tree* t = (Tree*)tp;
    t->free_list.clear();
    for (int32_t k = (int32_t)t->nodes.size() - 1; k >= 0; --k)
        if (!t->nodes[k]) t->free_list.push_back(k);
}

int32_t edit_tree_last_stack(void* tp, int32_t* out, int32_t cap) {
    Tree* t = (Tree*)tp;
    int32_t n = (int32_t)std::min<size_t>(t->last_stack.size(), (size_t)cap);
    std::memcpy(out, t->last_stack.data(), (size_t)n * sizeof(int32_t));
    return n;
}

int32_t edit_tree_last_sectants(void* tp, int32_t* out, int32_t cap) {
    Tree* t = (Tree*)tp;
    int32_t n = (int32_t)std::min<size_t>(t->last_sectants.size(), (size_t)cap);
    std::memcpy(out, t->last_sectants.data(), (size_t)n * sizeof(int32_t));
    return n;
}

}  // extern "C"
