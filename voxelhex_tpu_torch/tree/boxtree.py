"""The boxtree: a sparse 64-tree of voxel bricks on the host (NumPy), the
port's copy of the reference's ``voxelhex_tpu/tree/boxtree.py``, with its
names and semantics.

The editable scene: every node splits space 4x4x4 and leaves hold
``brick_dim``^3 voxel bricks.  A voxel is a packed 32-bit palette reference
(low 16 bits the color index, high 16 bits the user-data index, 0xFFFF for
none), so a brick is a ``uint32`` array.

* node content: ``NOTHING | INTERNAL | LEAF | UNIFORM``; a LEAF holds 64
  bricks (one a sectant), a UNIFORM node one brick stretched over the whole
  node (its voxels may span more than one world unit: the tree's LOD and
  compression);
* brick data: ``None`` (empty) | ``int`` (solid packed voxel) |
  ``np.ndarray[uint32]`` of ``brick_dim**3`` voxels, x fastest;
* regions of a brick's size occur both as bricks inside a LEAF and as
  cell-sized child nodes with UNIFORM content (made by bulk overwrites and
  subdivision).

Edits (``insert``, ``update``, ``insert_at_lod``, ``clear``,
``clear_at_lod``) keep each node's 64-bit occupancy and 6-bit occlusion,
simplify homogeneous content upward when ``auto_simplify`` is set, update
MIP texels when a :mod:`~voxelhex_tpu_torch.tree.mipmap` strategy is
enabled, and call each of ``update_triggers`` with the path they touched.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np

from voxelhex_tpu_torch.constants import (
    BOX_NODE_CHILDREN_COUNT,
    BOX_NODE_DIMENSION,
    EMPTY_U16,
    EMPTY_VOXEL,
)
from voxelhex_tpu_torch.spatial.math import (
    brick_occupied_bits,
    child_bounds_for,
    cube_contains,
    flat_projection,
    matrix_index_for,
    offset_sectant,
    sectant_offset,
)

# Node content types
NOTHING = 0
INTERNAL = 1
LEAF = 2
UNIFORM = 3

# Node-pool sentinel key
EMPTY_KEY = -1

U64_MAX = (1 << 64) - 1

# Occlusion face bit indices
SIDE_BACK = 0  # -z neighbor direction
SIDE_FRONT = 1
SIDE_TOP = 2
SIDE_BOTTOM = 3
SIDE_LEFT = 4
SIDE_RIGHT = 5


@dataclass(frozen=True)
class Albedo:
    """RGBA8 color of a voxel."""

    r: int = 0
    g: int = 0
    b: int = 0
    a: int = 0

    @classmethod
    def from_u32(cls, value: int) -> "Albedo":
        """Parse 0xRRGGBBAA."""
        return cls(
            (value >> 24) & 0xFF, (value >> 16) & 0xFF, (value >> 8) & 0xFF, value & 0xFF
        )

    @property
    def is_transparent(self) -> bool:
        return self.a == 0

    @property
    def is_zero(self) -> bool:
        return self.r == 0 and self.g == 0 and self.b == 0 and self.a == 0

    def distance_from(self, other: "Albedo") -> float:
        return float(
            np.sqrt(
                (self.r - other.r) ** 2
                + (self.g - other.g) ** 2
                + (self.b - other.b) ** 2
                + (self.a - other.a) ** 2
            )
        )


def _data_is_empty(data) -> bool:
    """User-data emptiness: delegate to ``is_empty`` when available, else
    compare against zero."""
    if data is None:
        return True
    probe = getattr(data, "is_empty", None)
    if probe is not None:
        return bool(probe() if callable(probe) else probe)
    try:
        return data == 0
    except TypeError:
        return False


@dataclass(frozen=True)
class Entry:
    """A queried / inserted voxel value: optional color and optional user data."""

    albedo: Albedo | None = None
    data: object | None = None

    @property
    def is_none(self) -> bool:
        color_none = self.albedo is None or self.albedo.is_transparent
        return color_none and _data_is_empty(self.data)

    @property
    def is_some(self) -> bool:
        return not self.is_none


EMPTY_ENTRY = Entry()


class _Node:
    """One pool slot: content type, child keys, bricks, occupancy + occlusion."""

    __slots__ = ("ntype", "children", "bricks", "mip", "occupied", "occlusion")

    def __init__(self):
        self.ntype = NOTHING
        self.children: list[int] | None = None  # 64 node keys when INTERNAL
        self.bricks = None  # list of 64 bricks (LEAF) | single brick (UNIFORM)
        self.mip = None  # MIP brick (same representation as a brick)
        self.occupied = 0  # u64 sectant occupancy
        self.occlusion = 0  # 6 face bits

    def child(self, sectant: int) -> int:
        if self.children is None:
            return EMPTY_KEY
        return self.children[sectant]

    def set_child(self, sectant: int, key: int):
        if self.children is None:
            self.children = [EMPTY_KEY] * BOX_NODE_CHILDREN_COUNT
        self.children[sectant] = key

    def set_occlusion(self, side: int, occluded: bool):
        if occluded:
            self.occlusion |= 1 << side
        else:
            self.occlusion &= ~(1 << side)


# ---------------------------------------------------------------------------
# Packed palette values (the "pix" helpers)
# ---------------------------------------------------------------------------


def pix_visual(color_index: int) -> int:
    return color_index | (EMPTY_U16 << 16)


def pix_informal(data_index: int) -> int:
    return EMPTY_U16 | (data_index << 16)


def pix_complex(color_index: int, data_index: int) -> int:
    return color_index | (data_index << 16)


def pix_color_index(packed: int) -> int:
    return int(packed) & 0xFFFF


def pix_data_index(packed: int) -> int:
    return (int(packed) >> 16) & 0xFFFF


def pix_color_is_some(packed: int) -> bool:
    return pix_color_index(packed) != EMPTY_U16


def pix_data_is_some(packed: int) -> bool:
    return pix_data_index(packed) != EMPTY_U16


def pix_overwrite_color(packed: int, delta: int) -> int:
    return (int(packed) & 0xFFFF0000) | (int(delta) & 0x0000FFFF)


def pix_overwrite_data(packed: int, delta: int) -> int:
    return (int(packed) & 0x0000FFFF) | (int(delta) & 0xFFFF0000)


def _visit_cells(node_min, node_size, position, update_size):
    """Visit every child cell of a node intersecting the update box; the bulk
    operation workhorse.

    Yields ``(pos_in_cell, size_in_cell, sectant, cell_min, cell_size)`` with
    the update window clipped per cell.  ``cell_min``/``cell_size`` are
    floored/ceiled to integers for sub-unit cells of uniform leaves.
    """
    # scalar math throughout: this runs once per touched level on EVERY edit,
    # and numpy-on-3-vectors costs ~10x the arithmetic here
    mx = float(node_min[0])
    my = float(node_min[1])
    mz = float(node_min[2])
    ns = float(node_size)
    px, py, pz = (float(c) for c in position)
    if px > mx + ns or py > my + ns or pz > mz + ns:
        return [], np.zeros(3, dtype=np.int64)

    sx, sy, sz = max(px, mx), max(py, my), max(pz, mz)
    u = float(update_size)
    ux, uy, uz = px + u - sx, py + u - sy, pz + u - sz
    cell_size = ns / BOX_NODE_DIMENSION
    csize = float(math.ceil(cell_size))

    results = []
    x = sx
    while x <= sx + ux:
        y = sy
        while y <= sy + uy:
            z = sz
            while z <= sz + uz:
                if (
                    mx <= x < mx + ns
                    and my <= y < my + ns
                    and mz <= z < mz + ns
                ):
                    ix = min(int((x - mx) * BOX_NODE_DIMENSION / ns), 3)
                    iy = min(int((y - my) * BOX_NODE_DIMENSION / ns), 3)
                    iz = min(int((z - mz) * BOX_NODE_DIMENSION / ns), 3)
                    sectant = ix + iy * 4 + iz * 16
                    cx = math.floor(mx + ix * 0.25 * ns)
                    cy = math.floor(my + iy * 0.25 * ns)
                    cz = math.floor(mz + iz * 0.25 * ns)
                    pix, piy, piz = max(sx, cx), max(sy, cy), max(sz, cz)
                    six = min(cx + csize - pix, sx + ux - pix)
                    siy = min(cy + csize - piy, sy + uy - piy)
                    siz = min(cz + csize - piz, sz + uz - piz)
                    if six > 0 and siy > 0 and siz > 0:
                        results.append(
                            (
                                np.array([pix, piy, piz], dtype=np.int64),
                                np.array([six, siy, siz], dtype=np.int64),
                                sectant,
                                np.array([cx, cy, cz], dtype=np.float64),
                                csize,
                            )
                        )
                z += cell_size
            y += cell_size
        x += cell_size

    return results, np.array([ux, uy, uz]).astype(np.int64)


def _visit_sectants(node_min, node_size, position, update_size):
    """Sectant indices of the child cells ``_visit_cells`` would yield —
    the allocation-free subset used by the bottom-up post-processing passes,
    which only need to know WHICH sectants an update touched."""
    mx = float(node_min[0])
    my = float(node_min[1])
    mz = float(node_min[2])
    ns = float(node_size)
    px, py, pz = (float(c) for c in position)
    if px > mx + ns or py > my + ns or pz > mz + ns:
        return []

    sx, sy, sz = max(px, mx), max(py, my), max(pz, mz)
    u = float(update_size)
    ux, uy, uz = px + u - sx, py + u - sy, pz + u - sz
    cell_size = ns / BOX_NODE_DIMENSION
    csize = float(math.ceil(cell_size))

    sectants = []
    x = sx
    while x <= sx + ux:
        y = sy
        while y <= sy + uy:
            z = sz
            while z <= sz + uz:
                if (
                    mx <= x < mx + ns
                    and my <= y < my + ns
                    and mz <= z < mz + ns
                ):
                    ix = min(int((x - mx) * BOX_NODE_DIMENSION / ns), 3)
                    iy = min(int((y - my) * BOX_NODE_DIMENSION / ns), 3)
                    iz = min(int((z - mz) * BOX_NODE_DIMENSION / ns), 3)
                    cx = math.floor(mx + ix * 0.25 * ns)
                    cy = math.floor(my + iy * 0.25 * ns)
                    cz = math.floor(mz + iz * 0.25 * ns)
                    if (
                        min(cx + csize, sx + ux) > max(sx, cx)
                        and min(cy + csize, sy + uy) > max(sy, cy)
                        and min(cz + csize, sz + uz) > max(sz, cz)
                    ):
                        sectants.append(ix + iy * 4 + iz * 16)
                z += cell_size
            y += cell_size
        x += cell_size
    return sectants


class BoxTree:
    """Sparse 64-tree of voxel bricks (see module docstring).

    * ``size`` — world extent; must be ``brick_dim * 4**k`` with ``k >= 1``.
    * ``brick_dim`` — voxels per brick edge; must be a power of two.
    """

    ROOT = 0

    def __init__(self, size: int, brick_dim: int = 32, auto_simplify: bool = True):
        if brick_dim <= 0 or (brick_dim & (brick_dim - 1)) != 0:
            raise ValueError(f"brick_dim must be a power of two, got {brick_dim}")
        ratio = size / brick_dim if brick_dim else 0
        k = np.log(ratio) / np.log(4.0) if ratio > 0 else -1
        if size <= 0 or ratio <= 0 or abs(k - round(k)) > 1e-9:
            raise ValueError(f"size must be brick_dim * 4**k, got size={size}")
        if size < brick_dim * BOX_NODE_DIMENSION:
            raise ValueError("size must be at least 4 * brick_dim")

        self.size = int(size)
        self.brick_dim = int(brick_dim)
        self.auto_simplify = bool(auto_simplify)

        self._nodes: list[_Node | None] = [_Node()]
        self._free: list[int] = []

        self.color_palette: list[Albedo] = []
        self.data_palette: list[object] = []
        self._color_map: dict[Albedo, int] = {}
        self._data_map: dict[object, int] = {}

        # MIP strategy plugged in by voxelhex_tpu_torch.tree.mipmap (late import to
        # keep layering acyclic); None => MIPs disabled.
        self.mip_strategy = None

        # callbacks fired after each update: fn(access_stack, sectants)
        self.update_triggers: list = []

        # mipmap's int32 [P, 4] mirror of the color palette (a doubling
        # buffer) and the palette entries it holds
        self._palette_buf = None
        self._palette_cnt = 0

    # ------------------------------------------------------------------
    # node pool
    # ------------------------------------------------------------------

    def _push_node(self, node: _Node) -> int:
        if self._free:
            key = self._free.pop()
            self._nodes[key] = node
            return key
        self._nodes.append(node)
        return len(self._nodes) - 1

    def _free_node(self, key: int):
        if 0 <= key < len(self._nodes) and self._nodes[key] is not None:
            self._nodes[key] = None
            self._free.append(key)

    def key_is_valid(self, key: int) -> bool:
        return 0 <= key < len(self._nodes) and self._nodes[key] is not None

    def node(self, key: int) -> _Node:
        n = self._nodes[key]
        if n is None:
            raise KeyError(f"invalid node key {key}")
        return n

    @property
    def node_count(self) -> int:
        return len(self._nodes) - len(self._free)

    def max_mip_level(self) -> int:
        """log4(size / brick_dim), the number of levels above bricks."""
        return int(np.ceil(np.log(self.size / self.brick_dim) / np.log(4.0) - 1e-9))

    # ------------------------------------------------------------------
    # palette
    # ------------------------------------------------------------------

    def _intern_color(self, albedo: Albedo) -> int:
        idx = self._color_map.get(albedo)
        if idx is None:
            idx = len(self.color_palette)
            if idx >= EMPTY_U16:
                raise ValueError("color palette overflow")
            self._color_map[albedo] = idx
            self.color_palette.append(albedo)
        return idx

    def _intern_data(self, data) -> int:
        idx = self._data_map.get(data)
        if idx is None:
            idx = len(self.data_palette)
            if idx >= EMPTY_U16:
                raise ValueError("data palette overflow")
            self._data_map[data] = idx
            self.data_palette.append(data)
        return idx

    def add_to_palette(self, entry: Entry) -> int:
        """Dedup entry components into the palettes; return the packed voxel."""
        albedo, data = entry.albedo, entry.data
        has_color = albedo is not None and not albedo.is_zero
        has_data = data is not None and not _data_is_empty(data)
        if has_color and has_data:
            return pix_complex(self._intern_color(albedo), self._intern_data(data))
        if has_color:
            return pix_visual(self._intern_color(albedo))
        if has_data:
            return pix_informal(self._intern_data(data))
        return EMPTY_VOXEL

    def pix_points_to_empty(self, packed: int) -> bool:
        """True when the packed voxel renders as nothing: color missing or
        transparent AND data missing or empty."""
        ci, di = pix_color_index(packed), pix_data_index(packed)
        color_empty = ci == EMPTY_U16 or self.color_palette[ci].is_transparent
        data_empty = di == EMPTY_U16 or _data_is_empty(self.data_palette[di])
        return color_empty and data_empty

    def entry_for(self, packed: int) -> Entry:
        ci, di = pix_color_index(packed), pix_data_index(packed)
        albedo = self.color_palette[ci] if ci != EMPTY_U16 else None
        data = self.data_palette[di] if di != EMPTY_U16 else None
        if albedo is None and data is None:
            return EMPTY_ENTRY
        return Entry(albedo=albedo, data=data)

    # ------------------------------------------------------------------
    # brick helpers
    # ------------------------------------------------------------------

    def _new_brick(self, fill: int = EMPTY_VOXEL) -> np.ndarray:
        return np.full(self.brick_dim**3, fill, dtype=np.uint32)

    def brick_contains_nothing(self, brick) -> bool:
        if brick is None:
            return True
        if isinstance(brick, (int, np.integer)):
            return self.pix_points_to_empty(int(brick))
        return bool(np.all(self._brick_empty_mask(brick)))

    def _brick_empty_mask(self, brick: np.ndarray) -> np.ndarray:
        """Vectorized per-voxel emptiness for a parted brick."""
        ci = brick & np.uint32(0xFFFF)
        di = brick >> np.uint32(16)
        color_alpha = np.array([c.a for c in self.color_palette] + [0], dtype=np.uint32)
        ci_clip = np.minimum(ci, len(self.color_palette))
        color_empty = (ci == EMPTY_U16) | (color_alpha[ci_clip] == 0)
        if self.data_palette:
            data_empty_tab = np.array(
                [_data_is_empty(d) for d in self.data_palette] + [True], dtype=bool
            )
            di_clip = np.minimum(di, len(self.data_palette))
            data_empty = (di == EMPTY_U16) | data_empty_tab[di_clip]
        else:
            data_empty = np.ones_like(color_empty)
        return color_empty & data_empty

    def brick_homogeneous_value(self, brick):
        """The single packed value when the brick is homogeneous, else None."""
        if brick is None:
            return None
        if isinstance(brick, (int, np.integer)):
            return int(brick)
        first = int(brick.flat[0])
        if np.all(brick == np.uint32(first)):
            return first
        return None

    def brick_simplify(self, brick):
        """Collapse homogeneous parted bricks; returns (new_brick, changed)."""
        v = self.brick_homogeneous_value(brick)
        if v is None:
            return brick, False
        if brick is None:
            return None, False
        if isinstance(brick, (int, np.integer)):
            return brick, False
        if self.pix_points_to_empty(v):
            return None, True
        return v, True

    def brick_occupied(self, brick) -> int:
        """64-bit occupancy of a brick."""
        if brick is None:
            return 0
        if isinstance(brick, (int, np.integer)):
            return 0 if self.pix_points_to_empty(int(brick)) else U64_MAX
        return brick_occupied_bits(~self._brick_empty_mask(brick))

    def dilute_brick(self, brick: np.ndarray) -> list[np.ndarray]:
        """Map one brick onto 64 child bricks, each stretching one sectant's
        worth of source voxels over a full brick."""
        d = self.brick_dim
        src = brick.reshape(d, d, d)  # [z, y, x]
        out = []
        idx = np.arange(d)
        for sect in range(BOX_NODE_CHILDREN_COUNT):
            # The child brick covers 1/4 of the node extent per axis; child
            # voxel i samples source voxel floor(off + i/4), where off is the
            # sectant offset in source-voxel units (fractional when d < 4).
            off = sectant_offset(sect) * d
            sx = np.clip(np.floor(off[0] + idx / BOX_NODE_DIMENSION), 0, d - 1).astype(np.int64)
            sy = np.clip(np.floor(off[1] + idx / BOX_NODE_DIMENSION), 0, d - 1).astype(np.int64)
            sz = np.clip(np.floor(off[2] + idx / BOX_NODE_DIMENSION), 0, d - 1).astype(np.int64)
            child = src[np.ix_(sz, sy, sx)]
            out.append(np.ascontiguousarray(child).reshape(-1))
        return out

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _root_bounds(self):
        return np.zeros(3, dtype=np.float64), float(self.size)

    def get_node_at(self, position):
        """Deepest node covering an integer position; returns
        (key, bounds_min, bounds_size)."""
        pos = np.asarray(position, dtype=np.float64)
        bmin, bsize = self._root_bounds()
        key = self.ROOT
        while True:
            node = self.node(key)
            if node.ntype != INTERNAL:
                return key, bmin, bsize
            sectant = offset_sectant(pos - bmin, bsize)
            child = node.child(sectant)
            if not self.key_is_valid(child):
                return key, bmin, bsize
            bmin, bsize = child_bounds_for(bmin, bsize, sectant)
            bmin = bmin.astype(np.float64)
            key = child

    def get_packed(self, position) -> int:
        """Packed voxel value at an integer position (EMPTY_VOXEL when empty)."""
        pos = np.asarray(position, dtype=np.int64)
        bmin, bsize = self._root_bounds()
        if not cube_contains(bmin, bsize, pos):
            return EMPTY_VOXEL
        key, bmin, bsize = self.get_node_at(pos)
        node = self.node(key)
        d = self.brick_dim
        if node.ntype in (NOTHING, INTERNAL):
            return EMPTY_VOXEL
        if node.ntype == LEAF:
            sectant = offset_sectant(pos - bmin, bsize)
            brick = node.bricks[sectant]
            if brick is None:
                return EMPTY_VOXEL
            if isinstance(brick, (int, np.integer)):
                return int(brick)
            cmin, csize = child_bounds_for(bmin, bsize, sectant)
            mi = matrix_index_for(cmin, csize, pos, d)
            packed = int(brick[flat_projection(int(mi[0]), int(mi[1]), int(mi[2]), d)])
            return packed if not self.pix_points_to_empty(packed) else EMPTY_VOXEL
        # UNIFORM
        brick = node.bricks
        if brick is None:
            return EMPTY_VOXEL
        if isinstance(brick, (int, np.integer)):
            return int(brick)
        mi = matrix_index_for(bmin, bsize, pos, d)
        return int(brick[flat_projection(int(mi[0]), int(mi[1]), int(mi[2]), d)])

    def get(self, position) -> Entry:
        packed = self.get_packed(position)
        return self.entry_for(packed) if packed != EMPTY_VOXEL else EMPTY_ENTRY

    # ------------------------------------------------------------------
    # node-level helpers
    # ------------------------------------------------------------------

    def deallocate_children_of(self, key: int):
        node = self.node(key)
        if node.children is not None:
            for child in node.children:
                if self.key_is_valid(child):
                    self.deallocate_children_of(child)
                    self._free_node(child)
            node.children = None

    def try_brick_from_node(self, key: int):
        """Best-effort brick from a child node when re-leafing a parent."""
        if not self.key_is_valid(key):
            return None
        node = self.node(key)
        if node.ntype == UNIFORM:
            brick = node.bricks
            if isinstance(brick, np.ndarray):
                return brick.copy()
            return brick
        return None

    def node_empty_at(self, key: int, sectant: int) -> bool:
        """True when the node has no renderable content in the given sectant."""
        node = self.node(key)
        if node.ntype == NOTHING:
            return True
        if node.ntype == LEAF:
            brick = node.bricks[sectant]
            if brick is None:
                return True
            if isinstance(brick, (int, np.integer)):
                return self.pix_points_to_empty(int(brick))
            v = self.brick_homogeneous_value(brick)
            return v is not None and self.pix_points_to_empty(v)
        if node.ntype == UNIFORM:
            brick = node.bricks
            if brick is None:
                return True
            if isinstance(brick, (int, np.integer)):
                return self.pix_points_to_empty(int(brick))
            d = self.brick_dim
            start = np.floor(sectant_offset(sectant) * d).astype(np.int64)
            span = max(1, d // BOX_NODE_DIMENSION)
            grid = brick.reshape(d, d, d)
            sub = grid[
                start[2] : start[2] + span,
                start[1] : start[1] + span,
                start[0] : start[0] + span,
            ]
            return bool(np.all(self._brick_empty_mask(sub.reshape(-1))))
        # INTERNAL
        child = node.child(sectant)
        if not self.key_is_valid(child):
            return True
        return all(
            self.node_empty_at(child, s) for s in range(BOX_NODE_CHILDREN_COUNT)
        )

    def _content_is_all(self, key: int, packed: int) -> bool:
        """Node content uniformly equals the packed value."""
        node = self.node(key)
        if node.ntype == UNIFORM:
            v = self.brick_homogeneous_value(node.bricks)
            return v is not None and v == packed
        if node.ntype == LEAF:
            for brick in node.bricks:
                v = self.brick_homogeneous_value(brick)
                if v is None or v != packed:
                    return False
            return True
        return False

    def _content_is_empty(self, key: int) -> bool:
        node = self.node(key)
        if node.ntype == NOTHING:
            return True
        if node.ntype == LEAF:
            return all(self.brick_contains_nothing(b) for b in node.bricks)
        if node.ntype == UNIFORM:
            return self.brick_contains_nothing(node.bricks)
        return False

    def subdivide_leaf_to_nodes(self, key: int, target_sectant: int):
        """Split a LEAF/UNIFORM node into child nodes, guaranteeing a child at
        ``target_sectant``."""
        node = self.node(key)
        if node.ntype not in (LEAF, UNIFORM):
            raise ValueError("subdivide expects a leaf")
        children = [EMPTY_KEY] * BOX_NODE_CHILDREN_COUNT

        if node.ntype == LEAF:
            bricks = node.bricks
            for sectant in range(BOX_NODE_CHILDREN_COUNT):
                brick = bricks[sectant]
                if not self.brick_contains_nothing(brick) or sectant == target_sectant:
                    child = _Node()
                    if brick is not None:
                        child.ntype = UNIFORM
                        child.bricks = brick
                        child.occupied = self.brick_occupied(brick)
                    children[sectant] = self._push_node(child)
        else:  # UNIFORM
            brick = node.bricks
            if brick is None:
                children[target_sectant] = self._push_node(_Node())
            elif isinstance(brick, (int, np.integer)):
                for sectant in range(BOX_NODE_CHILDREN_COUNT):
                    child = _Node()
                    child.ntype = UNIFORM
                    child.bricks = int(brick)
                    child.occupied = U64_MAX
                    children[sectant] = self._push_node(child)
            else:
                for sectant, child_brick in enumerate(self.dilute_brick(brick)):
                    child = _Node()
                    child.ntype = UNIFORM
                    child.bricks = child_brick
                    child.occupied = self.brick_occupied(child_brick)
                    children[sectant] = self._push_node(child)

        node.ntype = INTERNAL
        node.bricks = None
        node.children = children

    # ------------------------------------------------------------------
    # brick update
    # ------------------------------------------------------------------

    def _update_brick(
        self,
        overwrite_if_empty: bool,
        brick: np.ndarray,
        brick_min,
        brick_size,
        position,
        size,
        packed: int,
    ):
        """Write a cubic region of a parted brick with overwrite/merge
        semantics."""
        d = self.brick_dim
        mi = matrix_index_for(brick_min, brick_size, position, d)
        x0, y0, z0 = (int(c) for c in mi)
        x1 = min(x0 + int(size[0]), d)
        y1 = min(y0 + int(size[1]), d)
        z1 = min(z0 + int(size[2]), d)
        grid = brick.reshape(d, d, d)
        region = grid[z0:z1, y0:y1, x0:x1]
        if overwrite_if_empty:
            region[...] = np.uint32(packed)
        else:
            if pix_color_is_some(packed):
                region[...] = (region & np.uint32(0xFFFF0000)) | np.uint32(
                    packed & 0x0000FFFF
                )
            if pix_data_is_some(packed):
                region[...] = (region & np.uint32(0x0000FFFF)) | np.uint32(
                    packed & 0xFFFF0000
                )

    def leaf_update(
        self,
        overwrite_if_empty: bool,
        key: int,
        node_min,
        node_size,
        cell_min,
        cell_size,
        sectant: int,
        position,
        size,
        packed: int,
    ) -> bool:
        """Write data into the leaf content of a node, subdividing solid /
        uniform content as needed.
        Returns True when anything changed."""
        node = self.node(key)
        d = self.brick_dim
        target_empty = self.pix_points_to_empty(packed)

        if node.ntype == LEAF:
            brick = node.bricks[sectant]
            if brick is None:
                new_brick = self._new_brick()
                self._update_brick(
                    overwrite_if_empty, new_brick, cell_min, cell_size, position, size, packed
                )
                node.bricks[sectant] = new_brick
                return True
            if isinstance(brick, (int, np.integer)):
                voxel = int(brick)
                voxel_empty = self.pix_points_to_empty(voxel)
                if (target_empty and not voxel_empty) or (
                    not target_empty and voxel != packed
                ):
                    new_brick = self._new_brick(fill=voxel)
                    self._update_brick(
                        overwrite_if_empty,
                        new_brick,
                        cell_min,
                        cell_size,
                        position,
                        size,
                        packed,
                    )
                    node.bricks[sectant] = new_brick
                    return True
                return False
            self._update_brick(
                overwrite_if_empty, brick, cell_min, cell_size, position, size, packed
            )
            return True

        if node.ntype == UNIFORM:
            brick = node.bricks
            if brick is None:
                if target_empty:
                    return False
                new_bricks = [None] * BOX_NODE_CHILDREN_COUNT
                new_brick = self._new_brick()
                self._update_brick(
                    overwrite_if_empty, new_brick, cell_min, cell_size, position, size, packed
                )
                new_bricks[sectant] = new_brick
                node.ntype = LEAF
                node.bricks = new_bricks
                return True
            if isinstance(brick, (int, np.integer)):
                voxel = int(brick)
                voxel_empty = self.pix_points_to_empty(voxel)
                if target_empty and voxel_empty:
                    node.ntype = NOTHING
                    node.bricks = None
                    return False
                if (not target_empty and voxel != packed) or (
                    target_empty and not voxel_empty
                ):
                    node.bricks = self._new_brick(fill=voxel)
                    return self.leaf_update(
                        overwrite_if_empty,
                        key,
                        node_min,
                        node_size,
                        cell_min,
                        cell_size,
                        sectant,
                        position,
                        size,
                        packed,
                    )
                return False
            # Parted uniform brick: index from the NODE bounds (brick spans
            # the whole node)
            mi = matrix_index_for(node_min, node_size, position, d)
            flat = flat_projection(int(mi[0]), int(mi[1]), int(mi[2]), d)
            current = int(brick[flat])
            if d > 1 and (
                (target_empty and self.pix_points_to_empty(current))
                or (not target_empty and current == packed)
            ):
                return False
            if node_size <= d and d > 1:
                # Uniform leaf the size of one brick: update in place
                self._update_brick(
                    overwrite_if_empty, brick, node_min, node_size, position, size, packed
                )
                return True
            # Otherwise: dilute into 64 bricks and update the target one
            child_bricks = self.dilute_brick(brick)
            new_bricks: list = [None] * BOX_NODE_CHILDREN_COUNT
            for s, nb in enumerate(child_bricks):
                if s == sectant:
                    self._update_brick(
                        overwrite_if_empty, nb, cell_min, cell_size, position, size, packed
                    )
                new_bricks[s] = nb
            node.ntype = LEAF
            node.bricks = new_bricks
            return True

        # INTERNAL / NOTHING: convert to leaf by absorbing child bricks
        new_bricks = [
            self.try_brick_from_node(node.child(s))
            for s in range(BOX_NODE_CHILDREN_COUNT)
        ]
        self.deallocate_children_of(key)
        node.ntype = LEAF
        node.children = None
        node.bricks = new_bricks
        return self.leaf_update(
            overwrite_if_empty,
            key,
            node_min,
            node_size,
            cell_min,
            cell_size,
            sectant,
            position,
            size,
            packed,
        )

    # ------------------------------------------------------------------
    # simplification
    # ------------------------------------------------------------------

    def simplify(self, key: int, recursive: bool = False) -> bool:
        """Collapse homogeneous content upward.  Returns True if simplified."""
        if not self.key_is_valid(key):
            return False
        node = self.node(key)
        if node.ntype == NOTHING:
            return True
        if node.ntype == UNIFORM:
            brick = node.bricks
            if brick is None:
                return True
            if isinstance(brick, (int, np.integer)):
                if self.pix_points_to_empty(int(brick)):
                    node.ntype = NOTHING
                    node.bricks = None
                    node.children = None
                    return True
                return False
            new_brick, changed = self.brick_simplify(brick)
            if changed:
                node.bricks = new_brick
            return changed
        if node.ntype == LEAF:
            simplified = False
            solid_values = []
            uniform_solid = True
            has_parted = False
            for i, brick in enumerate(node.bricks):
                nb, changed = self.brick_simplify(brick)
                node.bricks[i] = nb
                simplified |= changed
                if isinstance(nb, (int, np.integer)):
                    solid_values.append(int(nb))
                else:
                    uniform_solid = False
                    has_parted |= nb is not None
            if uniform_solid and len(set(solid_values)) == 1:
                node.ntype = UNIFORM
                node.bricks = solid_values[0]
                return True
            if self.brick_dim == 1:
                return simplified
            # Try uniting the 64 bricks into ONE brick at 1/4 resolution:
            # possible when every 4x4x4 voxel block is constant.
            d = self.brick_dim
            if d <= BOX_NODE_DIMENSION and has_parted:
                # blocks are unions of whole bricks: any parted
                # (non-homogeneous) brick makes some block non-constant
                return simplified
            super_dim = d * BOX_NODE_DIMENSION
            full = np.empty((super_dim, super_dim, super_dim), dtype=np.uint32)
            for sectant in range(BOX_NODE_CHILDREN_COUNT):
                brick = node.bricks[sectant]
                off = (sectant_offset(sectant) * super_dim).astype(np.int64)
                if brick is None:
                    block = np.uint32(EMPTY_VOXEL)
                elif isinstance(brick, (int, np.integer)):
                    block = np.uint32(brick)
                else:
                    block = brick.reshape(d, d, d)
                full[
                    off[2] : off[2] + d, off[1] : off[1] + d, off[0] : off[0] + d
                ] = block
            blocks = full.reshape(
                d, BOX_NODE_DIMENSION, d, BOX_NODE_DIMENSION, d, BOX_NODE_DIMENSION
            ).transpose(0, 2, 4, 1, 3, 5)
            first = blocks[..., 0, 0, 0]
            if np.all(blocks == first[..., None, None, None]):
                # unified[z,y,x] = constant value of the source 4^3 block
                unified = np.ascontiguousarray(first).reshape(-1)
                node.ntype = UNIFORM
                node.bricks = unified
                return True
            return simplified
        # INTERNAL: only the degenerate collapse (VoxelHex's merge of
        # identical children is unreachable there and is
        # intentionally not replicated)
        if node.occupied == 0 or node.children is None:
            self.deallocate_children_of(key)
            node.ntype = NOTHING
            node.children = None
            return True
        if recursive and node.children is not None:
            for child in list(node.children):
                if self.key_is_valid(child):
                    self.simplify(child, True)
        return False

    # ------------------------------------------------------------------
    # occlusion bookkeeping
    # ------------------------------------------------------------------

    _SIDE_FOR_DIRECTION = (
        ((-1, 0, 0), SIDE_RIGHT),
        ((1, 0, 0), SIDE_LEFT),
        ((0, -1, 0), SIDE_TOP),
        ((0, 1, 0), SIDE_BOTTOM),
        ((0, 0, -1), SIDE_FRONT),
        ((0, 0, 1), SIDE_BACK),
    )

    def access_stack(self, position):
        """Root-to-lowest-node path covering ``position`` as a list of
        ``(key, bounds_min, bounds_size)`` tuples; empty when the position is
        outside the tree."""
        pos = np.asarray(position, dtype=np.float64)
        bmin, bsize = self._root_bounds()
        if not cube_contains(bmin, bsize, pos):
            return []
        key = self.ROOT
        stack = [(key, bmin.copy(), bsize)]
        while True:
            node = self.node(key)
            if node.ntype != INTERNAL:
                return stack
            sectant = offset_sectant(pos - bmin, bsize)
            child = node.child(sectant)
            if not self.key_is_valid(child):
                return stack
            bmin_arr, bsize = child_bounds_for(bmin, bsize, sectant)
            bmin = bmin_arr.astype(np.float64)
            key = child
            stack.append((key, bmin.copy(), bsize))

    def node_at(self, position):
        """Key of the lowest allocated node containing ``position``, or None."""
        stack = self.access_stack(position)
        return stack[-1][0] if stack else None

    def sibling_at(self, position, direction):
        """Lowest allocated node adjacent to the lowest node containing
        ``position`` when stepping one sectant cell along ``direction``;
        returns ``(key, bounds_min, bounds_size)`` or None when the step
        leaves the tree.

        Uniform leaves have no sectant substructure, so the step there is
        the whole node.
        """
        stack = self.access_stack(position)
        if not stack:
            return None
        key, _bmin, bsize = stack[-1]
        node = self.node(key)
        cell = bsize if node.ntype == UNIFORM else bsize / BOX_NODE_DIMENSION
        target = (
            np.asarray(position, dtype=np.float64)
            + np.asarray(direction, dtype=np.float64) * cell
        )
        tstack = self.access_stack(target)
        return tstack[-1] if tstack else None

    def _sibling_at(self, node_min, node_size, direction):
        """Node occupying the same-size cell adjacent in ``direction``;
        None when absent."""
        ns = float(node_size)
        tx = float(node_min[0]) + ns / 2.0 + float(direction[0]) * ns
        ty = float(node_min[1]) + ns / 2.0 + float(direction[1]) * ns
        tz = float(node_min[2]) + ns / 2.0 + float(direction[2]) * ns
        bsize = float(self.size)
        bx = by = bz = 0.0
        if not (0.0 <= tx < bsize and 0.0 <= ty < bsize and 0.0 <= tz < bsize):
            return None
        key = self.ROOT
        while bsize > ns:
            node = self.node(key)
            if node.ntype != INTERNAL:
                return None
            ix = min(int((tx - bx) * BOX_NODE_DIMENSION / bsize), 3)
            iy = min(int((ty - by) * BOX_NODE_DIMENSION / bsize), 3)
            iz = min(int((tz - bz) * BOX_NODE_DIMENSION / bsize), 3)
            child = node.child(ix + iy * 4 + iz * 16)
            if not self.key_is_valid(child):
                return None
            bsize /= BOX_NODE_DIMENSION
            bx += ix * bsize
            by += iy * bsize
            bz += iz * bsize
            key = child
        return key

    def _set_sibling_occlusions(self, node_min, node_size, occluded: bool):
        for direction, side in self._SIDE_FOR_DIRECTION:
            sib = self._sibling_at(node_min, node_size, direction)
            if sib is not None:
                self.node(sib).set_occlusion(side, occluded)

    # ------------------------------------------------------------------
    # MIP hook (implemented by voxelhex_tpu_torch.tree.mipmap)
    # ------------------------------------------------------------------

    def update_mip(self, key: int, node_min, node_size, position):
        if self.mip_strategy is not None:
            from voxelhex_tpu_torch.tree import mipmap

            mipmap.update_mip(self, key, node_min, node_size, position)

    # ------------------------------------------------------------------
    # insert / update
    # ------------------------------------------------------------------

    def insert(self, position, entry) -> None:
        self._insert_at_lod_internal(True, position, 1, self._coerce_entry(entry))

    def update(self, position, entry) -> None:
        """Merge-write: unspecified entry components keep their stored value."""
        self._insert_at_lod_internal(False, position, 1, self._coerce_entry(entry))

    def insert_at_lod(self, position, size: int, entry) -> None:
        self._insert_at_lod_internal(True, position, size, self._coerce_entry(entry))

    @staticmethod
    def _coerce_entry(entry) -> Entry:
        if isinstance(entry, Entry):
            return entry
        if isinstance(entry, Albedo):
            return Entry(albedo=entry)
        if isinstance(entry, tuple) and len(entry) == 4:
            return Entry(albedo=Albedo(*entry))
        if isinstance(entry, tuple) and len(entry) == 2:
            albedo, data = entry
            return Entry(albedo=albedo, data=data)
        return Entry(data=entry)

    def _insert_at_lod_internal(self, overwrite_if_empty, position, insert_size, entry):
        root_min, root_size = self._root_bounds()
        pos = np.asarray(position, dtype=np.int64)
        if not cube_contains(root_min, root_size, pos):
            raise ValueError(f"position {position} outside tree of size {self.size}")
        if entry.is_none or insert_size == 0:
            return

        packed = self.add_to_palette(entry)

        node_stack = [(self.ROOT, offset_sectant(pos - root_min, root_size))]
        bounds_stack = [(root_min, root_size)]
        modified_bottom_sectants: list[int] = []
        actual_update = np.zeros(3, dtype=np.int64)
        updated = False

        while True:
            key, target_sectant = node_stack[-1]
            cur_min, cur_size = bounds_stack[-1]
            tmin, tsize = child_bounds_for(cur_min, cur_size, target_sectant)
            tmin = tmin.astype(np.float64)
            node = self.node(key)
            target_child = node.child(target_sectant)

            # whole-node overwrite fast path
            if (
                tsize > 1.0
                and insert_size > 1
                and tsize <= insert_size
                and np.all(pos <= tmin)
            ):
                cells, actual_update = _visit_cells(cur_min, cur_size, pos, insert_size)
                for cpos, csize_vec, sectant, cmin, csize in cells:
                    if not (
                        np.array_equal(cpos, cmin.astype(np.int64))
                        and np.all(csize_vec == int(csize))
                    ):
                        continue
                    updated = True
                    if self.node(key).ntype in (LEAF, UNIFORM):
                        self.subdivide_leaf_to_nodes(key, sectant)
                    child_key = self.node(key).child(sectant)
                    if self.key_is_valid(child_key):
                        self.deallocate_children_of(child_key)
                        child = self.node(child_key)
                        child.ntype = UNIFORM
                        child.bricks = packed
                        child.children = None
                        child.occupied = U64_MAX
                    else:
                        child = _Node()
                        child.ntype = UNIFORM
                        child.bricks = packed
                        child.occupied = U64_MAX
                        self.node(key).set_child(sectant, self._push_node(child))
                    modified_bottom_sectants.append(sectant)
                break

            if tsize > 1.0 and (
                tsize > self.brick_dim or self.key_is_valid(target_child)
            ):
                if self.key_is_valid(target_child):
                    node_stack.append(
                        (target_child, offset_sectant(pos - tmin, tsize))
                    )
                    bounds_stack.append((tmin, tsize))
                elif node.ntype in (LEAF, UNIFORM):
                    # Check whether the stored data already matches
                    target_match = False
                    d = self.brick_dim
                    if node.ntype == UNIFORM:
                        brick = node.bricks
                        if isinstance(brick, (int, np.integer)):
                            target_match = int(brick) == packed
                        elif brick is not None:
                            mi = matrix_index_for(cur_min, cur_size, pos, d)
                            target_match = (
                                int(
                                    brick[
                                        flat_projection(
                                            int(mi[0]), int(mi[1]), int(mi[2]), d
                                        )
                                    ]
                                )
                                == packed
                            )
                    else:
                        brick = node.bricks[target_sectant]
                        if isinstance(brick, (int, np.integer)):
                            target_match = int(brick) == packed
                        elif brick is not None:
                            mi = matrix_index_for(tmin, tsize, pos, d)
                            target_match = (
                                int(
                                    brick[
                                        flat_projection(
                                            int(mi[0]), int(mi[1]), int(mi[2]), d
                                        )
                                    ]
                                )
                                == packed
                            )
                    if target_match or self._content_is_all(key, packed):
                        break
                    self.subdivide_leaf_to_nodes(key, target_sectant)
                    child_key = self.node(key).child(target_sectant)
                    node_stack.append((child_key, offset_sectant(pos - tmin, tsize)))
                    bounds_stack.append((tmin, tsize))
                else:
                    if node.ntype == NOTHING:
                        node.ntype = INTERNAL
                        node.occupied = 0
                    new_child = self._push_node(_Node())
                    node.set_child(target_sectant, new_child)
                    node_stack.append((new_child, offset_sectant(pos - tmin, tsize)))
                    bounds_stack.append((tmin, tsize))
            else:
                cells, actual_update = _visit_cells(cur_min, cur_size, pos, insert_size)
                for cpos, csize_vec, sectant, cmin, csize in cells:
                    updated |= self.leaf_update(
                        overwrite_if_empty,
                        key,
                        cur_min,
                        cur_size,
                        cmin,
                        csize,
                        sectant,
                        cpos,
                        csize_vec,
                        packed,
                    )
                    modified_bottom_sectants.append(sectant)
                break

        if not updated:
            return

        simplifyable = self.auto_simplify
        access_stack = list(node_stack)

        # bottom-level post-processing per modified sectant
        bottom_key, _ = node_stack[-1]
        bottom_min, bottom_size = bounds_stack[-1]
        for sectant in modified_bottom_sectants:
            child_key = self.node(bottom_key).child(sectant)
            if self.key_is_valid(child_key):
                cmin, csize = child_bounds_for(bottom_min, bottom_size, sectant)
                self._post_process_insert(child_key, cmin, csize, actual_update, pos, insert_size)
            else:
                self._post_process_insert(
                    bottom_key, bottom_min, bottom_size, actual_update, pos, insert_size
                )
            if simplifyable:
                simplifyable &= self.simplify(child_key, False)

        # upper levels
        while node_stack:
            key, _ = node_stack[-1]
            bmin, bsize = bounds_stack[-1]
            if self.key_is_valid(key):
                self._post_process_insert(key, bmin, bsize, actual_update, pos, insert_size)
                if simplifyable:
                    simplifyable = self.simplify(key, False)
            node_stack.pop()
            bounds_stack.pop()

        for trigger in self.update_triggers:
            trigger(access_stack, list(modified_bottom_sectants))

    def _post_process_insert(self, key, node_min, node_size, actual_update, pos, insert_size):
        """Fix up content type, occupancy, sibling occlusion and MIP after an
        insert touched this node."""
        node = self.node(key)
        if node.ntype == NOTHING:
            node.ntype = INTERNAL
            node.occupied = 0

        new_occupied = node.occupied
        if np.all(actual_update == int(node_size)):
            new_occupied = U64_MAX
        else:
            for sectant in _visit_sectants(node_min, node_size, pos, insert_size):
                if not self.node_empty_at(key, sectant):
                    new_occupied |= 1 << sectant

        if new_occupied == U64_MAX:
            self._set_sibling_occlusions(node_min, node_size, True)
        node.occupied = new_occupied
        self.update_mip(key, node_min, node_size, pos)

    # ------------------------------------------------------------------
    # clear
    # ------------------------------------------------------------------

    def clear(self, position) -> None:
        self.clear_at_lod(position, 1)

    def clear_at_lod(self, position, clear_size: int) -> None:
        root_min, root_size = self._root_bounds()
        pos = np.asarray(position, dtype=np.int64)
        if not cube_contains(root_min, root_size, pos):
            raise ValueError(f"position {position} outside tree of size {self.size}")
        if clear_size == 0:
            return

        node_stack = [(self.ROOT, offset_sectant(pos - root_min, root_size))]
        bounds_stack = [(root_min, root_size)]
        erased_whole_sectants: list[int] = []
        modified_bottom_sectants: list[int] = []
        actual_update = np.zeros(3, dtype=np.int64)
        updated = False

        while True:
            key, target_sectant = node_stack[-1]
            cur_min, cur_size = bounds_stack[-1]
            tmin, tsize = child_bounds_for(cur_min, cur_size, target_sectant)
            tmin = tmin.astype(np.float64)
            node = self.node(key)
            target_child = node.child(target_sectant)

            # whole-node erase fast path
            if (
                clear_size > 1
                and tsize <= clear_size
                and np.all(pos <= tmin)
                and node.ntype == INTERNAL
            ):
                cells, actual_update = _visit_cells(cur_min, cur_size, pos, clear_size)
                for cpos, csize_vec, sectant, cmin, csize in cells:
                    if not (
                        np.array_equal(cpos, cmin.astype(np.int64))
                        and np.all(csize_vec == int(csize))
                    ):
                        continue
                    child_key = self.node(key).child(sectant)
                    if self.key_is_valid(child_key):
                        updated = True
                        self.deallocate_children_of(child_key)
                        child = self.node(child_key)
                        child.ntype = NOTHING
                        child.bricks = None
                        child.children = None
                        erased_whole_sectants.append(sectant)
                break

            if tsize > max(clear_size, self.brick_dim) or self.key_is_valid(target_child):
                if self.key_is_valid(target_child):
                    node_stack.append((target_child, offset_sectant(pos - tmin, tsize)))
                    bounds_stack.append((tmin, tsize))
                elif node.ntype in (LEAF, UNIFORM):
                    d = self.brick_dim
                    target_match = False
                    if node.ntype == UNIFORM:
                        brick = node.bricks
                        if brick is None:
                            target_match = True
                        elif isinstance(brick, (int, np.integer)):
                            target_match = self.pix_points_to_empty(int(brick))
                        else:
                            rel = (pos - cur_min.astype(np.int64)).astype(np.int64)
                            target_match = self.pix_points_to_empty(
                                int(brick[flat_projection(int(rel[0]), int(rel[1]), int(rel[2]), d)])
                            )
                    else:
                        brick = node.bricks[target_sectant]
                        if brick is None:
                            target_match = True
                        elif isinstance(brick, (int, np.integer)):
                            target_match = self.pix_points_to_empty(int(brick))
                        else:
                            rel = (pos - cur_min.astype(np.int64)).astype(np.int64)
                            target_match = self.pix_points_to_empty(
                                int(brick[flat_projection(int(rel[0]), int(rel[1]), int(rel[2]), d)])
                            )
                    if target_match or self._content_is_empty(key):
                        break
                    self.subdivide_leaf_to_nodes(key, target_sectant)
                    child_key = self.node(key).child(target_sectant)
                    node_stack.append((child_key, offset_sectant(pos - tmin, tsize)))
                    bounds_stack.append((tmin, tsize))
                else:
                    break  # nothing to clear
            else:
                cells, actual_update = _visit_cells(cur_min, cur_size, pos, clear_size)
                for cpos, csize_vec, sectant, cmin, csize in cells:
                    updated |= self.leaf_update(
                        True,
                        key,
                        cur_min,
                        cur_size,
                        cmin,
                        csize,
                        sectant,
                        cpos,
                        csize_vec,
                        EMPTY_VOXEL,
                    )
                    modified_bottom_sectants.append(sectant)
                break

        if not updated:
            return

        access_stack = list(node_stack)
        simplifyable = self.auto_simplify

        bottom_key, _ = node_stack[-1]
        bottom_min, bottom_size = bounds_stack[-1]
        for sectant in modified_bottom_sectants:
            child_key = self.node(bottom_key).child(sectant)
            if self.key_is_valid(child_key):
                cmin, csize = child_bounds_for(bottom_min, bottom_size, sectant)
                self._post_process_clear(child_key, cmin, csize, actual_update, pos, clear_size, [])
            else:
                self._post_process_clear(
                    bottom_key, bottom_min, bottom_size, actual_update, pos, clear_size, []
                )
            if simplifyable:
                simplifyable &= self.simplify(child_key, False)

        while node_stack:
            key, _ = node_stack[-1]
            bmin, bsize = bounds_stack[-1]
            depleted = self._post_process_clear(
                key, bmin, bsize, actual_update, pos, clear_size, erased_whole_sectants
            )
            # a depleted node must be reported to its PARENT at the node's
            # sectant within the parent — i.e. the parent's stored path
            # sectant, NOT offset_sectant in this node's own frame (which
            # could name, and free, an unrelated occupied sibling)
            erased_whole_sectants = (
                [node_stack[-2][1]] if depleted and len(node_stack) >= 2 else []
            )
            if simplifyable:
                simplifyable = self.simplify(key, True)
            node_stack.pop()
            bounds_stack.pop()

        for trigger in self.update_triggers:
            trigger(access_stack, erased_whole_sectants + modified_bottom_sectants)

    def _post_process_clear(
        self, key, node_min, node_size, actual_update, pos, clear_size, removed_children
    ) -> bool:
        """Post-clear fix-up; returns True when the node became empty."""
        if not self.key_is_valid(key):
            return True
        node = self.node(key)

        for sectant in removed_children:
            child_key = node.child(sectant)
            if self.key_is_valid(child_key):
                if self.node(child_key).occupied == U64_MAX:
                    cmin, csize = child_bounds_for(node_min, node_size, sectant)
                    self._set_sibling_occlusions(cmin, csize, False)
                self._free_node(child_key)
            if node.children is not None:
                node.children[sectant] = EMPTY_KEY

        new_occupied = node.occupied
        if np.all(actual_update == int(node_size)) and np.array_equal(
            np.asarray(node_min, dtype=np.int64), pos
        ):
            new_occupied = 0
        else:
            for sectant in _visit_sectants(node_min, node_size, pos, clear_size):
                if self.node_empty_at(key, sectant):
                    new_occupied &= ~(1 << sectant)

        if new_occupied == 0:
            self.deallocate_children_of(key)
            node.children = None
            node.ntype = NOTHING
            node.bricks = None

        if node.occupied == U64_MAX and new_occupied != U64_MAX:
            self._set_sibling_occlusions(node_min, node_size, False)
        node.occupied = new_occupied
        self.update_mip(key, node_min, node_size, pos)
        return new_occupied == 0
