"""The port's native (C++) single-voxel / LOD edit engine.

``NativeEditTree`` mirrors the edit surface of :class:`BoxTree` (insert /
update / insert_at_lod / clear / clear_at_lod / get, their batches and
queries) at native latency, for edit-heavy workloads.  Its library is the
port's ``host/tree_edit.cpp``, built by :func:`voxelhex_tpu_torch.native.
edit_library` at first use; a failed build raises, and there is no Python
fallback.  Semantics are :class:`BoxTree`'s, held to it by differential
tests (``tests/test_torch_native_edit.py``), the brick_dim 1 invariant
breaks of ``insert_at_lod`` included; palettes and user data stay on the
Python side, the engine works in packed u32 palette-index values.

MIP maps and update triggers are not kept here (use the Python tree for
those); the engine reports the last access stack and modified sectants
(:meth:`NativeEditTree.last_access`), so a caller can forward triggers.
"""

from __future__ import annotations

import ctypes

import numpy as np

from voxelhex_tpu_torch import native
from voxelhex_tpu_torch.constants import EMPTY_U16, EMPTY_VOXEL
from voxelhex_tpu_torch.tree.boxtree import (
    EMPTY_ENTRY,
    INTERNAL,
    LEAF,
    UNIFORM,
    Albedo,
    BoxTree,
    Entry,
    _data_is_empty,
    _Node,
    pix_color_index,
    pix_complex,
    pix_data_index,
    pix_informal,
    pix_visual,
)


class NativeEditTree:
    """C++-backed 64-tree with BoxTree-compatible edit semantics."""

    def __init__(self, size: int, brick_dim: int = 32, auto_simplify: bool = True):
        if brick_dim <= 0 or (brick_dim & (brick_dim - 1)) != 0:
            raise ValueError(f"brick_dim must be a power of two, got {brick_dim}")
        ratio = size / brick_dim if brick_dim else 0
        k = np.log(ratio) / np.log(4.0) if ratio > 0 else -1
        if size <= 0 or ratio <= 0 or abs(k - round(k)) > 1e-9:
            raise ValueError(f"size must be brick_dim * 4**k, got size={size}")
        if size < brick_dim * 4:
            raise ValueError("size must be at least 4 * brick_dim")
        self._lib = lib = native.edit_library()
        self.size = int(size)
        self.brick_dim = int(brick_dim)
        self.auto_simplify = bool(auto_simplify)
        self._ptr = lib.edit_tree_new(size, brick_dim, 1 if auto_simplify else 0)
        self.color_palette: list[Albedo] = []
        self.data_palette: list[object] = []
        self._color_map: dict[Albedo, int] = {}
        self._data_map: dict[object, int] = {}
        self._synced = (0, 0)  # palette entries the engine has been handed
        self._color_empty = bytearray()  # per color entry: transparent
        self._data_empty = bytearray()  # per data entry: empty

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.edit_tree_free(ptr)
            self._ptr = None

    # ---------------------------------------------------------- palettes
    def _intern_color(self, albedo: Albedo) -> int:
        idx = self._color_map.get(albedo)
        if idx is None:
            idx = len(self.color_palette)
            assert idx < EMPTY_U16, "color palette overflow"
            self._color_map[albedo] = idx
            self.color_palette.append(albedo)
        return idx

    def _intern_data(self, data) -> int:
        idx = self._data_map.get(data)
        if idx is None:
            idx = len(self.data_palette)
            assert idx < EMPTY_U16, "data palette overflow"
            self._data_map[data] = idx
            self.data_palette.append(data)
        return idx

    def add_to_palette(self, entry: Entry) -> int:
        albedo, data = entry.albedo, entry.data
        has_color = albedo is not None and not albedo.is_zero
        has_data = data is not None and not _data_is_empty(data)
        if has_color and has_data:
            packed = pix_complex(self._intern_color(albedo), self._intern_data(data))
        elif has_color:
            packed = pix_visual(self._intern_color(albedo))
        elif has_data:
            packed = pix_informal(self._intern_data(data))
        else:
            packed = EMPTY_VOXEL
        self._sync_palette()
        return packed

    def _sync_palette(self):
        """Hand the engine each palette entry's emptiness.  The tables grow
        with the palettes (entries are only ever appended), so a sync adds
        the new entries' flags instead of re-deriving every entry's."""
        want = (len(self.color_palette), len(self.data_palette))
        if want == self._synced:
            return
        nc, nd = self._synced
        self._color_empty.extend(int(c.is_transparent) for c in self.color_palette[nc:])
        self._data_empty.extend(int(_data_is_empty(d)) for d in self.data_palette[nd:])
        ce = np.frombuffer(bytes(self._color_empty), dtype=np.uint8)
        de = np.frombuffer(bytes(self._data_empty), dtype=np.uint8)
        self._lib.edit_tree_set_palette(self._ptr, ce, ce.size, de, de.size)
        self._synced = want

    # --------------------------------------------------------------- edits
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

    def _check(self, position):
        x, y, z = (int(c) for c in position)
        if not (0 <= x < self.size and 0 <= y < self.size and 0 <= z < self.size):
            raise ValueError(f"position {position} outside tree of size {self.size}")
        return x, y, z

    def insert(self, position, entry) -> None:
        self.insert_at_lod(position, 1, entry)

    def update(self, position, entry) -> None:
        x, y, z = self._check(position)
        e = self._coerce_entry(entry)
        if e.is_none:
            return
        packed = self.add_to_palette(e)
        self._lib.edit_tree_insert(self._ptr, x, y, z, 1, packed, 0)

    def insert_at_lod(self, position, size: int, entry) -> None:
        x, y, z = self._check(position)
        e = self._coerce_entry(entry)
        if e.is_none or size == 0:
            return
        packed = self.add_to_palette(e)
        self._lib.edit_tree_insert(self._ptr, x, y, z, int(size), packed, 1)

    def clear(self, position) -> None:
        self.clear_at_lod(position, 1)

    def clear_at_lod(self, position, size: int) -> None:
        x, y, z = self._check(position)
        if size == 0:
            return
        self._lib.edit_tree_clear(self._ptr, x, y, z, int(size))

    def insert_batch(self, positions, colors, overwrite: bool = True) -> int:
        """Apply N single-voxel inserts in one native call.

        ``positions`` int [N,3]; ``colors`` uint8 [N,4] RGBA (interned into
        the shared palette, vectorized).  Returns the number of inserts that
        changed the tree.  ~4x the per-op wrapper (one binding crossing)."""
        pos = np.ascontiguousarray(positions, dtype=np.int64).reshape(-1, 3)
        cols = np.asarray(colors, dtype=np.uint8).reshape(-1, 4)
        if not (
            (pos >= 0).all() and (pos < self.size).all()
        ):
            raise ValueError("positions outside tree")
        # vectorized palette interning: unique colors once, map to indices;
        # intern in FIRST-APPEARANCE order so the palette matches what
        # sequential per-op inserts would build (interchangeable results)
        uniq, first_idx, inverse = np.unique(
            cols, axis=0, return_index=True, return_inverse=True
        )
        idx_of = np.empty(len(uniq), dtype=np.uint32)
        for i in np.argsort(first_idx):
            a = Albedo(*(int(v) for v in uniq[i]))
            if a.is_transparent:
                # transparent entries are no-ops in the insert path
                # (Entry.is_none), matching BoxTree.insert
                idx_of[i] = 0xFFFFFFFF
            else:
                idx_of[i] = pix_visual(self._intern_color(a))
        self._sync_palette()
        packed = idx_of[inverse]
        keep = packed != np.uint32(0xFFFFFFFF)
        pos, packed = pos[keep], packed[keep]
        return int(self._lib.edit_tree_insert_batch(
            self._ptr, np.ascontiguousarray(pos.reshape(-1)),
            np.ascontiguousarray(packed, dtype=np.uint32),
            len(packed), 1 if overwrite else 0,
        ))

    def clear_batch(self, positions) -> int:
        pos = np.ascontiguousarray(positions, dtype=np.int64).reshape(-1, 3)
        if not ((pos >= 0).all() and (pos < self.size).all()):
            raise ValueError("positions outside tree")
        return int(self._lib.edit_tree_clear_batch(
            self._ptr, np.ascontiguousarray(pos.reshape(-1)), len(pos)
        ))

    def get_packed_batch(self, positions) -> np.ndarray:
        pos = np.ascontiguousarray(positions, dtype=np.int64).reshape(-1, 3)
        out = np.empty(len(pos), dtype=np.uint32)
        self._lib.edit_tree_get_batch(
            self._ptr, np.ascontiguousarray(pos.reshape(-1)), len(pos), out
        )
        return out

    # -------------------------------------------------------------- queries
    def get_packed(self, position) -> int:
        x, y, z = (int(c) for c in position)
        if not (0 <= x < self.size and 0 <= y < self.size and 0 <= z < self.size):
            return EMPTY_VOXEL
        return int(self._lib.edit_tree_get(self._ptr, x, y, z))

    def entry_for(self, packed: int) -> Entry:
        ci, di = pix_color_index(packed), pix_data_index(packed)
        albedo = self.color_palette[ci] if ci != EMPTY_U16 else None
        data = self.data_palette[di] if di != EMPTY_U16 else None
        if albedo is None and data is None:
            return EMPTY_ENTRY
        return Entry(albedo=albedo, data=data)

    def get(self, position) -> Entry:
        packed = self.get_packed(position)
        return self.entry_for(packed) if packed != EMPTY_VOXEL else EMPTY_ENTRY

    @property
    def node_count(self) -> int:
        return int(self._lib.edit_tree_node_count(self._ptr))

    # -------------------------------------------------- structure inspection
    def node_info(self, key: int):
        """(type, occupied, occlusion, children[64]) or None for freed slots."""
        t = ctypes.c_uint8()
        occ = ctypes.c_uint64()
        ocl = ctypes.c_uint8()
        children = np.empty(64, dtype=np.int32)
        ok = self._lib.edit_tree_node_info(
            self._ptr, key, ctypes.byref(t), ctypes.byref(occ),
            ctypes.byref(ocl), children,
        )
        if not ok:
            return None
        return int(t.value), int(occ.value), int(ocl.value), children

    def node_brick(self, key: int, sectant: int = -1):
        """Brick at a LEAF sectant (or the UNIFORM brick for sectant=-1):
        None / int (solid) / u32 array (parted)."""
        out = np.empty(self.brick_dim**3, dtype=np.uint32)
        kind = self._lib.edit_tree_node_brick(self._ptr, key, sectant, out)
        if kind == 0:
            return None
        if kind == 1:
            return int(out[0])
        return out

    @property
    def slot_count(self) -> int:
        return int(self._lib.edit_tree_slot_count(self._ptr))

    @classmethod
    def from_boxtree(cls, tree) -> "NativeEditTree":
        """Mirror an existing Python :class:`BoxTree` into a native engine
        (same node keys, bricks, occupancy, occlusion, palettes) — e.g. a
        bulk-imported scene handed over for latency-critical editing."""
        nat = cls(tree.size, tree.brick_dim, auto_simplify=tree.auto_simplify)
        nat.color_palette = list(tree.color_palette)
        nat.data_palette = list(tree.data_palette)
        nat._color_map = dict(tree._color_map)
        nat._data_map = dict(tree._data_map)
        nat._sync_palette()

        lib, ptr = nat._lib, nat._ptr
        lib.edit_tree_load_reserve(ptr, len(tree._nodes))
        no_children = np.full(64, -1, dtype=np.int32)
        solid_buf = np.zeros(1, dtype=np.uint32)
        for key, node in enumerate(tree._nodes):
            if node is None:
                continue
            if node.ntype == INTERNAL and node.children is not None:
                kids = np.asarray(node.children, dtype=np.int32)
            else:
                kids = no_children
            lib.edit_tree_load_node(
                ptr, key, node.ntype, node.occupied, node.occlusion,
                np.ascontiguousarray(kids),
            )
            bricks = (
                [(s, node.bricks[s]) for s in range(64)]
                if node.ntype == LEAF
                else [(-1, node.bricks)] if node.ntype == UNIFORM
                else []
            )
            for sectant, brick in bricks:
                if brick is None:
                    continue
                if isinstance(brick, (int, np.integer)):
                    solid_buf[0] = np.uint32(brick)
                    lib.edit_tree_load_brick(ptr, key, sectant, 1, solid_buf)
                else:
                    lib.edit_tree_load_brick(
                        ptr, key, sectant, 2,
                        np.ascontiguousarray(brick, dtype=np.uint32),
                    )
        lib.edit_tree_load_finish(ptr)
        return nat

    def to_boxtree(self):
        """Convert to a Python :class:`BoxTree` (same structure, occupancy,
        occlusion, palettes) — the bridge to flatten()/renderers/checkpoints."""
        out = BoxTree(self.size, self.brick_dim, auto_simplify=self.auto_simplify)
        out.color_palette = list(self.color_palette)
        out.data_palette = list(self.data_palette)
        out._color_map = dict(self._color_map)
        out._data_map = dict(self._data_map)

        def convert(nat_key: int) -> int:
            info = self.node_info(nat_key)
            assert info is not None
            ntype, occupied, occlusion, children = info
            node = _Node()
            node.ntype = ntype
            node.occupied = occupied
            node.occlusion = occlusion
            if ntype == INTERNAL:
                kids = [-1] * 64
                for s in range(64):
                    nc = int(children[s])
                    if nc >= 0 and self.node_info(nc) is not None:
                        kids[s] = convert(nc)
                node.children = kids
            elif ntype == LEAF:
                node.bricks = [self.node_brick(nat_key, s) for s in range(64)]
            elif ntype == UNIFORM:
                node.bricks = self.node_brick(nat_key, -1)
            if nat_key == 0:
                out._nodes[0] = node
                return 0
            return out._push_node(node)

        convert(0)
        return out

    def last_access(self):
        """(access_stack, modified_sectants) of the last edit — the update
        trigger payload of the Python tree."""
        stack = np.empty(64, dtype=np.int32)
        sect = np.empty(256, dtype=np.int32)
        n1 = self._lib.edit_tree_last_stack(self._ptr, stack, 64)
        n2 = self._lib.edit_tree_last_sectants(self._ptr, sect, 256)
        return [int(k) for k in stack[:n1]], [int(s) for s in sect[:n2]]
