"""Flat arrays of a boxtree (NumPy): the snapshot that the BitGrid is built
from, the port's copy of ``FlatTree`` and ``flatten`` of the reference's
``voxelhex_tpu/tree/flat.py``.

* ``node_meta     uint32[N]``     — bit 0: is-leaf, bit 1: is-uniform
* ``node_children int32[N, 64]``  — internal: child node key (-1 none);
  leaf: a brick descriptor a sectant; uniform: its descriptor in all 64
* ``node_ocbits   uint32[N, 2]``  — 64-bit sectant occupancy as (lo, hi)
* ``node_mips     int32[N]``      — MIP brick descriptor (-1 none)
* ``bricks        int32[B, d^3]`` — the brick pool; a voxel is -1 (empty),
  a palette index, or ``NO_COLOR_HIT`` (occupied, data only)
* ``palette       float32[P, 4]`` — RGBA in [0, 1]
* ``brick_ocbits  uint32[B, 2]``  — each brick's 4x4x4 occupancy

A brick descriptor (int32) is -1 for empty, ``SOLID_FLAG | value`` for a
solid brick, else an index into the brick pool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from voxelhex_tpu_torch.constants import (
    BOX_NODE_CHILDREN_COUNT,
    EMPTY_DESC,
    EMPTY_U16,
    NO_COLOR_HIT,
    SOLID_FLAG,
)
from voxelhex_tpu_torch.spatial.math import brick_occupied_bits_many
from voxelhex_tpu_torch.tree.boxtree import (
    INTERNAL,
    LEAF,
    UNIFORM,
    BoxTree,
    pix_color_index,
)

META_LEAF = 1
META_UNIFORM = 2

# the arrays of a FlatTree, in the order of its fields
ARRAYS = ("node_meta", "node_children", "node_ocbits", "node_mips", "bricks", "palette",
          "brick_ocbits")


@dataclass
class FlatTree:
    """Flat snapshot of a boxtree; every array is NumPy."""

    size: int
    brick_dim: int
    node_meta: np.ndarray  # uint32[N]
    node_children: np.ndarray  # int32[N, 64]
    node_ocbits: np.ndarray  # uint32[N, 2]
    node_mips: np.ndarray  # int32[N]
    bricks: np.ndarray  # int32[B, d^3]
    palette: np.ndarray  # float32[P, 4]
    # each brick's 64-bit occupancy (4x4x4 downsample) as (lo, hi) words;
    # for brick_dim <= 4 it is the voxels' own occupancy
    brick_ocbits: np.ndarray = None  # uint32[B, 2]

    @property
    def n_nodes(self) -> int:
        return int(self.node_meta.shape[0])

    @property
    def n_bricks(self) -> int:
        return int(self.bricks.shape[0])


def _voxelize_packed(tree: BoxTree, packed_arr: np.ndarray) -> np.ndarray:
    """Packed palette values as flat voxel values, emptiness resolved."""
    empty = tree._brick_empty_mask(packed_arr.astype(np.uint32))
    ci = (packed_arr & 0xFFFF).astype(np.int64)
    out = np.where(ci == EMPTY_U16, NO_COLOR_HIT, ci).astype(np.int32)
    out[empty] = EMPTY_DESC
    return out


def _solid_value(tree: BoxTree, packed: int) -> int:
    """Flat voxel value of a solid brick's packed voxel."""
    if tree.pix_points_to_empty(packed):
        return EMPTY_DESC
    ci = pix_color_index(packed)
    return NO_COLOR_HIT if ci == EMPTY_U16 else ci


def flatten(tree: BoxTree) -> FlatTree:
    """Snapshot a boxtree into flat arrays.

    Node keys are renumbered densely in depth-first order from the root
    (the tree's pool may have holes from freed nodes); the root is 0."""
    keymap: dict[int, int] = {}
    order: list[int] = []

    def discover(key):
        if key in keymap:
            return
        keymap[key] = len(order)
        order.append(key)
        node = tree.node(key)
        if node.ntype == INTERNAL and node.children is not None:
            for child in node.children:
                if tree.key_is_valid(child):
                    discover(child)

    discover(tree.ROOT)

    n = len(order)
    d = tree.brick_dim
    node_meta = np.zeros(n, dtype=np.uint32)
    node_children = np.full((n, BOX_NODE_CHILDREN_COUNT), EMPTY_DESC, dtype=np.int32)
    node_ocbits = np.zeros((n, 2), dtype=np.uint32)
    node_mips = np.full(n, EMPTY_DESC, dtype=np.int32)
    brick_list: list[np.ndarray] = []

    def brick_descriptor(brick) -> int:
        if brick is None:
            return EMPTY_DESC
        if isinstance(brick, (int, np.integer)):
            sv = _solid_value(tree, int(brick))
            return EMPTY_DESC if sv == EMPTY_DESC else SOLID_FLAG | sv
        brick_list.append(brick)  # raw packed values, voxelized in one batch
        return len(brick_list) - 1

    for host_key in order:
        key = keymap[host_key]
        node = tree.node(host_key)
        node_ocbits[key, 0] = node.occupied & 0xFFFFFFFF
        node_ocbits[key, 1] = (node.occupied >> 32) & 0xFFFFFFFF
        if node.mip is not None:
            node_mips[key] = brick_descriptor(node.mip)
        if node.ntype == INTERNAL:
            if node.children is not None:
                for s, child in enumerate(node.children):
                    if tree.key_is_valid(child):
                        node_children[key, s] = keymap[child]
        elif node.ntype == LEAF:
            node_meta[key] = META_LEAF
            for s in range(BOX_NODE_CHILDREN_COUNT):
                node_children[key, s] = brick_descriptor(node.bricks[s])
        elif node.ntype == UNIFORM:
            node_meta[key] = META_LEAF | META_UNIFORM
            node_children[key, :] = brick_descriptor(node.bricks)
        # NOTHING: all defaults

    if brick_list:
        bricks = _voxelize_packed(tree, np.stack(brick_list).astype(np.uint32))
    else:
        bricks = np.zeros((0, d**3), dtype=np.int32)

    bits = brick_occupied_bits_many(bricks != EMPTY_DESC)
    brick_ocbits = np.stack(
        [(bits & np.uint64(0xFFFFFFFF)).astype(np.uint32),
         (bits >> np.uint64(32)).astype(np.uint32)],
        axis=1,
    )

    palette = np.zeros((max(1, len(tree.color_palette)), 4), dtype=np.float32)
    for i, c in enumerate(tree.color_palette):
        palette[i] = [c.r / 255.0, c.g / 255.0, c.b / 255.0, c.a / 255.0]

    return FlatTree(
        size=tree.size,
        brick_dim=d,
        node_meta=node_meta,
        node_children=node_children,
        node_ocbits=node_ocbits,
        node_mips=node_mips,
        bricks=bricks.astype(np.int32),
        palette=palette,
        brick_ocbits=brick_ocbits,
    )
