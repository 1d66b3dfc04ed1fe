"""Bulk construction of a boxtree from point voxels, the port's copy of the
reference's ``voxelhex_tpu/tree/build.py``.

The whole voxel cloud is grouped into bricks and tree levels at once (the
grouping in the host library, :mod:`voxelhex_tpu_torch.native`, or in NumPy
when the caller asks), giving the structures the incremental path would:
LEAF nodes of parted bricks with their occupancy bits, INTERNAL nodes above,
then one recursive ``simplify`` pass.
"""

from __future__ import annotations

import numpy as np

from voxelhex_tpu_torch import native as _native
from voxelhex_tpu_torch.constants import BOX_NODE_CHILDREN_COUNT, EMPTY_U16, EMPTY_VOXEL
from voxelhex_tpu_torch.spatial.math import child_bounds_for, offset_sectant
from voxelhex_tpu_torch.tree import mipmap
from voxelhex_tpu_torch.tree.boxtree import (
    INTERNAL,
    LEAF,
    NOTHING,
    U64_MAX,
    UNIFORM,
    Albedo,
    BoxTree,
    _Node,
)


def intern_colors(tree: BoxTree, colors: np.ndarray) -> np.ndarray:
    """Dedup (N,4) uint8 RGBA rows into the tree palette; returns packed
    voxel values (N,) uint32."""
    colors = np.ascontiguousarray(np.asarray(colors, dtype=np.uint8).reshape(-1, 4))
    # dedup on a u32 view of the RGBA rows: scalar unique is ~10x faster
    # than row-wise (lexsort) unique at millions of voxels
    as_u32 = colors.view(np.uint32).ravel()
    uniq32, inverse = np.unique(as_u32, return_inverse=True)
    uniq = uniq32.view(np.uint8).reshape(-1, 4)
    idx_of_uniq = np.empty(len(uniq), dtype=np.int64)
    for i, row in enumerate(uniq):
        albedo = Albedo(int(row[0]), int(row[1]), int(row[2]), int(row[3]))
        if albedo.is_zero:
            idx_of_uniq[i] = -1
        else:
            idx_of_uniq[i] = tree._intern_color(albedo)
    packed = np.where(
        idx_of_uniq[inverse] >= 0,
        (idx_of_uniq[inverse] & 0xFFFF) | (EMPTY_U16 << 16),
        EMPTY_VOXEL,
    ).astype(np.uint32)
    return packed


def from_voxels(
    positions: np.ndarray,
    colors: np.ndarray,
    size: int,
    brick_dim: int = 32,
    simplify: bool = True,
    tree: BoxTree | None = None,
    native: bool = True,
) -> BoxTree:
    """Build a BoxTree from point voxels.

    * ``positions`` — (N,3) integer voxel coordinates in [0, size)
    * ``colors`` — (N,4) uint8 RGBA (alpha 0 = empty, skipped)
    * duplicate positions: the last occurrence wins
    * ``tree`` — add to this tree (its palette keeps its entries first)
    * ``native`` — group the voxels into bricks in the host library (a
      failed build raises); ``False`` groups them in NumPy, the plain
      version the tests hold the library to
    """
    if tree is None:
        tree = BoxTree(size, brick_dim, auto_simplify=simplify)
    d = tree.brick_dim
    size = tree.size

    positions = np.asarray(positions, dtype=np.int64).reshape(-1, 3)
    if len(positions) == 0:
        return tree
    if positions.min() < 0 or positions.max() >= size:
        raise ValueError("voxel positions out of tree bounds")

    packed = intern_colors(tree, colors)
    keep = packed != EMPTY_VOXEL
    positions, packed = positions[keep], packed[keep]
    if len(positions) == 0:
        return tree

    cpa = size // d  # cells per axis

    if native:
        grouped = _native.bulk_group(positions, packed, size, d, EMPTY_VOXEL)
        # one native pass: sort+dedup (last wins), brick fill, occupancy,
        # solid detection
        uniq_cells, bricks, _occ_u64, solid_full = grouped
        occ_nonzero = np.ones(len(uniq_cells), dtype=bool)
        solid = solid_full if simplify else np.zeros(len(bricks), dtype=bool)
        solid_empty = np.zeros(len(bricks), dtype=bool)
    else:
        # deduplicate (last wins)
        lin = (positions[:, 0] + positions[:, 1] * size
               + positions[:, 2] * size * size)
        # np.unique keeps the first occurrence; reverse so the last wins
        _, first_idx = np.unique(lin[::-1], return_index=True)
        sel = len(lin) - 1 - first_idx
        positions, packed = positions[sel], packed[sel]

        # group into bricks
        cells = positions // d
        within = positions % d
        flat_in_brick = within[:, 0] + within[:, 1] * d + within[:, 2] * d * d
        cell_id = cells[:, 0] + cells[:, 1] * cpa + cells[:, 2] * cpa * cpa
        uniq_cells, inverse = np.unique(cell_id, return_inverse=True)
        bricks = np.full((len(uniq_cells), d**3), EMPTY_VOXEL, dtype=np.uint32)
        bricks[inverse, flat_in_brick] = packed

        # every interned value is non-empty by construction (zero-alpha
        # colors map to EMPTY_VOXEL in intern_colors and were filtered
        # above), so the palette-alpha walk of _brick_empty_mask is
        # unnecessary here
        empty_mask = bricks == EMPTY_VOXEL
        occ_nonzero = ~empty_mask.all(axis=1)

        # vectorized solid-brick collapse (same result as brick_simplify on
        # every brick: all-equal values -> Solid int / Empty)
        if simplify:
            eq = (bricks == bricks[:, :1]).all(axis=1)
            solid_empty = eq & empty_mask[:, 0]
            solid = eq & ~empty_mask[:, 0]
        else:
            solid = solid_empty = np.zeros(len(bricks), dtype=bool)

    # brick cell coordinates
    bx = uniq_cells % cpa
    by = (uniq_cells // cpa) % cpa
    bz = uniq_cells // (cpa * cpa)

    # leaf-level nodes cover 4 bricks per axis
    leaf_grid = np.stack([bx // 4, by // 4, bz // 4], axis=1)
    sectants = (bx % 4) + (by % 4) * 4 + (bz % 4) * 16

    lpa = max(cpa // 4, 1)  # leaf nodes per axis
    leaf_ids = leaf_grid[:, 0] + leaf_grid[:, 1] * lpa + leaf_grid[:, 2] * lpa * lpa
    uniq_leaves, leaf_inv = np.unique(leaf_ids, return_inverse=True)
    sect_bits = np.where(
        occ_nonzero, np.uint64(1) << sectants.astype(np.uint64), np.uint64(0)
    )
    leaf_occ = np.zeros(len(uniq_leaves), dtype=np.uint64)
    np.bitwise_or.at(leaf_occ, leaf_inv, sect_bits)

    leaf_nodes: dict[tuple, int] = {}
    node_objs = []
    for j, lid in enumerate(uniq_leaves):
        node = _Node()
        node.ntype = LEAF
        node.bricks = [None] * BOX_NODE_CHILDREN_COUNT
        node.occupied = int(leaf_occ[j])
        key = tree._push_node(node)
        lg = (int(lid % lpa), int((lid // lpa) % lpa), int(lid // (lpa * lpa)))
        leaf_nodes[lg] = key
        node_objs.append(node)
    for i in range(len(uniq_cells)):
        if solid_empty[i]:
            continue
        node_objs[leaf_inv[i]].bricks[int(sectants[i])] = (
            int(bricks[i, 0]) if solid[i] else bricks[i]
        )

    # build internal levels bottom-up; level L has extent 4d per node
    levels = 0
    extent = 4 * d
    while extent < size:
        extent *= 4
        levels += 1
    # levels = number of internal levels above the leaf level

    current = leaf_nodes  # grid coords -> key at the current level
    for _ in range(levels):
        parents: dict[tuple, int] = {}
        for (gx, gy, gz), child_key in current.items():
            pg = (gx // 4, gy // 4, gz // 4)
            pkey = parents.get(pg)
            if pkey is None:
                node = _Node()
                node.ntype = INTERNAL
                pkey = tree._push_node(node)
                parents[pg] = pkey
            pnode = tree.node(pkey)
            sectant = (gx % 4) + (gy % 4) * 4 + (gz % 4) * 16
            pnode.set_child(sectant, child_key)
            if tree.node(child_key).occupied != 0:
                pnode.occupied |= 1 << sectant
        current = parents

    assert len(current) <= 1
    if current:
        top_key = next(iter(current.values()))
        top = tree.node(top_key)
        root = tree.node(tree.ROOT)
        root.ntype = top.ntype
        root.children = top.children
        root.bricks = top.bricks
        root.occupied = top.occupied
        tree._free_node(top_key)

    if simplify:
        tree.simplify(tree.ROOT, recursive=True)
    if tree.mip_strategy is not None:
        mipmap.recalculate_mips(tree)
    return tree


def insert_many(tree: BoxTree, positions: np.ndarray, colors: np.ndarray) -> int:
    """Batched point inserts into an EXISTING tree — the edit-queue analog of
    VoxelHex's per-voxel import loop (insert semantics: overwrite;
    duplicates last-wins).

    One tree descent per touched brick instead of one per voxel, vectorized
    brick scatters, and a single bottom-up post-process (occupancy, MIP
    texels, occlusion, simplify) — same final content as calling
    ``tree.insert`` per voxel, at bulk-build cost.  Fires one
    ``update_trigger`` per touched bottom node so streaming invalidation
    sees the same signals.  Unusual structures (nodes subdivided below
    brick size) fall back to per-voxel ``insert``.  Returns the number of
    voxels written.
    """
    d = tree.brick_dim
    size = tree.size
    positions = np.asarray(positions, dtype=np.int64).reshape(-1, 3)
    if len(positions) == 0:
        return 0
    if positions.min() < 0 or positions.max() >= size:
        raise ValueError("voxel positions out of tree bounds")
    packed = intern_colors(tree, colors)
    keep = packed != EMPTY_VOXEL
    positions, packed = positions[keep], packed[keep]
    if len(positions) == 0:
        return 0

    # dedup, last wins
    lin = positions[:, 0] + positions[:, 1] * size + positions[:, 2] * size * size
    _, first_idx = np.unique(lin[::-1], return_index=True)
    sel = len(lin) - 1 - first_idx
    positions, packed = positions[sel], packed[sel]

    # group by brick cell
    cells = positions // d
    cpa = size // d
    cell_id = cells[:, 0] + cells[:, 1] * cpa + cells[:, 2] * cpa * cpa
    order = np.argsort(cell_id, kind="stable")
    positions, packed, cell_id, cells = (
        positions[order], packed[order], cell_id[order], cells[order]
    )
    group_bounds = np.nonzero(np.diff(cell_id))[0] + 1
    groups = np.split(np.arange(len(cell_id)), group_bounds)

    within = positions % d
    flat_in_brick = within[:, 0] + within[:, 1] * d + within[:, 2] * d * d

    written = 0
    touched = []  # (access_stack, bottom_key, bottom_min, bottom_size, sectant, cell_min)
    for g in groups:
        pos0 = positions[g[0]].astype(np.float64)
        # descend, creating/subdividing exactly like _insert_at_lod_internal
        key = tree.ROOT
        cur_min = np.zeros(3, dtype=np.float64)
        cur_size = float(size)
        stack = []
        fallback = False
        while True:
            sectant = offset_sectant(pos0 - cur_min, cur_size)
            stack.append((key, sectant))
            tmin, tsize = child_bounds_for(cur_min, cur_size, sectant)
            node = tree.node(key)
            child = node.child(sectant)
            if tsize > d:
                if tree.key_is_valid(child):
                    key, cur_min, cur_size = child, tmin.astype(np.float64), tsize
                    continue
                if node.ntype in (LEAF, UNIFORM):
                    tree.subdivide_leaf_to_nodes(key, sectant)
                    key = tree.node(key).child(sectant)
                else:
                    if node.ntype == NOTHING:
                        node.ntype = INTERNAL
                        node.occupied = 0
                    key = tree._push_node(_Node())
                    node.set_child(sectant, key)
                cur_min, cur_size = tmin.astype(np.float64), tsize
                continue
            # tsize == d: bottom. A child NODE below brick size -> slow path.
            if tree.key_is_valid(child):
                fallback = True
            break

        if fallback:
            # exact slow path: the packed values map 1:1 to palette colors
            for i in g:
                c = tree.color_palette[int(packed[i]) & 0xFFFF]
                tree.insert(tuple(int(v) for v in positions[i]), c)
            written += len(g)
            continue

        node = tree.node(key)
        sectant = stack[-1][1]
        # materialize the target brick as a parted array (mirroring
        # leaf_update's UNIFORM/INTERNAL conversions)
        if node.ntype == UNIFORM:
            brick = node.bricks
            if isinstance(brick, (int, np.integer)):
                brick = tree._new_brick(fill=int(brick))
            if brick is None:
                node.ntype = LEAF
                node.bricks = [None] * BOX_NODE_CHILDREN_COUNT
            else:
                node.ntype = LEAF
                node.bricks = tree.dilute_brick(brick)
        elif node.ntype in (INTERNAL, NOTHING):
            if node.children is not None:
                new_bricks = [
                    tree.try_brick_from_node(node.child(s))
                    for s in range(BOX_NODE_CHILDREN_COUNT)
                ]
                tree.deallocate_children_of(key)
            else:
                new_bricks = [None] * BOX_NODE_CHILDREN_COUNT
            node.ntype = LEAF
            node.children = None
            node.bricks = new_bricks
        brick = node.bricks[sectant]
        if brick is None:
            brick = tree._new_brick()
        elif isinstance(brick, (int, np.integer)):
            brick = tree._new_brick(fill=int(brick))
        brick[flat_in_brick[g]] = packed[g]
        node.bricks[sectant] = brick
        node.occupied |= 1 << sectant
        written += len(g)
        touched.append((stack, key, cur_min.astype(np.int64), int(cur_size),
                        sectant, cells[g[0]] * d))

    if not touched:
        return written

    # ---- post-process with FRESH access stacks: group processing can free
    # and reuse node keys (leaf absorption deallocates children), so paths
    # recorded during the write loop may be stale
    fresh = []
    for _stack, _key, _bmin, _bs, _sect, cell_min in touched:
        astack = tree.access_stack(cell_min.astype(np.float64))
        if astack:
            fresh.append((astack, cell_min))

    # ancestors: occupied bits along each path
    for astack, cell_min in fresh:
        posf = cell_min.astype(np.float64)
        for k, bmin, bsize in astack:
            tree.node(k).occupied |= 1 << offset_sectant(posf - bmin, bsize)

    # occlusion for fully-occupied bottom nodes
    seen = set()
    for astack, _cm in fresh:
        k, bmin, bsize = astack[-1]
        if k not in seen:
            seen.add(k)
            if tree.node(k).occupied == U64_MAX:
                tree._set_sibling_occlusions(bmin, float(bsize), True)

    # MIP texels: deepest nodes first (children mips feed parents); one
    # update_mip per touched (node, texel) instead of per voxel
    if tree.mip_strategy is not None and tree.mip_strategy.enabled:
        by_depth: dict = {}
        bottoms = {astack[-1][0] for astack, _cm in fresh}
        for astack, cell_min in fresh:
            for depth, (k, bmin, bsize) in enumerate(astack):
                by_depth.setdefault((depth, k), []).append((bmin, bsize, cell_min))
        done_bottom = set()
        for (_depth, k), entries in sorted(by_depth.items(),
                                           key=lambda kv: -kv[0][0]):
            if k in bottoms:
                # the write loop may have structurally converted this node
                # (uniform dilution / child absorption): partial texel
                # updates would leave a half-empty mip — resample it fully
                if k not in done_bottom:
                    done_bottom.add(k)
                    bmin, bsize, _cm = entries[0]
                    mipmap.recalculate_mip(tree, k, bmin, bsize)
                continue
            done = set()
            for bmin, bsize, cell_min in entries:
                texel_size = max(int(bsize) // d, 1)
                tex = tuple(
                    int(v)
                    for v in (cell_min - bmin.astype(np.int64)) // texel_size
                )
                if tex in done:
                    continue
                done.add(tex)
                tree.update_mip(k, bmin, bsize, cell_min)

    # trigger payloads computed before simplify can free/swap nodes
    payloads = []
    if tree.update_triggers:
        for astack, cell_min in fresh:
            posf = cell_min.astype(np.float64)
            ks = [(k, offset_sectant(posf - bmin, bsize)) for k, bmin, bsize in astack]
            payloads.append((ks, [ks[-1][1]]))

    # simplify bottom-up (deferred, as VoxelHex's import loop does)
    if tree.auto_simplify:
        done = set()
        for astack, _cm in fresh:
            for k, _b, _s in reversed(astack):
                if k not in done:
                    done.add(k)
                    tree.simplify(k, False)

    for trigger in tree.update_triggers:
        for ks, sectants in payloads:
            trigger(ks, sectants)
    return written
