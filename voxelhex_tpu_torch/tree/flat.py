"""Flat arrays of a boxtree (NumPy): the snapshot that the BitGrid is built
from, the port's copy of ``FlatTree`` and ``flatten`` of the reference's
``voxelhex_tpu/tree/flat.py``, with its far-field helpers
(``sample_coarse``, ``coarse_candidate_cells``) that the streaming view's
placeholders and LOD rings read.

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

from dataclasses import dataclass, replace

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

    def is_leaf(self, key: int) -> bool:
        return bool(self.node_meta[key] & META_LEAF)

    def is_uniform(self, key: int) -> bool:
        return bool(self.node_meta[key] & META_UNIFORM)

    def occupied64(self, key: int) -> int:
        """Node ``key``'s 64 occupancy bits as one int."""
        return int(self.node_ocbits[key, 0]) | (int(self.node_ocbits[key, 1]) << 32)

    def with_padding(self, node_multiple: int = 8, brick_multiple: int = 8) -> "FlatTree":
        """A copy whose node and brick pools are padded to multiples (and
        to at least one row) with empty rows: meta 0, children and MIPs -1,
        occupancy 0, voxels -1."""

        def pad(arr, n, fill):
            if arr.shape[0] % n == 0 and arr.shape[0] > 0:
                return arr
            target = max(n, ((arr.shape[0] + n - 1) // n) * n)
            out = np.full((target,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[: arr.shape[0]] = arr
            return out

        return replace(
            self,
            node_meta=pad(self.node_meta, node_multiple, 0),
            node_children=pad(self.node_children, node_multiple, EMPTY_DESC),
            node_ocbits=pad(self.node_ocbits, node_multiple, 0),
            node_mips=pad(self.node_mips, node_multiple, EMPTY_DESC),
            bricks=pad(self.bricks, brick_multiple, EMPTY_DESC),
            brick_ocbits=(pad(self.brick_ocbits, brick_multiple, 0)
                          if self.brick_ocbits is not None else None),
        )


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


def sample_coarse(flat: FlatTree, pts: np.ndarray, granularity: int | None = None):
    """Vectorized coarse LOD sample: occupancy + representative color for
    cells of edge ``granularity`` containing each query point.

    The host-side analog of the reference's MIP probe for not-yet-streamed
    data (reference: viewport_render.wgsl:328-364 ``probe_MIP`` — when a
    brick is absent but the occupancy bit is set, the node's MIP brick
    supplies a coarse color).  Here the streaming layer calls it to fill
    not-yet-paged window regions with coarse placeholder content.

    Returns ``(occupied [M] bool, color [M] int32)`` where color is a flat
    voxel value (palette index, NO_COLOR_HIT, or EMPTY_DESC when the cell is
    empty or colorless).  Sources, best first:

    * the deepest covering node's MIP brick texel (texel size =
      node_size / brick_dim — equals ``granularity`` when the descent
      bottoms out at node_size = granularity * brick_dim);
    * leaf/uniform brick data (solid value, or a point sample of the brick
      voxel at the query point);
    * for MIP-less internal nodes: a representative color from the
      occupied subtree (lowest-occupied-branch walk — the bottom-up
      analog of the reference's *BD MIP filters); NO_COLOR_HIT only when
      the subtree holds colorless/informative-only data.
    """
    pts = np.asarray(pts, dtype=np.int64).reshape(-1, 3)
    M = pts.shape[0]
    g = int(granularity) if granularity else int(flat.brick_dim)
    d = int(flat.brick_dim)

    key = np.zeros(M, dtype=np.int64)
    node_min = np.zeros((M, 3), dtype=np.int64)
    node_size = np.full(M, flat.size, dtype=np.int64)
    done = np.zeros(M, dtype=bool)

    # descend to the deepest internal node whose MIP texels are >= g
    while True:
        is_leaf = (flat.node_meta[key] & META_LEAF) != 0
        can = ~done & ~is_leaf & (node_size > g * d)
        if not can.any():
            break
        cell = node_size // 4
        rel = np.clip((pts - node_min) // cell[:, None], 0, 3)
        sect = rel[:, 0] + rel[:, 1] * 4 + rel[:, 2] * 16
        child = flat.node_children[key, sect].astype(np.int64)
        step = can & (child >= 0)
        done |= can & (child < 0)
        if not step.any():
            break
        node_min = np.where(step[:, None], node_min + rel * cell[:, None], node_min)
        node_size = np.where(step, cell, node_size)
        key = np.where(step, child, key)

    # per-point cell within the final node
    cell = node_size // 4
    rel = np.clip((pts - node_min) // cell[:, None], 0, 3)
    sect = rel[:, 0] + rel[:, 1] * 4 + rel[:, 2] * 16
    oc_lo = flat.node_ocbits[key, 0].astype(np.uint64)
    oc_hi = flat.node_ocbits[key, 1].astype(np.uint64)
    occ64 = oc_lo | (oc_hi << np.uint64(32))
    bit_occupied = (occ64 >> sect.astype(np.uint64)) & np.uint64(1) != 0

    occupied = bit_occupied.copy()
    color = np.full(M, EMPTY_DESC, dtype=np.int32)

    def _texel_sample(mask, desc, bmin, bsize, block=False):
        """Sample brick descriptors (solid or pool index) at the query pts.

        ``block``: for REAL voxel bricks whose texels are finer than the
        query granularity (bsize > g, i.e. the g-cell covers a k^3 texel
        sub-block with k = g*d/bsize > 1), a point sample UNDER-reports
        thin content — a 3-voxel terrain crust probed at F=4 cell centers
        through brick_dim-8 leaves rendered as dotted holes in the
        midfield ring (found by the round-4 showcase).  The sub-block
        pass replaces it with any-voxel occupancy + first non-empty
        color over the cell's texel block (the bsize <= g case is already
        handled by the whole-brick fallback below)."""
        if not mask.any():
            return
        solid = mask & ((desc & SOLID_FLAG) != 0)
        color[solid] = (desc[solid] & ~SOLID_FLAG).astype(np.int32)
        occupied[solid] = color[solid] != EMPTY_DESC
        parted = mask & ((desc & SOLID_FLAG) == 0) & (desc != EMPTY_DESC)
        if parted.any():
            t = np.clip((pts[parted] - bmin[parted]) * d // bsize[parted, None], 0, d - 1)
            fi = t[:, 0] + t[:, 1] * d + t[:, 2] * d * d
            v = flat.bricks[desc[parted], fi]
            color[parted] = v
            occupied[parted] = v != EMPTY_DESC
            if block:
                kvals = np.where(
                    bsize[parted] > g, g * d // bsize[parted], 1
                )
                pidx = np.flatnonzero(parted)
                for kk in np.unique(kvals):
                    if kk <= 1:
                        continue
                    mm = kvals == kk
                    rows = pidx[mm]
                    base = (t[mm] // kk) * kk  # cell's texel-block corner
                    off = np.stack(
                        np.meshgrid(*[np.arange(kk)] * 3, indexing="ij"),
                        axis=-1,
                    ).reshape(-1, 3)
                    tt = base[:, None, :] + off[None, :, :]
                    fi2 = tt[..., 0] + tt[..., 1] * d + tt[..., 2] * d * d
                    vox = flat.bricks[desc[rows][:, None], fi2]
                    nonempty = vox != EMPTY_DESC
                    anyo = nonempty.any(axis=1)
                    first = np.argmax(nonempty, axis=1)
                    occupied[rows] = anyo
                    cc = color[rows]
                    cc[anyo] = vox[np.arange(vox.shape[0]), first][anyo]
                    color[rows] = cc
        empty = mask & (desc == EMPTY_DESC)
        occupied[empty] = False

    # 1) MIP brick texels (span the whole node)
    mip = flat.node_mips[key].astype(np.int64)
    has_mip = mip != EMPTY_DESC
    _texel_sample(has_mip, mip, node_min, node_size)

    # 2) leaf/uniform brick data where no MIP exists
    is_leaf = (flat.node_meta[key] & META_LEAF) != 0
    is_uniform = (flat.node_meta[key] & META_UNIFORM) != 0
    leaf_only = ~has_mip & is_leaf
    if leaf_only.any():
        desc = flat.node_children[key, np.where(is_uniform, 0, sect)].astype(np.int64)
        # uniform bricks span the node; leaf bricks span the sectant cell
        bmin = np.where(is_uniform[:, None], node_min, node_min + rel * cell[:, None])
        bsize = np.where(is_uniform, node_size, cell)
        _texel_sample(leaf_only, desc, bmin, bsize, block=True)
        # a point sample under-reports a cell covered by exactly one brick:
        # fall back to any-voxel occupancy + the brick's first non-empty color
        missed = (
            leaf_only
            & ~occupied
            & ((desc & SOLID_FLAG) == 0)
            & (desc != EMPTY_DESC)
            & (bsize <= g)
        )
        if missed.any():
            vox = flat.bricks[desc[missed]]  # [K, d^3]
            nonempty = vox != EMPTY_DESC
            any_occ = nonempty.any(axis=1)
            first = np.argmax(nonempty, axis=1)
            occupied[missed] = any_occ
            cm = color[missed]
            cm[any_occ] = vox[np.arange(vox.shape[0]), first][any_occ]
            color[missed] = cm

    # 3) internal node without MIP: descend the occupied subtree for a
    # representative color — the bottom-up analog of the reference's *BD
    # MIP filters (mipmap.rs "BD" = from-the-bottom resampling).  Without
    # this, content smaller than the coarse texel under a MIP-less
    # internal node sampled NO_COLOR_HIT and far-field LOD rings rendered
    # it as hit-but-black silhouettes (found at 1024^3: a 16^3 block in a
    # factor-16 ring shaded to zero).
    bit_only = ~has_mip & ~is_leaf & bit_occupied
    if bit_only.any():
        color[bit_only] = _first_descendant_color(
            flat, key[bit_only], sect[bit_only]
        )
    return occupied, color


def _first_brick_color(flat: FlatTree, desc: np.ndarray) -> np.ndarray:
    """First non-empty voxel color per brick descriptor (solid value or a
    scan of the brick's pool row); NO_COLOR_HIT when nothing is found."""
    res = np.full(desc.shape[0], NO_COLOR_HIT, dtype=np.int32)
    solid = (desc & SOLID_FLAG) != 0
    res[solid] = (desc[solid] & ~SOLID_FLAG).astype(np.int32)
    parted = ~solid & (desc != EMPTY_DESC)
    if parted.any():
        vox = flat.bricks[desc[parted]]  # [K, d^3]
        nonempty = vox != EMPTY_DESC
        any_occ = nonempty.any(axis=1)
        first = np.argmax(nonempty, axis=1)
        r = res[parted]
        r[any_occ] = vox[np.arange(vox.shape[0]), first][any_occ].astype(
            np.int32
        )
        res[parted] = r
    return res


def _first_descendant_color(flat: FlatTree, key: np.ndarray,
                            sect: np.ndarray) -> np.ndarray:
    """Representative color for the subtree under (internal node ``key``,
    sectant ``sect``): vectorized descent along the lowest occupied branch
    to the first non-empty MIP texel, solid value, or brick voxel."""
    M = key.shape[0]
    out = np.full(M, NO_COLOR_HIT, dtype=np.int32)
    cur = flat.node_children[key, sect].astype(np.int64)  # child node keys
    alive = cur >= 0
    for _ in range(32):  # depth is log4(size)-bounded
        if not alive.any():
            break
        idx = np.where(alive)[0]
        k = cur[idx]
        meta = flat.node_meta[k]
        leaf = (meta & META_LEAF) != 0
        unif = (meta & META_UNIFORM) != 0
        mip = flat.node_mips[k].astype(np.int64)
        has_mip = mip != EMPTY_DESC

        done_mip = has_mip
        if done_mip.any():
            out[idx[done_mip]] = _first_brick_color(flat, mip[done_mip])

        use_leaf = ~has_mip & leaf
        if use_leaf.any():
            rows = flat.node_children[k[use_leaf]].astype(np.int64)  # [K,64]
            rows = np.where(unif[use_leaf, None], rows[:, :1], rows)
            ne = rows != EMPTY_DESC
            first = np.argmax(ne, axis=1)
            desc = rows[np.arange(rows.shape[0]), first]
            desc = np.where(ne.any(axis=1), desc, EMPTY_DESC)
            out[idx[use_leaf]] = _first_brick_color(flat, desc)

        nxt = np.full(M, -1, dtype=np.int64)
        use_int = ~has_mip & ~leaf
        if use_int.any():
            ki = k[use_int]
            occ64 = flat.node_ocbits[ki, 0].astype(np.uint64) | (
                flat.node_ocbits[ki, 1].astype(np.uint64) << np.uint64(32)
            )
            isolated = occ64 & (~occ64 + np.uint64(1))
            # exact for single-bit values: float64 represents 2^k exactly
            low = np.where(
                occ64 != 0,
                np.round(np.log2(isolated.astype(np.float64) + (occ64 == 0))),
                0,
            ).astype(np.int64)
            child = flat.node_children[ki, low].astype(np.int64)
            nxt[idx[use_int]] = np.where(occ64 != 0, child, -1)
        cur = nxt
        alive = cur >= 0
    return out


def coarse_candidate_cells(flat: FlatTree, g: int, lo, hi):
    """Conservative candidate OCCUPIED cells of edge ``g`` within the world
    box [lo, hi): unique [N, 3] int64 cell indices (world // g) from a
    vectorized occupancy-bit node walk.

    Cost is O(occupied nodes + emitted candidates) — NOT O(volume / g^3) —
    so whole-world coarse grids build in time proportional to content (the
    reference's upload queue likewise walks tree nodes out to per-level
    inclusion distances rather than scanning space,
    src/raytracing/bevy/streaming/upload_queue.rs:150-207).

    Every truly occupied cell is included (occupancy bits are maintained
    for the whole subtree); some candidates may be empty — callers filter
    with :func:`sample_coarse` on the candidate centers.
    """
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    g = int(g)
    keys = np.zeros(1, dtype=np.int64)
    mins = np.zeros((1, 3), dtype=np.int64)
    sizes = np.full(1, int(flat.size), dtype=np.int64)
    sect = np.arange(64, dtype=np.int64)
    soff = np.stack([sect % 4, (sect // 4) % 4, sect // 16], axis=-1)

    box_min = []
    box_size = []
    while keys.size:
        oc = flat.node_ocbits[keys]
        occ64 = oc[:, 0].astype(np.uint64) | (
            oc[:, 1].astype(np.uint64) << np.uint64(32)
        )
        bits = ((occ64[:, None] >> sect.astype(np.uint64)[None, :])
                & np.uint64(1)).astype(bool)
        cell = sizes // 4  # [K]
        cmin = mins[:, None, :] + soff[None, :, :] * cell[:, None, None]
        keep = bits
        keep &= np.all(cmin + cell[:, None, None] > lo, axis=-1)
        keep &= np.all(cmin < hi, axis=-1)
        child = flat.node_children[keys].astype(np.int64)
        is_leaf = (flat.node_meta[keys] & META_LEAF) != 0
        descend = keep & ~is_leaf[:, None] & (child >= 0) & (cell[:, None] > g)
        emit = keep & ~descend
        em = emit.reshape(-1)
        if em.any():
            box_min.append(cmin.reshape(-1, 3)[em])
            box_size.append(np.repeat(cell, 64)[em])
        de = descend.reshape(-1)
        keys = child.reshape(-1)[de]
        mins = cmin.reshape(-1, 3)[de]
        sizes = np.repeat(cell, 64)[de]

    if not box_min:
        return np.zeros((0, 3), dtype=np.int64)
    bm = np.concatenate(box_min)
    bs = np.concatenate(box_size)
    c0 = np.maximum(bm, lo) // g
    c1 = (np.minimum(bm + bs[:, None], hi) + g - 1) // g  # exclusive
    ext = c1 - c0
    one = np.all(ext <= 1, axis=1)
    cells = [c0[one]]
    for i in np.nonzero(~one)[0]:  # boxes spanning many cells (large
        # uniform leaves / unsubdivided occupied sectants) — rare, and the
        # expansion cost IS the candidate count
        ax = [np.arange(c0[i, a], c1[i, a]) for a in range(3)]
        cells.append(
            np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)
        )
    out = np.concatenate(cells)
    return np.unique(out, axis=0)
