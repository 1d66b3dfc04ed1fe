"""MIP maps of the boxtree: per-node downsampled albedo bricks, the port's
copy of the reference's ``voxelhex_tpu/tree/mipmap.py``.

Every node can carry a ``mip`` brick (brick_dim^3 albedo texels) that
summarizes its subtree:

* resampling methods per MIP level: BoxFilter (gamma-2 average),
  PointFilter (most frequent color), Posterize(thr) (cluster, then average),
  and the *BD ("bottom dominant") variants, which sample full-resolution
  voxels instead of the children's MIPs;
* per-level color-similarity thresholds reuse close palette colors, which
  limits the palette's growth;
* uniform leaves carry no MIP (their content is its own summary);
* ``mip_level = log2(node_size / brick_dim)``.

Defaults: level 1 Posterize(0.05), levels 2-4 BoxFilter; thresholds
{2: 0.1, 3: 0.05, 4: 0.02}.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from voxelhex_tpu_torch.constants import (
    BOX_NODE_CHILDREN_COUNT,
    BOX_NODE_DIMENSION,
    EMPTY_U16,
    EMPTY_VOXEL,
)
from voxelhex_tpu_torch.spatial.math import (
    flat_projection,
    matrix_index_for,
    offset_sectant,
    sectant_offset,
)
from voxelhex_tpu_torch.tree.boxtree import (
    INTERNAL,
    LEAF,
    NOTHING,
    UNIFORM,
    Albedo,
    BoxTree,
    Entry,
    pix_visual,
)

# Resampling method tags
BOX_FILTER = "box"
POINT_FILTER = "point"
POINT_FILTER_BD = "point_bd"
POSTERIZE = "posterize"
POSTERIZE_BD = "posterize_bd"


@dataclass
class MIPStrategy:
    enabled: bool = False
    # level -> (method, threshold-or-None)
    methods: dict = field(
        default_factory=lambda: {
            1: (POSTERIZE, 0.05),
            2: (BOX_FILTER, None),
            3: (BOX_FILTER, None),
            4: (BOX_FILTER, None),
        }
    )
    color_matching_thresholds: dict = field(
        default_factory=lambda: {2: 0.1, 3: 0.05, 4: 0.02}
    )

    def method_at(self, level: int):
        return self.methods.get(level, (BOX_FILTER, None))

    def similarity_at(self, level: int) -> float:
        return self.color_matching_thresholds.get(level, 0.0)

    def set_method(self, level: int, method: str, thr: float | None = None):
        self.methods[level] = (method, thr)
        return self

    def set_similarity(self, level: int, thr: float):
        self.color_matching_thresholds[level] = float(np.clip(thr, 0.0, 1.0))
        return self


def enable_mips(tree: BoxTree, strategy: MIPStrategy | None = None):
    """Enable MIP maps (and rebuild them) on a tree."""
    tree.mip_strategy = strategy or MIPStrategy(enabled=True)
    tree.mip_strategy.enabled = True
    if tree.node(tree.ROOT).ntype != NOTHING:
        recalculate_mips(tree)
    return tree


# ---------------------------------------------------------------------------
# resamplers
# ---------------------------------------------------------------------------


def _resample(method, thr, samples):
    """Combine a list of Albedo|None samples into one Albedo|None."""
    colors = [c for c in samples if c is not None]
    if not colors:
        return None
    if method == BOX_FILTER:
        arr = np.array([[c.r, c.g, c.b, c.a] for c in colors], dtype=np.float64)
        avg = np.sqrt((arr**2).mean(axis=0))
        avg = np.minimum(avg, 255.0)
        return Albedo(*(int(v) for v in avg))
    if method in (POINT_FILTER, POINT_FILTER_BD):
        counts: dict = {}
        for c in colors:
            counts[c] = counts.get(c, 0) + 1
        return max(counts.items(), key=lambda kv: kv[1])[0]
    if method in (POSTERIZE, POSTERIZE_BD):
        # cluster colors whose gamma-average is within thr*255, pick the
        # largest cluster's gamma-corrected average
        clusters: list[list] = []  # [sum_of_squares(4,), count]
        for c in colors:
            v2 = np.array([c.r, c.g, c.b, c.a], dtype=np.float64) ** 2
            placed = False
            for cl in clusters:
                poster = np.sqrt(cl[0] / cl[1])
                if np.linalg.norm(poster - np.sqrt(v2)) < thr * 255.0:
                    cl[0] = cl[0] + v2
                    cl[1] += 1
                    placed = True
                    break
            if not placed:
                clusters.append([v2, 1])
        best = max(clusters, key=lambda cl: cl[1])
        avg = np.minimum(np.sqrt(best[0] / best[1]), 255.0)
        return Albedo(*(int(v) for v in avg))
    raise ValueError(f"unknown MIP method {method}")


def _albedo_of_packed(tree: BoxTree, packed: int):
    ci = packed & 0xFFFF
    if ci == EMPTY_U16:
        return None
    return tree.color_palette[ci]


def _sample_voxel_albedo(tree: BoxTree, pos):
    """Albedo at a global voxel position (None when empty / colorless)."""
    packed = tree.get_packed(pos)
    if packed == EMPTY_VOXEL:
        return None
    return _albedo_of_packed(tree, packed)


def _palette_array(tree: BoxTree) -> np.ndarray:
    """Cached int32 [P, 4] mirror of the color palette, grown incrementally
    in an amortized doubling buffer (interning only appends)."""
    n = len(tree.color_palette)
    buf, cnt = tree._palette_buf, tree._palette_cnt
    if buf is None or cnt > n:
        buf, cnt = np.zeros((max(64, 2 * n), 4), dtype=np.int32), 0
    if buf.shape[0] < n:
        grown = np.zeros((2 * n, 4), dtype=np.int32)
        grown[:cnt] = buf[:cnt]
        buf = grown
    for i in range(cnt, n):
        c = tree.color_palette[i]
        buf[i] = (c.r, c.g, c.b, c.a)
    tree._palette_buf, tree._palette_cnt = buf, n
    return buf[:n]


def _mip_entry_for_color(tree: BoxTree, color: Albedo, level: int) -> int:
    """Reuse a similar palette color within the level threshold, else
    intern: the first match in palette order, vectorized over the palette."""
    thr = tree.mip_strategy.similarity_at(level) * 255.0
    if thr > 0 and tree.color_palette:
        pal = _palette_array(tree)
        c = np.array([color.r, color.g, color.b, color.a], dtype=np.int32)
        d2 = ((pal - c) ** 2).sum(axis=1)  # exact integer distance^2
        hits = np.nonzero(d2 < thr * thr)[0]  # sqrt(d2) < thr <=> d2 < thr^2
        if hits.size:
            return pix_visual(int(hits[0]))
    return pix_visual(tree._intern_color(color))


def update_mip(tree: BoxTree, key: int, node_min, node_size, position):
    """Incrementally resample the single MIP texel containing ``position``."""
    strat: MIPStrategy = tree.mip_strategy
    if strat is None or not strat.enabled:
        return
    d = tree.brick_dim
    node = tree.node(key)
    level = int(np.log2(max(node_size / d, 1)))
    method, thr = strat.method_at(level)
    dominant_bottom = method == POINT_FILTER_BD
    node_min = np.asarray(node_min, dtype=np.float64)
    position = np.asarray(position, dtype=np.int64)

    if node.ntype == NOTHING:
        return
    if node.ntype == UNIFORM:
        node.mip = None  # content is its own MIP
        return

    samples: list = []
    if node.ntype == LEAF:
        # read the covered bricks directly instead of descending the tree
        # per voxel (same sample multiset and order, ~30x faster rebuilds)
        sample_size = min(int(node_size) // d, d * BOX_NODE_DIMENSION)
        start = position - position % sample_size
        cell = int(node_size) // BOX_NODE_DIMENSION
        imin = node_min.astype(np.int64)
        ax = np.arange(start[0], start[0] + sample_size)
        ay = np.arange(start[1], start[1] + sample_size)
        az = np.arange(start[2], start[2] + sample_size)
        # x slowest / z fastest, matching the original nested-loop order
        coords = np.stack(
            np.meshgrid(ax, ay, az, indexing="ij"), axis=-1
        ).reshape(-1, 3)
        relc = np.clip((coords - imin) // cell, 0, 3)
        sects = relc[:, 0] + relc[:, 1] * 4 + relc[:, 2] * 16
        cmin = imin + relc * cell
        b = (coords - cmin) * d // cell
        fi = b[:, 0] + b[:, 1] * d + b[:, 2] * d * d
        samples = [None] * len(coords)
        cache: dict = {}

        def albedo_cached(p):
            if p not in cache:
                cache[p] = _albedo_of_packed(tree, p)
            return cache[p]

        for s in np.unique(sects):
            idxs = np.nonzero(sects == s)[0]
            brick = node.bricks[int(s)]
            if brick is None:
                continue
            if isinstance(brick, (int, np.integer)):
                a = albedo_cached(int(brick))
                for i in idxs:
                    samples[i] = a
            else:
                vals = brick[fi[idxs]]
                for i, p in zip(idxs, vals):
                    samples[i] = albedo_cached(int(p))
    elif node.ntype == INTERNAL and dominant_bottom:
        # sample full-resolution voxels (global coordinates)
        sample_size = int(node_size) // d
        start = position - position % sample_size
        for x in range(start[0], start[0] + sample_size):
            for y in range(start[1], start[1] + sample_size):
                for z in range(start[2], start[2] + sample_size):
                    samples.append(_sample_voxel_albedo(tree, (x, y, z)))
    else:
        # sample children MIP bricks in "parent mip space" [0, 4d)^3
        span = BOX_NODE_DIMENSION * d
        pos_in_bounds = position - node_min.astype(np.int64)
        s1 = np.floor(pos_in_bounds * BOX_NODE_DIMENSION * d / node_size).astype(
            np.int64
        )
        start = s1 - s1 % BOX_NODE_DIMENSION
        for x in range(start[0], start[0] + BOX_NODE_DIMENSION):
            for y in range(start[1], start[1] + BOX_NODE_DIMENSION):
                for z in range(start[2], start[2] + BOX_NODE_DIMENSION):
                    p = np.array([x, y, z], dtype=np.float64)
                    sectant = offset_sectant(p, span)
                    child = node.child(sectant)
                    if not tree.key_is_valid(child):
                        samples.append(None)
                        continue
                    child_node = tree.node(child)
                    pos_in_child = (p - sectant_offset(sectant) * span).astype(np.int64)
                    mip = child_node.mip
                    if child_node.ntype == UNIFORM:
                        # uniform leaves carry no MIP: their own content is
                        # the summary; sample it directly
                        brick = child_node.bricks
                        if brick is None:
                            samples.append(None)
                        elif isinstance(brick, (int, np.integer)):
                            samples.append(_albedo_of_packed(tree, int(brick)))
                        else:
                            fi = flat_projection(
                                int(pos_in_child[0]),
                                int(pos_in_child[1]),
                                int(pos_in_child[2]),
                                d,
                            )
                            samples.append(_albedo_of_packed(tree, int(brick[fi])))
                    elif mip is None:
                        samples.append(None)
                    elif isinstance(mip, (int, np.integer)):
                        samples.append(_albedo_of_packed(tree, int(mip)))
                    else:
                        fi = flat_projection(
                            int(pos_in_child[0]),
                            int(pos_in_child[1]),
                            int(pos_in_child[2]),
                            d,
                        )
                        samples.append(_albedo_of_packed(tree, int(mip[fi])))

    color = _resample(method, thr, samples)
    if color is None:
        return
    entry = _mip_entry_for_color(tree, color, level)

    mi = matrix_index_for(node_min, node_size, position, d)
    flat = flat_projection(int(mi[0]), int(mi[1]), int(mi[2]), d)
    mip = node.mip
    if mip is None:
        new = np.full(d**3, EMPTY_VOXEL, dtype=np.uint32)
        new[flat] = entry
        node.mip = new
    elif isinstance(mip, (int, np.integer)):
        new = np.full(d**3, int(mip), dtype=np.uint32)
        new[flat] = entry
        node.mip = new
    else:
        mip[flat] = entry


def recalculate_mip(tree: BoxTree, key: int, node_min, node_size):
    """Resample every MIP texel of one node."""
    if tree.mip_strategy is None or not tree.mip_strategy.enabled:
        return
    d = tree.brick_dim
    tree.node(key).mip = None
    node_min = np.asarray(node_min, dtype=np.float64)
    for x in range(d):
        for y in range(d):
            for z in range(d):
                pos = node_min + np.round(
                    np.array([x, y, z], dtype=np.float64) * node_size / d
                )
                update_mip(tree, key, node_min, node_size, pos.astype(np.int64))


def recalculate_mips(tree: BoxTree):
    """Rebuild all MIP bricks bottom-up (DFS; children before parents)."""
    if tree.mip_strategy is None or not tree.mip_strategy.enabled:
        return

    def visit(key, node_min, node_size):
        node = tree.node(key)
        if node.ntype == NOTHING:
            return
        if node.ntype == INTERNAL and node.children is not None:
            for sectant, child in enumerate(node.children):
                if tree.key_is_valid(child):
                    cmin = node_min + sectant_offset(sectant).astype(np.float64) * node_size
                    visit(child, cmin, node_size / BOX_NODE_DIMENSION)
        recalculate_mip(tree, key, node_min, node_size)

    visit(tree.ROOT, np.zeros(3, dtype=np.float64), float(tree.size))


def sample_root_mip(tree: BoxTree, sectant: int, position) -> "Entry":
    """Sample the root node's MIP brick — or a root child's, when
    ``sectant`` < 64 — at ``position`` (each component in [0, brick_dim)).
    For tests and debugging."""
    if sectant >= BOX_NODE_CHILDREN_COUNT:
        key = tree.ROOT
    else:
        key = tree.node(tree.ROOT).child(sectant)
    if not tree.key_is_valid(key):
        return Entry()
    mip = tree.node(key).mip
    if mip is None:
        return Entry()
    if isinstance(mip, (int, np.integer)):
        return tree.entry_for(int(mip))
    x, y, z = (int(c) for c in position)
    return tree.entry_for(int(mip[flat_projection(x, y, z, tree.brick_dim)]))
