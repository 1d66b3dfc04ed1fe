"""Structural checks of a :class:`~voxelhex_tpu_torch.tree.boxtree.BoxTree`,
the port's copy of the reference's ``voxelhex_tpu/tree/invariants.py``: a
whole-tree audit that the tests run after edits."""

from __future__ import annotations

import numpy as np

from voxelhex_tpu_torch.constants import BOX_NODE_CHILDREN_COUNT
from voxelhex_tpu_torch.tree.boxtree import (
    INTERNAL,
    LEAF,
    NOTHING,
    UNIFORM,
    U64_MAX,
    BoxTree,
)


def verify_invariants(tree: BoxTree) -> list[str]:
    """Audit the whole tree; returns a list of violation descriptions
    (empty = consistent).

    Checked invariants:
    * node pool: every alive node is reachable from the root exactly once
      (no leaks, no sharing); child keys are valid or EMPTY.
    * node content: INTERNAL nodes carry children and no bricks; LEAF nodes
      carry 64 bricks; UNIFORM nodes carry one; NOTHING carries neither.
    * occupancy: each node's 64-bit ``occupied`` field equals the occupancy
      recomputed from its content (``node_empty_at`` per sectant).
    * occlusion: a face bit is set only if the same-size neighbor on that
      side exists and is fully occupied (``occupied == u64::MAX``).
    """
    problems: list[str] = []
    seen: dict[int, str] = {}

    def visit(key: int, bmin, bsize, path: str):
        if not tree.key_is_valid(key):
            problems.append(f"{path}: invalid key {key}")
            return
        if key in seen:
            problems.append(f"{path}: node {key} already reachable at {seen[key]}")
            return
        seen[key] = path
        node = tree.node(key)

        # content shape
        if node.ntype == INTERNAL:
            if node.children is None:
                problems.append(f"{path}: INTERNAL without children")
            if node.bricks is not None:
                problems.append(f"{path}: INTERNAL with bricks")
        elif node.ntype == LEAF:
            if not isinstance(node.bricks, list) or len(node.bricks) != 64:
                problems.append(f"{path}: LEAF without 64 bricks")
        elif node.ntype == NOTHING:
            if node.bricks is not None or node.children is not None:
                problems.append(f"{path}: NOTHING with content")

        # occupancy vs content
        expect = 0
        for s in range(BOX_NODE_CHILDREN_COUNT):
            if not tree.node_empty_at(key, s):
                expect |= 1 << s
        if node.occupied != expect:
            problems.append(
                f"{path}: occupied {node.occupied:#x} != derived {expect:#x}"
                f" (type {node.ntype})"
            )

        # occlusion vs siblings
        if node.occlusion:
            for bit in range(6):
                if node.occlusion & (1 << bit):
                    # find the neighbor whose fullness implies this bit
                    for direction, side in BoxTree._SIDE_FOR_DIRECTION:
                        if side != bit:
                            continue
                        # _set_sibling_occlusions(center_node) sets `side` on
                        # the sibling in `direction` FROM the full node; so a
                        # set bit here means the neighbor in -direction is
                        # full.  Walk to that neighbor.
                        opp = tuple(-d for d in direction)
                        sib = tree._sibling_at(np.asarray(bmin), bsize, opp)
                        if sib is None or tree.node(sib).occupied != U64_MAX:
                            problems.append(
                                f"{path}: occlusion bit {bit} set but the "
                                f"{opp} neighbor is absent or not full"
                            )

        if node.ntype == INTERNAL and node.children is not None:
            csize = bsize / 4.0
            for s, child in enumerate(node.children):
                if child == -1:
                    continue
                if not tree.key_is_valid(child):
                    problems.append(f"{path}/{s}: dangling child key {child}")
                    continue
                off = np.array([(s % 4), (s // 4) % 4, s // 16], dtype=np.float64)
                visit(child, np.asarray(bmin) + off * csize, csize, f"{path}/{s}")

    visit(tree.ROOT, np.zeros(3), float(tree.size), "root")

    alive = {
        k for k in range(len(tree._nodes)) if tree._nodes[k] is not None
    }
    leaked = alive - set(seen)
    for k in sorted(leaked):
        problems.append(f"leaked node {k} (alive but unreachable)")
    return problems
