"""Ground-truth scalar raytracer over the flat boxtree snapshot (NumPy, on
the host): the port's copy of the reference's ``render/oracle.py``.

The CPU tracer's automaton: a bounded 4-deep wrap-around node stack, a
PUSH/POP/ADVANCE state machine over sectants, occupancy-bitmask culling with
the per-octant reachability masks, and an in-brick DDA march, over the
port's ``FlatTree``.  Deliberately slow and simple, and independent of the
BitGrid and its kernels: the kernels' hits are held to it
(``tests/goldens/bench_rays.npz`` holds its hits of 400 rays of the bench
scene).  Its arithmetic is the reference's, so that its hits are the
reference oracle's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from voxelhex_tpu_torch.constants import BOX_NODE_CHILDREN_COUNT, BOX_NODE_DIMENSION
from voxelhex_tpu_torch.spatial.luts import RAY_TO_NODE_OCCUPANCY_BITMASK_LUT
from voxelhex_tpu_torch.spatial.math import (
    child_bounds_for,
    cube_impact_normal,
    dda_scale_factors,
    dda_step_to_next_sibling,
    flat_projection,
    hash_direction,
    intersect_ray_aabb,
    offset_sectant,
    step_sectant,
)
from voxelhex_tpu_torch.constants import EMPTY_DESC, NO_COLOR_HIT, SOLID_FLAG
from voxelhex_tpu_torch.tree.flat import FlatTree

STACK_SIZE = 4


@dataclass
class Hit:
    """Ray hit: flat voxel value (palette color index or NO_COLOR_HIT),
    impact point and face normal."""

    voxel: int
    point: np.ndarray
    normal: np.ndarray

    @property
    def has_color(self) -> bool:
        return self.voxel != NO_COLOR_HIT

    def albedo(self, flat: FlatTree) -> np.ndarray:
        if self.voxel == NO_COLOR_HIT:
            return np.zeros(4, dtype=np.float32)
        return flat.palette[self.voxel]


class _NodeStack:
    """Fixed-size wrap-around stack: overflow discards the oldest entry, and
    POP re-derives grandparents from bounds arithmetic, the bounded state
    that the device automaton keeps in registers."""

    def __init__(self):
        self.data = [0] * STACK_SIZE
        self.head = 0
        self.count = 0

    def push(self, v: int):
        self.head = (self.head + 1) % STACK_SIZE
        self.count = min(self.count + 1, STACK_SIZE)
        self.data[self.head] = v

    def pop(self):
        if self.count == 0:
            return None
        self.count -= 1
        v = self.data[self.head]
        self.head = (self.head - 1) % STACK_SIZE
        return v

    def last(self):
        return self.data[self.head] if self.count else None


def _traverse_brick(flat: FlatTree, vox: np.ndarray, point, direction, bmin, bsize, sf):
    """In-brick DDA: ``((voxel value, cell index), point)``, or ``(None,
    point)`` where the ray leaves the brick."""
    d = flat.brick_dim
    pos_in_brick = (point - bmin) * d / bsize
    idx = np.clip(pos_in_brick.astype(np.int64), 0, d - 1)
    brick_unit = bsize / d
    cell_min = bmin + idx * brick_unit
    point = np.asarray(point, dtype=np.float32).copy()

    while True:
        if np.any(idx < 0) or np.any(idx >= d):
            return None, point
        flat_idx = flat_projection(int(idx[0]), int(idx[1]), int(idx[2]), d)
        v = int(vox[flat_idx])
        if v != EMPTY_DESC:
            return (v, idx.copy()), point
        point, step = dda_step_to_next_sibling(direction, point, cell_min, brick_unit, sf)
        cell_min = cell_min + step * brick_unit
        idx = idx + step.astype(np.int64)


def _probe_brick(flat: FlatTree, desc: int, point, direction, bmin, bsize, sf):
    """Intersect one brick (solid or parted): ``(Hit, point)`` or ``(None,
    point)``."""
    if desc == EMPTY_DESC:
        return None, point
    if desc & SOLID_FLAG:
        voxel = desc & ~SOLID_FLAG
        return (
            Hit(voxel, np.array(point, dtype=np.float32), cube_impact_normal(bmin, bsize, point)),
            point,
        )
    vox = flat.bricks[desc]
    result, point = _traverse_brick(flat, vox, point, direction, bmin, bsize, sf)
    if result is None:
        return None, point
    v, idx = result
    unit = bsize / flat.brick_dim
    cell_min = np.asarray(bmin, dtype=np.float32) + idx * unit
    normal = cube_impact_normal(cell_min, unit, point)
    return Hit(v, np.array(point, dtype=np.float32), normal), point


def get_by_ray(flat: FlatTree, origin, direction, max_steps: int = 10000) -> Hit | None:
    """March a ray through the flat boxtree; returns the first Hit or None.

    ``direction`` must be normalized.
    """
    direction = np.asarray(direction, dtype=np.float32)
    origin = np.asarray(origin, dtype=np.float32)
    sf = dda_scale_factors(direction)
    octant = hash_direction(direction)
    masks = RAY_TO_NODE_OCCUPANCY_BITMASK_LUT[:, octant]

    size = float(flat.size)
    root_min = np.zeros(3, dtype=np.float32)

    hit_root, dist = intersect_ray_aabb(origin, direction, root_min, size)
    if hit_root:
        point = origin + direction * np.float32(dist if dist is not None else 0.0)
        target_sectant = offset_sectant(point - root_min, size)
    else:
        point = origin.copy()
        target_sectant = BOX_NODE_CHILDREN_COUNT

    steps = 0
    while target_sectant < BOX_NODE_CHILDREN_COUNT:
        current_key = 0
        cur_min, cur_size = root_min.copy(), size
        # fresh target bounds at each (re)start
        tmin_arr, tsize = child_bounds_for(cur_min, cur_size, target_sectant)
        tmin = tmin_arr.astype(np.float32)
        stack = _NodeStack()
        stack.push(0)
        while stack.count > 0:
            steps += 1
            if steps > max_steps:
                raise RuntimeError("oracle raytracer exceeded max_steps (traversal bug)")
            top = stack.last()
            occupied = flat.occupied64(top)
            is_uniform = flat.is_uniform(current_key)
            is_leaf = flat.is_leaf(current_key)
            do_backtrack = is_uniform

            if target_sectant < BOX_NODE_CHILDREN_COUNT and is_leaf:
                if is_uniform:
                    desc = int(flat.node_children[current_key, 0])
                    hit, point = _probe_brick(
                        flat, desc, point, direction, cur_min, cur_size, sf
                    )
                    if hit is not None:
                        return hit
                    do_backtrack = True
                else:
                    desc = int(flat.node_children[current_key, target_sectant])
                    cmin, csize = child_bounds_for(cur_min, cur_size, target_sectant)
                    hit, point = _probe_brick(
                        flat, desc, point, direction, cmin.astype(np.float32), csize, sf
                    )
                    if hit is not None:
                        return hit

            if (
                do_backtrack
                or target_sectant >= BOX_NODE_CHILDREN_COUNT
                or occupied == 0
                or (occupied & int(masks[min(target_sectant, 63)])) == 0
            ):
                # POP: return to parent, re-deriving its bounds arithmetically
                stack.pop()
                tmin, tsize = cur_min.copy(), cur_size
                cur_size = cur_size * BOX_NODE_DIMENSION
                cur_min = cur_min - np.mod(cur_min, cur_size)
                target_sectant = offset_sectant(
                    tmin + tsize / 2.0 - cur_min, cur_size
                )
                point, step = dda_step_to_next_sibling(direction, point, tmin, tsize, sf)
                target_sectant = step_sectant(target_sectant, step)
                tmin = tmin + step * tsize
                parent = stack.last()
                if parent is not None:
                    current_key = parent
                continue

            if (not flat.is_leaf(current_key)) and occupied & (1 << target_sectant):
                # PUSH: descend into the target child
                child_key = int(flat.node_children[current_key, target_sectant])
                current_key = child_key
                cur_min, cur_size = tmin.copy(), tsize
                target_sectant = offset_sectant(point - cur_min, cur_size)
                tmin_arr, tsize = child_bounds_for(cur_min, cur_size, target_sectant)
                tmin = tmin_arr.astype(np.float32)
                stack.push(child_key)
            else:
                # ADVANCE to the next sibling cell with a potential hit
                while True:
                    steps += 1
                    if steps > max_steps:
                        raise RuntimeError(
                            "oracle raytracer exceeded max_steps (advance loop)"
                        )
                    point, step = dda_step_to_next_sibling(
                        direction, point, tmin, tsize, sf
                    )
                    target_sectant = step_sectant(target_sectant, step)
                    if target_sectant < BOX_NODE_CHILDREN_COUNT:
                        tmin = tmin + step * tsize
                    if target_sectant >= BOX_NODE_CHILDREN_COUNT or occupied & (
                        1 << target_sectant
                    ):
                        break

        # stack exhausted: restart from root after a small nudge
        point = point + direction * np.float32(0.1)
        inside = bool(np.all(point > 0.0) and np.all(point < size))
        target_sectant = (
            offset_sectant(point, size) if inside else BOX_NODE_CHILDREN_COUNT
        )

    return None
