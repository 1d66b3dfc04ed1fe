"""Scalar and small-array spatial math of the boxtree (NumPy), the port's
copy of the reference's ``voxelhex_tpu/spatial/math.py``.

A node is a cube split into a 4x4x4 grid of "sectants" indexed
``x + 4*y + 16*z``; cells and bricks are flattened x fastest.  These
functions are unvectorized on purpose: they define the tree's behavior, and
the tree's edits call them a few times a level.  The ray helpers at the end
are those of the scalar ground-truth tracer (:mod:`voxelhex_tpu_torch.
render.oracle`) and of ``.vox`` import's coordinate systems.
"""

from __future__ import annotations

import numpy as np

from voxelhex_tpu_torch.constants import BOX_NODE_CHILDREN_COUNT, BOX_NODE_DIMENSION

# Sectant index of a step that left the node: any value >= 64.
OOB_SECTANT = BOX_NODE_CHILDREN_COUNT

_U64_ALL = (1 << 64) - 1


def flat_projection(x: int, y: int, z: int, size: int) -> int:
    """Flat index of a cell of a ``size``-cube, x fastest."""
    return x + y * size + z * size * size


def offset_sectant(offset, size) -> int:
    """Sectant (0..63) of a point ``offset`` inside a cube of ``size``; a
    point on the cube's upper face maps to the last cell of that axis."""
    offset = np.asarray(offset, dtype=np.float32)
    idx = np.floor(offset * BOX_NODE_DIMENSION / np.float32(size))
    idx = np.minimum(idx, BOX_NODE_DIMENSION - 1)
    idx = np.maximum(idx, 0)
    return int(idx[0] + idx[1] * 4 + idx[2] * 16)


def sectant_offset(sectant: int) -> np.ndarray:
    """Min corner of ``sectant`` relative to its node, in node units (0..1)."""
    return np.array(
        [(sectant % 4) * 0.25, ((sectant // 4) % 4) * 0.25, (sectant // 16) * 0.25],
        dtype=np.float32,
    )


class CubeSides:
    """Face indices of a node's 6-bit occlusion field."""

    BACK = 0
    FRONT = 1
    TOP = 2
    BOTTOM = 3
    LEFT = 4
    RIGHT = 5


def brick_slot_for(position, brick_dim: int):
    """``(min_position, size)`` of the brick-aligned cube that holds
    ``position`` (f64 min corner, edge ``brick_dim``)."""
    p = np.asarray(position, dtype=np.float64)
    return p - np.abs(np.mod(p, float(brick_dim))), float(brick_dim)


def cube_contains(min_position, size, position) -> bool:
    """``position`` lies in the half-open cube ``[min, min + size)``."""
    p = np.asarray(position, dtype=np.float32)
    m = np.asarray(min_position, dtype=np.float32)
    return bool(np.all(p >= m) and np.all(p < m + np.float32(size)))


def child_bounds_for(min_position, size, sectant: int):
    """``(min, size)`` of the child cell ``sectant`` of a node."""
    m = np.asarray(min_position, dtype=np.float32)
    return (
        m + sectant_offset(sectant) * np.float32(size),
        np.float32(size) / BOX_NODE_DIMENSION,
    )


def matrix_index_for(bounds_min, bounds_size, position, matrix_dimension: int):
    """Index into a ``matrix_dimension``^3 brick spanning the bounds of the
    integer position ``position``."""
    p = np.asarray(position, dtype=np.float32)
    m = np.asarray(bounds_min, dtype=np.float32)
    return np.floor((p - m) * matrix_dimension / np.float32(bounds_size)).astype(np.int64)


def set_occupied_bits(position, size: int, brick_dim: int, occupied: bool, bitmap: int) -> int:
    """``bitmap`` (a u64 as a Python int) with the bits that cover a
    ``size``-cube at ``position`` of a ``brick_dim``^3 brick set or cleared;
    the bitmap is the brick downsampled to 4x4x4."""
    if brick_dim == 1:
        return _U64_ALL if occupied else 0
    update_count = int(np.ceil(size * BOX_NODE_DIMENSION / brick_dim))
    px, py, pz = (int(c) * BOX_NODE_DIMENSION // brick_dim for c in position)
    for x in range(px, min(px + update_count, BOX_NODE_DIMENSION)):
        for y in range(py, min(py + update_count, BOX_NODE_DIMENSION)):
            for z in range(pz, min(pz + update_count, BOX_NODE_DIMENSION)):
                mask = 1 << (x + y * 4 + z * 16)
                bitmap = bitmap | mask if occupied else bitmap & ~mask
    return bitmap & _U64_ALL


def _bit_weights() -> np.ndarray:
    """u64 weight of each cell of a [z, y, x] 4x4x4 grid: bit x + 4y + 16z."""
    return (np.uint64(1) << np.arange(64, dtype=np.uint64)).reshape(4, 4, 4)


def _coarse(grid: np.ndarray, d: int) -> np.ndarray:
    """[..., d, d, d] bool masks (z, y, x) at 4x4x4: any voxel of a cell for
    d >= 4, each voxel over (4/d)^3 cells for d = 2."""
    lead = grid.shape[:-3]
    if d >= BOX_NODE_DIMENSION:
        f = d // BOX_NODE_DIMENSION
        g = grid.reshape(lead + (4, f, 4, f, 4, f))
        n = len(lead)
        return g.any(axis=(n + 1, n + 3, n + 5))
    r = BOX_NODE_DIMENSION // d
    n = len(lead)
    return np.repeat(np.repeat(np.repeat(grid, r, n), r, n + 1), r, n + 2)


def brick_occupied_bits(occupied_mask: np.ndarray) -> int:
    """64-bit occupancy (a Python int) of a brick from its bool per-voxel
    mask, flat (d^3) or [d, d, d], in ``flat_projection`` order."""
    mask = np.asarray(occupied_mask, dtype=bool)
    d = round(mask.size ** (1.0 / 3.0))
    if d * d * d != mask.size:
        raise ValueError("a brick mask must be a cube")
    return int(brick_occupied_bits_many(mask.reshape(1, -1))[0])


def brick_occupied_bits_many(occupied_mask: np.ndarray) -> np.ndarray:
    """:func:`brick_occupied_bits` of each row of a [B, d^3] bool array, as
    u64 [B]."""
    mask = np.asarray(occupied_mask, dtype=bool)
    b, v = mask.shape
    d = round(v ** (1.0 / 3.0))
    if d * d * d != v:
        raise ValueError("a brick mask must be a cube")
    if b == 0:
        return np.zeros(0, dtype=np.uint64)
    grid = mask.reshape(b, d, d, d)  # [b, z, y, x]
    if d == 1:
        return np.where(grid.reshape(b), np.uint64(_U64_ALL), np.uint64(0))
    coarse = _coarse(grid, d).reshape(b, 64).astype(np.uint64)
    return (coarse * _bit_weights().reshape(1, 64)).sum(axis=1, dtype=np.uint64)


# ---------------------------------------------------------------------------
# Ray math: the scalar helpers of the ground-truth tracer (render/oracle.py),
# the reference's own, in its operation order
# ---------------------------------------------------------------------------


def step_sectant(sectant: int, step) -> int:
    """Sectant reached from ``sectant`` stepping ``sign(step)`` in xyz;
    ``OOB_SECTANT`` when the step leaves the 4x4x4 grid."""
    step = np.asarray(step)
    x = sectant % 4 + int(np.sign(int(step[0])))
    y = (sectant // 4) % 4 + int(np.sign(int(step[1])))
    z = sectant // 16 + int(np.sign(int(step[2])))
    if 0 <= x < 4 and 0 <= y < 4 and 0 <= z < 4:
        return x + y * 4 + z * 16
    return OOB_SECTANT


def hash_direction(direction) -> int:
    """Octant (0..7) a direction points into; a zero component counts as
    positive."""
    d = np.asarray(direction, dtype=np.float32)
    return int((d[0] >= 0) + (d[2] >= 0) * 2 + (d[1] >= 0) * 4)


def octant_in_sectant(sectant: int) -> int:
    """The 2x2x2 octant of the node that a sectant lies in."""
    x = (sectant % 4) >= 2
    y = ((sectant // 4) % 4) >= 2
    z = (sectant // 16) >= 2
    return int(x) + int(z) * 2 + int(y) * 4


def intersect_ray_aabb(origin, direction, box_min, box_size):
    """Slab-method ray/cube intersection: ``(hit, impact_distance)``, the
    distance None when the origin is inside the cube.  ``fmin``/``fmax``
    pass over the NaNs of 0/0 on an axis-parallel ray along a slab."""
    o = np.asarray(origin, dtype=np.float32)
    d = np.asarray(direction, dtype=np.float32)
    m = np.asarray(box_min, dtype=np.float32)
    mx = m + np.float32(box_size)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo = (m - o) / d
        t_hi = (mx - o) / d
    per_axis_min = np.fmin(t_lo, t_hi)
    per_axis_max = np.fmax(t_lo, t_hi)
    tmin = float(np.fmax(np.fmax(per_axis_min[0], per_axis_min[1]), per_axis_min[2]))
    tmax = float(np.fmin(np.fmin(per_axis_max[0], per_axis_max[1]), per_axis_max[2]))
    if tmax < 0.0 or tmin > tmax:
        return False, None
    if tmin < 0.0:
        return True, None
    return True, tmin


def cube_impact_normal(cube_min, cube_size, impact_point) -> np.ndarray:
    """Face normal at an impact point: the dominant axis of the vector from
    the cube's center to the impact."""
    m = np.asarray(cube_min, dtype=np.float32)
    p = np.asarray(impact_point, dtype=np.float32)
    mid_to_impact = m + np.float32(cube_size) / 2.0 - p
    a = np.abs(mid_to_impact)
    max_c = float(np.max(a))
    normal = np.where(a == max_c, -mid_to_impact, 0.0).astype(np.float32)
    n = float(np.linalg.norm(normal))
    return normal / n if n > 0 else normal


def dda_scale_factors(direction) -> np.ndarray:
    """The ray's length for one unit along each axis."""
    d = np.asarray(direction, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        fx = np.sqrt(1.0 + (d[2] / d[0]) ** 2 + (d[1] / d[0]) ** 2)
        fy = np.sqrt((d[0] / d[1]) ** 2 + 1.0 + (d[2] / d[1]) ** 2)
        fz = np.sqrt((d[0] / d[2]) ** 2 + 1.0 + (d[1] / d[2]) ** 2)
    return np.array([fx, fy, fz], dtype=np.float32)


def dda_step_to_next_sibling(direction, ray_point, cell_min, cell_size, scale_factors):
    """``(new_point, step)``: ``ray_point`` moved to the boundary of its
    cell, and the sign of the direction on each axis that reached it first
    (0 elsewhere).  The NaN of 0 * inf on an axis-parallel ray is passed
    over."""
    d = np.asarray(direction, dtype=np.float32)
    p = np.asarray(ray_point, dtype=np.float32)
    m = np.asarray(cell_min, dtype=np.float32)
    signum = np.sign(d).astype(np.float32)
    diff_from_min = p - m
    steps_needed = np.float32(cell_size) * np.maximum(signum, 0.0) - signum * diff_from_min
    with np.errstate(invalid="ignore"):
        dists = np.abs(steps_needed * np.asarray(scale_factors, dtype=np.float32))
    min_step = float(np.nanmin(dists))
    new_p = p + d * np.float32(min_step)
    step = np.where(dists == min_step, signum, 0.0).astype(np.float32)
    return new_p, step


# Coordinate systems by handedness (L/R) and up axis (yup/zup): MagicaVoxel
# is Rzup, the tree Lyup.  Every conversion that changes both the hand and
# the up axis shares one swap, (x, z, y), as the reference's table does.
LZUP, LYUP, RZUP, RYUP = "Lzup", "Lyup", "Rzup", "Ryup"
_COORD_SYSTEMS = (LZUP, LYUP, RZUP, RYUP)


def convert_coordinate(c, src: str, dst: str):
    """3-vectors ``c`` (``[..., 3]``) from coordinate system ``src`` to
    ``dst``."""
    if src not in _COORD_SYSTEMS or dst not in _COORD_SYSTEMS:
        raise ValueError(f"unknown coordinate system in {src!r} -> {dst!r}")
    c = np.asarray(c)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    if src == dst:
        out = (x, y, z)
    elif {src, dst} == {LYUP, RYUP}:
        out = (x, y, -z)
    elif {src, dst} == {LZUP, RZUP}:
        out = (x, -y, z)
    elif (src, dst) in ((LYUP, LZUP), (RYUP, RZUP)):
        out = (x, -z, y)
    elif (src, dst) in ((LZUP, LYUP), (RZUP, RYUP)):
        out = (x, z, -y)
    else:
        out = (x, z, y)
    return np.stack(np.broadcast_arrays(*out), axis=-1)


def plane_line_intersection(plane_point, plane_normal, line_origin, line_direction):
    """Signed distance along the line to the plane (negative behind the
    origin), 0.0 when the origin lies on the plane, or None when the line
    is parallel to it and off it."""
    pp = np.asarray(plane_point, dtype=np.float32)
    pn = np.asarray(plane_normal, dtype=np.float32)
    lo = np.asarray(line_origin, dtype=np.float32)
    ld = np.asarray(line_direction, dtype=np.float32)
    diff_dot = float(np.dot(pp - lo, pn))
    dir_dot = float(np.dot(ld, pn))
    if dir_dot == 0.0:
        return 0.0 if diff_dot == 0.0 else None
    return diff_dot / dir_dot
