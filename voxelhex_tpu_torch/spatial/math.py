"""Scalar and small-array spatial math of the boxtree (NumPy), the port's
copy of the reference's ``voxelhex_tpu/spatial/math.py``.

A node is a cube split into a 4x4x4 grid of "sectants" indexed
``x + 4*y + 16*z``; cells and bricks are flattened x fastest.  These
functions are unvectorized on purpose: they define the tree's behavior, and
the tree's edits call them a few times a level.
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
