"""The sectant lookup tables, computed from the sectant grid's definition
when the module is imported (read-only arrays)."""

from __future__ import annotations

import numpy as np

from voxelhex_tpu_torch.constants import BOX_NODE_CHILDREN_COUNT, BOX_NODE_DIMENSION
from voxelhex_tpu_torch.spatial.math import OOB_SECTANT


def _gen_sectant_offset_lut() -> np.ndarray:
    """f32 [64, 3]: each sectant's min corner in node units (0, .25, .5, .75)."""
    s = np.arange(BOX_NODE_CHILDREN_COUNT)
    return np.stack(
        [(s % 4) * 0.25, ((s // 4) % 4) * 0.25, (s // 16) * 0.25], axis=-1
    ).astype(np.float32)


def _gen_sectant_step_result_lut() -> np.ndarray:
    """i32 [64, 3, 3, 3]: the sectant reached by a step (dx, dy, dz) in
    {-1, 0, 1}^3, ``OOB_SECTANT`` outside the node."""
    lut = np.full((BOX_NODE_CHILDREN_COUNT, 3, 3, 3), OOB_SECTANT, dtype=np.int32)
    for s in range(BOX_NODE_CHILDREN_COUNT):
        x, y, z = s % 4, (s // 4) % 4, s // 16
        for ix, dx in enumerate((-1, 0, 1)):
            for iy, dy in enumerate((-1, 0, 1)):
                for iz, dz in enumerate((-1, 0, 1)):
                    nx, ny, nz = x + dx, y + dy, z + dz
                    if 0 <= nx < 4 and 0 <= ny < 4 and 0 <= nz < 4:
                        lut[s, ix, iy, iz] = nx + ny * 4 + nz * 16
    return lut


def _gen_ray_occupancy_masks() -> np.ndarray:
    """u64 [64, 8]: for an entry sectant and a direction octant
    (``hash_direction``'s ``x + 2*z + 4*y``), the sectants the ray can still
    reach: those on the directed side of the entry cell on every axis."""
    masks = np.zeros((BOX_NODE_CHILDREN_COUNT, 8), dtype=np.uint64)
    for s in range(BOX_NODE_CHILDREN_COUNT):
        sx, sy, sz = s % 4, (s // 4) % 4, s // 16
        for octant in range(8):
            xp, zp, yp = bool(octant & 1), bool(octant & 2), bool(octant & 4)
            m = 0
            for z in range(BOX_NODE_DIMENSION):
                for y in range(BOX_NODE_DIMENSION):
                    for x in range(BOX_NODE_DIMENSION):
                        if ((x >= sx if xp else x <= sx) and (y >= sy if yp else y <= sy)
                                and (z >= sz if zp else z <= sz)):
                            m |= 1 << (x + y * 4 + z * 16)
            masks[s, octant] = np.uint64(m)
    return masks


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


SECTANT_OFFSET_LUT = _frozen(_gen_sectant_offset_lut())
SECTANT_STEP_RESULT_LUT = _frozen(_gen_sectant_step_result_lut())
RAY_TO_NODE_OCCUPANCY_BITMASK_LUT = _frozen(_gen_ray_occupancy_masks())


def ray_occupancy_masks_u32() -> tuple[np.ndarray, np.ndarray]:
    """The occupancy masks as (low, high) u32 words."""
    lo = (RAY_TO_NODE_OCCUPANCY_BITMASK_LUT & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (RAY_TO_NODE_OCCUPANCY_BITMASK_LUT >> np.uint64(32)).astype(np.uint32)
    return lo, hi
