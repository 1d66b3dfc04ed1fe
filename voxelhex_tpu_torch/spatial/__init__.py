"""Spatial math of the boxtree on the host (NumPy): sectant indexing, cell
bounds, brick occupancy bitmaps and the sectant lookup tables.  The device
path has its own vectorized forms in :mod:`voxelhex_tpu_torch.render`."""

from voxelhex_tpu_torch.spatial.luts import (
    RAY_TO_NODE_OCCUPANCY_BITMASK_LUT,
    SECTANT_OFFSET_LUT,
    SECTANT_STEP_RESULT_LUT,
    ray_occupancy_masks_u32,
)
from voxelhex_tpu_torch.spatial.math import (
    OOB_SECTANT,
    brick_occupied_bits,
    brick_occupied_bits_many,
    child_bounds_for,
    cube_contains,
    flat_projection,
    matrix_index_for,
    offset_sectant,
    sectant_offset,
    set_occupied_bits,
)

__all__ = [
    "OOB_SECTANT",
    "RAY_TO_NODE_OCCUPANCY_BITMASK_LUT",
    "SECTANT_OFFSET_LUT",
    "SECTANT_STEP_RESULT_LUT",
    "brick_occupied_bits",
    "brick_occupied_bits_many",
    "child_bounds_for",
    "cube_contains",
    "flat_projection",
    "matrix_index_for",
    "offset_sectant",
    "ray_occupancy_masks_u32",
    "sectant_offset",
    "set_occupied_bits",
]
