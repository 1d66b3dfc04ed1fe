"""The benchmark scene, built straight into a BitGrid.

128^3 of procedural content (a sloped floor slab, a hollow lattice box and a
sphere shell) in a 256^3 world: the scene the reference's headline
benchmark renders at 1920x1080.  The reference builds it as a boxtree and
rasterizes that into the dense pyramid; the port paints the same voxels
into the dense grids directly.  The palette takes the reference's order:
distinct RGBA colors sorted by their little-endian u32 value.
"""

from __future__ import annotations

import numpy as np

from voxelhex_tpu_torch.constants import COLOR_EMPTY
from voxelhex_tpu_torch.render.bitgrid import BitGrid, bitgrid_from_grids

SIZE = 256  # world extent
EXTENT = 128  # content extent


def scene_points():
    """``(positions int64 [N, 3], colors uint8 [N, 4])`` of the scene, in
    the reference's order (floor, box, sphere; x outermost)."""
    ext = EXTENT
    # floor: one voxel per (x, z), height (x + z) % 8
    x, z = np.meshgrid(np.arange(ext), np.arange(ext), indexing="ij")
    x, z = x.ravel(), z.ravel()
    floor = np.stack([x, (x + z) % 8, z], axis=1)
    floor_c = np.stack([50 + x, np.full_like(x, 100), 50 + z, np.full_like(x, 255)], axis=1)
    # box: faces plus a (x + y + z) % 3 lattice inside
    x, y, z = (a.ravel() for a in np.meshgrid(
        np.arange(20, 60), np.arange(8, 48), np.arange(20, 60), indexing="ij"))
    keep = ((x == 20) | (x == 59) | (y == 8) | (y == 47) | (z == 20) | (z == 59)
            | ((x + y + z) % 3 == 0))
    box = np.stack([x, y, z], axis=1)[keep]
    box_c = np.stack([np.full_like(y, 200), 60 + y, np.full_like(y, 60),
                      np.full_like(y, 255)], axis=1)[keep]
    # sphere shell of radius 24 +- 1.5 around (88, 64, 88); integer
    # coordinates make the distance exact
    x, y, z = (a.ravel() for a in np.meshgrid(
        np.arange(60, 118), np.arange(36, 94), np.arange(60, 118), indexing="ij"))
    dist = np.sqrt((x - 88.0) ** 2 + (y - 64.0) ** 2 + (z - 88.0) ** 2)
    keep = (24.0 - 1.5 <= dist) & (dist <= 24.0 + 1.5)
    sphere = np.stack([x, y, z], axis=1)[keep]
    sphere_c = np.tile(np.array([60, 80, 220, 255]), (len(sphere), 1))
    pts = np.concatenate([floor, box, sphere]).astype(np.int64)
    cols = np.clip(np.concatenate([floor_c, box_c, sphere_c]), 0, 255).astype(np.uint8)
    return pts, cols


def grids_from_points(pts, cols, size: int):
    """Dense grids from point voxels (a duplicate position keeps its last
    color; all-zero RGBA is empty): ``(occ bool [x, y, z], colors uint16
    [S^3] x-fastest, palette f32 [P, 4])``."""
    rgba = np.ascontiguousarray(cols, dtype=np.uint8).reshape(-1, 4)
    keys = rgba.view(np.uint32).ravel()
    keep = keys != 0
    pts, keys = pts[keep], keys[keep]
    uniq, inverse = np.unique(keys, return_inverse=True)
    rows = uniq.view(np.uint8).reshape(-1, 4)
    palette = (rows.astype(np.float64) / 255.0).astype(np.float32)
    if len(palette) == 0:
        palette = np.zeros((1, 4), dtype=np.float32)
    lin = pts[:, 0] + pts[:, 1] * size + pts[:, 2] * size * size
    # the last occurrence of a position wins
    _, first = np.unique(lin[::-1], return_index=True)
    sel = len(lin) - 1 - first
    colors = np.full(size**3, COLOR_EMPTY, dtype=np.uint16)
    colors[lin[sel]] = inverse.ravel()[sel].astype(np.uint16)
    occ = (colors != COLOR_EMPTY).reshape(size, size, size).transpose(2, 1, 0)
    return np.ascontiguousarray(occ), colors, palette


def build_scene() -> BitGrid:
    """The benchmark scene as a BitGrid (size 256, 4 levels)."""
    pts, cols = scene_points()
    occ, colors, palette = grids_from_points(pts, cols, SIZE)
    return bitgrid_from_grids(occ, colors, palette)
