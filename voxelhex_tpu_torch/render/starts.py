"""The host side of the start prepasses (the reference's ``BitGridRenderer``
beam and splat prepasses, ``voxelhex_tpu/render/bitgrid.py:1236-1570``).

* :func:`beam_level`: the pyramid level whose cells keep the beam bound for
  a camera (``_beam_level``), in f64 host math as the reference does it.
* :func:`beam_occupancy`: the 3^3-dilated level-L occupancy with a one-cell
  border ring, from the level-0 pyramid words (``_beam_setup``); the
  renderer packs it with ``bitgrid_from_occupancy`` and keeps it on its
  device, one grid a level, until the content changes.
* :func:`splat_points`: the centers of the surface voxels
  (``_splat_points``), which the splat prepass projects.

The device work of each prepass is a kernel: ``ops/beam.py``,
``ops/splat.py`` and ``ops/prepass.py``.
"""

from __future__ import annotations

import numpy as np

from voxelhex_tpu_torch.constants import COLOR_EMPTY

BEAM_TILE = 8  # pixels a beam tile spans each way (the reference's beam_tile)


def beam_level(size: int, camera, tile: int = BEAM_TILE):
    """The smallest level L whose cell edge 4^L keeps the beam bound valid
    out to the farthest corner of the world ``[0, size)^3`` for ``camera``
    with ``tile`` x ``tile`` pixel tiles, or None when no level qualifies
    (``size`` not a multiple of 4^L, or fewer than 4 cells a side)."""
    w, h = camera.resolution
    S = int(size)
    tan_half = float(np.tan(np.radians(camera.fov_y_deg) / 2.0))
    tanx = tan_half * w / h
    theta = tile * float(np.hypot(tanx / w, tan_half / h))
    o = np.asarray(camera.origin, dtype=np.float64)
    corners = np.array([[x, y, z] for x in (0.0, S) for y in (0.0, S) for z in (0.0, S)])
    rho_max = float(np.max(np.linalg.norm(corners - o, axis=1)))
    need = rho_max * theta / 0.9
    L = 1
    while 4**L < need:
        L += 1
    if S % (4**L) != 0 or S // (4**L) < 4:
        return None
    return L


def beam_occupancy(bitgrid, L: int) -> np.ndarray:
    """bool [m + 2]^3 (x, y, z), m = size / 4^L: a level-L cell is occupied
    when a level-0 block inside it has a word bit set (the pyramid's words,
    not the colors, which a soft path's candidate grids leave empty); the
    grid holds each cell dilated by one cell each way, and a ring of one
    cell around the world (world position p is beam coordinate p / 4^L + 1)."""
    S = int(bitgrid.size)
    c = 4**L
    m = S // c
    m0 = S // 4
    b0 = int(bitgrid.level_bases[0])
    n0 = m0 * m0 * m0
    words = (np.asarray(bitgrid.occ_lo[b0:b0 + n0]) | np.asarray(bitgrid.occ_hi[b0:b0 + n0])) != 0
    blocks = words.reshape(m0, m0, m0).transpose(2, 1, 0)  # [x, y, z]
    f = c // 4  # level-0 blocks a beam cell spans each way (L >= 1)
    cells = blocks.reshape(m, f, m, f, m, f).any(axis=(1, 3, 5))
    g = np.zeros((m + 4, m + 4, m + 4), dtype=bool)
    g[2:m + 2, 2:m + 2, 2:m + 2] = cells
    dil = np.zeros((m + 2, m + 2, m + 2), dtype=bool)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                dil |= g[dx:dx + m + 2, dy:dy + m + 2, dz:dz + m + 2]
    return dil


def splat_points(bitgrid) -> np.ndarray:
    """f32 [N, 3] centers of the occupied voxels with an empty face
    neighbour or on the world's boundary (a voxel with six occupied
    neighbours is never a first hit), in ``np.nonzero`` order over
    (x, y, z).  It scans the whole color grid on the host."""
    S = int(bitgrid.size)
    occ = (np.asarray(bitgrid.colors) != COLOR_EMPTY).reshape(S, S, S).transpose(2, 1, 0)
    interior = np.ones_like(occ)
    for ax in (0, 1, 2):
        lo = np.roll(occ, 1, axis=ax)
        hi = np.roll(occ, -1, axis=ax)
        sl = [slice(None)] * 3
        sl[ax] = 0
        lo[tuple(sl)] = False
        sl[ax] = -1
        hi[tuple(sl)] = False
        interior &= lo & hi
    xs, ys, zs = np.nonzero(occ & ~interior)
    return np.stack([xs, ys, zs], axis=1).astype(np.float32) + 0.5
