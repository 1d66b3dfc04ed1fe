"""BitGrid: the dense occupancy pyramid and its plain tracer.

Level ``l`` of the pyramid splits space into cells of ``4**l`` voxels; each
4x4x4 group of cells (a "block") stores its 64 occupancy bits as a (lo, hi)
u32 word pair, addressed arithmetically from the block's coordinates.  The
tracer runs the sectant automaton (PUSH/POP/ADVANCE) over it: DESCEND and
ASCEND fetch one word pair, ADVANCE is arithmetic inside the current block.
Color resolves after the march with one gather from a dense u16 grid.

On the card the tracer is the CUDA kernel of :mod:`voxelhex_tpu_torch.ops.
traverse`; :func:`make_bitgrid_tracer` here is its plain PyTorch version,
bit-equal to the reference's ``make_bitgrid_tracer``.  The reference's
other tracer, the skip tracer, marches the skip rows
(:func:`build_skip_rows`: every level's word pair over a level-0 block in
one row); :func:`make_skip_tracer` is its plain version, of the skip
instances of the kernels (:mod:`voxelhex_tpu_torch.ops.skip`).

:func:`build_bitgrid` makes the BitGrid of a BoxTree or FlatTree on the
host, in the host library or in NumPy, equal to the reference's field for
field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from voxelhex_tpu_torch import native as _native
from voxelhex_tpu_torch.constants import (
    BOX_NODE_CHILDREN_COUNT,
    COLOR_EMPTY,
    COLOR_NONE,
    EMPTY_DESC,
    NO_COLOR_HIT,
    OOB,
    SOLID_FLAG,
)
from voxelhex_tpu_torch.fp import fma32, fmax_nan, fmin_nan, maximum, minimum, sqrt32
from voxelhex_tpu_torch.tree.boxtree import BoxTree
from voxelhex_tpu_torch.tree.flat import META_LEAF, META_UNIFORM, FlatTree, flatten
from voxelhex_tpu_torch.render.wavefront import (
    _dda_step_v,
    _impact_normal_v,
    _occ_bit_v,
    _offset_sectant_v,
    _sectant_offset_v,
    _step_sectant_v,
)

U32_MASK = 0xFFFFFFFF
# on which axes XLA:CPU fuses the skip tracer's entry point o + d * enter
# and its DDA step point + d * t (the stack tracer's DDA: all three)
SKIP_ENTRY_FMA = (True, True, False)
SKIP_DDA_FMA = (True, True, False)

# The moves of the move record (``make_bitgrid_tracer``'s ``run(...,
# moves=...)``): a step that ascends past the top level (to restart or to
# leave) is ``MOVE_RESTART``, and an ADVANCE of k DDA substeps is
# ``MOVE_ADVANCE + k``, 1 <= k <= the tracer's substeps.
MOVE_NONE = 0  # the ray took no step
MOVE_HIT = 1
MOVE_DESCEND = 2
MOVE_ASCEND = 3
MOVE_LATERAL = 4
MOVE_RESTART = 5
MOVE_ADVANCE = 8


@dataclass
class BitGrid:
    """Dense occupancy pyramid + dense color-index grid (host arrays)."""

    size: int
    n_levels: int  # block levels; level-0 blocks span 4 voxels
    level_bases: np.ndarray  # int64[n_levels] word-pair base offset per level
    occ_lo: np.ndarray  # uint32[total_blocks]
    occ_hi: np.ndarray  # uint32[total_blocks]
    colors: np.ndarray  # uint16[S^3], flat index x + y*S + z*S^2
    palette: np.ndarray  # float32[P, 4]
    # per-level MIP colors for LOD rendering (build_mip_colors): mip_rgb[l]
    # is f32 [(S / 4^(l + 1))^3, 3], the averaged color of each cell of
    # level l + 1, flat index x + y*n + z*n^2; None until built
    mip_rgb: list | None = None


def build_mip_colors(bg: BitGrid) -> BitGrid:
    """Attach the per-level averaged color grids ``bg.mip_rgb`` (a gamma-2
    box filter over the occupied voxels) and return ``bg``: the reference's
    ``build_mip_colors`` in the same NumPy operations, so bit-equal to it.
    It holds the whole world's f32 colors on the host (about 28 B a voxel
    at its peak)."""
    S = bg.size
    pal = np.asarray(bg.palette, dtype=np.float32)
    ci = np.minimum(np.asarray(bg.colors), pal.shape[0] - 1).astype(np.int64)
    occupied = np.asarray(bg.colors) != COLOR_EMPTY
    rgb = pal[ci][:, :3] ** 2
    rgb[~occupied] = 0.0
    w = occupied.astype(np.float32)
    rgb = rgb.reshape(S, S, S, 3)  # [z, y, x, 3]
    w = w.reshape(S, S, S)
    mip_rgb = []
    c = S
    while c > 1:
        n = max(c // 4, 1)
        f = c // n
        rgb_b = rgb.reshape(n, f, n, f, n, f, 3).sum(axis=(1, 3, 5))
        w_b = w.reshape(n, f, n, f, n, f).sum(axis=(1, 3, 5))
        avg = np.sqrt(rgb_b / np.maximum(w_b[..., None], 1.0))
        mip_rgb.append(avg.reshape(-1, 3).astype(np.float32))
        rgb, w, c = rgb_b, w_b, n
    bg.mip_rgb = mip_rgb
    return bg


# The stop level of the LOD tracer (make_bitgrid_tracer's lod_scale) at a
# ray's distance d is the reference's clip(int(log2(max(d * lod_scale, 1))
# * 0.5), 0, top).  XLA:CPU's f32 log2 and torch's differ in the last bit
# on about a quarter of the inputs, so neither computes it here: level k
# starts at LOD_THRESHOLDS[k - 1], the least f32 x at which the reference's
# formula gives k (found by bisection over the f32 values with XLA:CPU's
# log2; tests/test_torch_lod.py holds each entry and the f32 below it to
# the formula).  Past level 1 each lies a few ulps below 4^k.
LOD_THRESHOLDS = (
    4.0, 15.999999046325684, 63.9999885559082, 255.9999542236328, 1023.9998168945312,
    4095.998291015625, 16383.9931640625, 65535.97265625, 262143.890625, 1048575.5625,
    4194302.25,
)


def lod_stop_level(x, top_level: int):
    """The stop level at ``x = dist * lod_scale`` (f32 [R]): the number of
    thresholds at or below ``x``, at most ``top_level`` (0 for NaN)."""
    t = torch.tensor(LOD_THRESHOLDS[:max(top_level, 0)], dtype=torch.float32, device=x.device)
    return (x[:, None] >= t[None, :]).sum(dim=1).to(torch.int32)


F32_MIN_NORMAL = 2.0**-126


def lod_stop_sq(lod_scale, top_level: int) -> tuple[float, ...]:
    """The stop table of the LOD frame kernel (``csrc/frame.cu``
    ``LodParams.stop_sq``): for each k < ``top_level``, the least f32 ``s``
    at which the reference's stop level of the squared distance ``s``,
    clip(int(log2(max(fl(sqrt(s)) * lod_scale, 1)) * 0.5), 0, top), is above
    k, so that ``s >= stop_sq[k]`` is that test on every f32 ``s``; NaN
    where no ``s`` passes (``lod_scale`` <= 0 or NaN).  The root is
    correctly rounded and the product is by the f32 scale, as the plain
    tracer's ``stop_level``; both are monotone, so the test is monotone in
    ``s`` and a bisection over the f32 bit patterns of [0, inf] finds each
    entry.  The reference runs on XLA:CPU, which flushes subnormal inputs
    and results to zero, so a subnormal ``s`` or scale counts as 0 here:
    every entry is NaN, +inf or at least the least normal f32."""
    k = max(top_level, 0)
    scale = np.float32(lod_scale)
    if abs(float(scale)) < F32_MIN_NORMAL:
        scale = np.float32(0.0)
    sc = torch.tensor(scale)
    t = torch.tensor(LOD_THRESHOLDS[:k], dtype=torch.float32)

    def passes(bits):
        s = bits.to(torch.int32).view(torch.float32)
        s = torch.where(s < F32_MIN_NORMAL, torch.zeros_like(s), s)
        return (sqrt32(s) * sc) >= t

    lo = torch.zeros(k, dtype=torch.int64)
    hi = torch.full((k,), 0x7F800000, dtype=torch.int64)  # +inf
    some = passes(hi)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        up = passes(mid)
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid + 1)
    s2 = torch.where(some, hi.to(torch.int32).view(torch.float32), torch.tensor(float("nan")))
    return tuple(s2.tolist())


def level_dims(size: int, n_levels: int) -> list[int]:
    """Blocks per axis at each level (partial top grids pad to one block)."""
    dims, c = [], int(size)
    for _ in range(n_levels):
        dims.append(max((c + 3) // 4, 1))
        c = dims[-1]
    return dims


def _pack_bits(grid_xyz):
    """bool [c,c,c] (x,y,z) -> ((lo, hi) u32 flat block arrays, coarse grid).

    Flat block index = bx + by*n + bz*n^2; bit s = cx + 4*cy + 16*cz.
    Grids with fewer than 4 cells per axis are zero-padded to one block.
    """
    c = grid_xyz.shape[0]
    if c % 4 != 0:
        target = ((c + 3) // 4) * 4
        padded = np.zeros((target, target, target), dtype=bool)
        padded[:c, :c, :c] = grid_xyz
        grid_xyz = padded
        c = target
    n = c // 4
    g = grid_xyz.reshape(n, 4, n, 4, n, 4)  # [bx, x, by, y, bz, z]
    g = g.transpose(0, 2, 4, 5, 3, 1)  # [bx, by, bz, z, y, x]
    bits = g.reshape(n, n, n, 64)
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    words = (bits.astype(np.uint64) * weights).sum(axis=-1, dtype=np.uint64)
    flat = words.transpose(2, 1, 0).ravel()  # x fastest
    lo = (flat & np.uint64(U32_MASK)).astype(np.uint32)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    coarse = bits.any(axis=-1)  # [bx, by, bz]
    return lo, hi, coarse


def _pack_pyramid(occ_xyz: np.ndarray):
    """Pack a bool [c,c,c] (x,y,z) grid into all pyramid levels:
    ``(levels_lo, levels_hi, bases)``."""
    levels_lo, levels_hi = [], []
    grid = occ_xyz
    while grid.shape[0] > 1:
        lo, hi, coarse = _pack_bits(grid)
        levels_lo.append(lo)
        levels_hi.append(hi)
        grid = coarse
    bases = np.zeros(len(levels_lo), dtype=np.int64)
    for i in range(1, len(levels_lo)):
        bases[i] = bases[i - 1] + len(levels_lo[i - 1])
    return levels_lo, levels_hi, bases


def _pack_bits_batch(occs):
    """:func:`_pack_bits` of K grids of one size at once: bool [K, c, c, c]
    (x, y, z), c a multiple of 4 -> (lo, hi) u32 [K, (c/4)^3], each grid's
    blocks x fastest (the streaming view packs a batch of regions in one
    pass)."""
    K, c = occs.shape[0], occs.shape[1]
    n = c // 4
    g = occs.reshape(K, n, 4, n, 4, n, 4)  # [K, bx, x, by, y, bz, z]
    g = g.transpose(0, 1, 3, 5, 6, 4, 2)  # [K, bx, by, bz, z, y, x]
    bits = g.reshape(K, n, n, n, 64)
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    words = (bits.astype(np.uint64) * weights).sum(axis=-1, dtype=np.uint64)
    flat = words.transpose(0, 3, 2, 1).reshape(K, -1)  # x fastest
    lo = (flat & np.uint64(U32_MASK)).astype(np.uint32)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def bitgrid_from_grids(occ_xyz: np.ndarray, colors: np.ndarray,
                       palette: np.ndarray) -> BitGrid:
    """BitGrid from a bool occupancy grid [x, y, z], its u16 color-index
    grid (flat, x fastest) and an f32 [P, 4] palette."""
    levels_lo, levels_hi, bases = _pack_pyramid(occ_xyz)
    return BitGrid(
        size=int(occ_xyz.shape[0]),
        n_levels=len(levels_lo),
        level_bases=bases,
        occ_lo=np.concatenate(levels_lo),
        occ_hi=np.concatenate(levels_hi),
        colors=np.asarray(colors, dtype=np.uint16),
        palette=np.asarray(palette, dtype=np.float32),
    )


def _dense_from_flat(flat: FlatTree):
    """A FlatTree painted into dense bool occupancy and u16 color grids,
    both [x, y, z]: the plain version of the host library's
    ``rasterize_flat``.  A node key or brick descriptor out of range, or a
    node below the voxel level, raises ``ValueError`` as that does."""
    S, d = flat.size, flat.brick_dim
    occ = np.zeros((S, S, S), dtype=bool)
    col = np.full((S, S, S), COLOR_EMPTY, dtype=np.uint16)

    def paint(desc, x0, y0, z0, extent):
        """Paint one brick descriptor spanning ``extent`` voxels."""
        if desc == EMPTY_DESC:
            return
        sl = np.s_[x0:x0 + extent, y0:y0 + extent, z0:z0 + extent]
        if desc & SOLID_FLAG:
            v = desc & (SOLID_FLAG - 1)
            occ[sl] = True
            col[sl] = COLOR_NONE if v >= COLOR_NONE else v
            return
        if not 0 <= desc < flat.n_bricks:
            raise ValueError("malformed FlatTree: a brick descriptor out of range")
        grid = flat.bricks[desc].reshape(d, d, d).transpose(2, 1, 0)  # [x, y, z]
        if extent >= d:
            f = extent // d
            if f > 1:
                grid = np.repeat(np.repeat(np.repeat(grid, f, 0), f, 1), f, 2)
        else:
            grid = grid[:extent, :extent, :extent]
        occupied = grid != EMPTY_DESC
        colors = np.where(grid >= COLOR_NONE, COLOR_NONE, np.maximum(grid, 0)).astype(np.uint16)
        occ[sl] |= occupied
        csl = col[sl]
        csl[occupied] = colors[occupied]

    def visit(key, x0, y0, z0, size_):
        if key >= flat.n_nodes:
            raise ValueError("malformed FlatTree: a node key out of range")
        if size_ < 1:
            raise ValueError("malformed FlatTree: a node below the voxel level")
        meta = int(flat.node_meta[key])
        cell = size_ // 4
        if meta & META_UNIFORM:
            paint(int(flat.node_children[key, 0]), x0, y0, z0, size_)
            return
        for s in range(BOX_NODE_CHILDREN_COUNT):
            entry = int(flat.node_children[key, s])  # a brick descriptor or a child key
            at = (x0 + (s % 4) * cell, y0 + ((s // 4) % 4) * cell, z0 + (s // 16) * cell)
            if meta & META_LEAF:
                paint(entry, *at, cell)
            elif entry >= 0:
                visit(entry, *at, cell)

    visit(0, 0, 0, 0, S)
    return occ, col


def build_bitgrid(source, native: bool = True) -> BitGrid:
    """The BitGrid of a BoxTree or FlatTree.  ``native``: paint and pack it
    in the host library (:mod:`voxelhex_tpu_torch.native`; a failed build
    raises); ``False`` runs the plain NumPy versions
    (:func:`_dense_from_flat`, :func:`_pack_pyramid`), which give the same
    arrays.  The palette is the FlatTree's, in its order."""
    if isinstance(source, BoxTree):
        source = flatten(source)
    if not isinstance(source, FlatTree):
        raise TypeError(f"build_bitgrid takes a BoxTree or FlatTree, not "
                        f"{type(source).__name__}")
    flat = source
    if native:
        occ_flat, colors = _native.rasterize_flat(flat)
        levels_lo, levels_hi = _native.pack_pyramid(occ_flat, flat.size)
        del occ_flat
        bases = np.cumsum([0] + [len(lo) for lo in levels_lo[:-1]]).astype(np.int64)
    else:
        occ, col = _dense_from_flat(flat)
        levels_lo, levels_hi, bases = _pack_pyramid(occ)
        colors = col.transpose(2, 1, 0).ravel()  # x fastest
    return BitGrid(
        size=int(flat.size),
        n_levels=len(levels_lo),
        level_bases=bases,
        occ_lo=np.concatenate(levels_lo),
        occ_hi=np.concatenate(levels_hi),
        colors=colors,
        palette=flat.palette,
    )


def bitgrid_from_occupancy(occ_xyz: np.ndarray, palette=None) -> BitGrid:
    """BitGrid over a raw boolean occupancy grid [x, y, z]; every occupied
    voxel takes palette index 0."""
    colors = (
        np.where(occ_xyz, 0, COLOR_EMPTY).astype(np.uint16).transpose(2, 1, 0).ravel()
    )
    pal = (
        np.asarray(palette, dtype=np.float32)
        if palette is not None
        else np.ones((1, 4), dtype=np.float32)
    )
    return bitgrid_from_grids(occ_xyz, colors, pal)


def color_grid(colors, color_u8: bool = False) -> np.ndarray:
    """The device color grid of the u16 color indices ``colors`` [S^3]: int16
    (the u16 bit patterns), or with ``color_u8`` uint8 where every real
    index is at most 253, the sentinels ``COLOR_EMPTY`` and ``COLOR_NONE``
    as 255 and 254 (the reference's ``device_bitgrid(..., color_u8=True)``,
    which keeps u16 where the palette does not fit a byte)."""
    cols = np.ascontiguousarray(colors, dtype=np.uint16)
    if color_u8:
        real = cols[cols < COLOR_NONE]
        if real.size == 0 or int(real.max()) <= 253:
            return np.where(cols == COLOR_EMPTY, 255,
                            np.where(cols == COLOR_NONE, 254, cols)).astype(np.uint8)
    return cols.view(np.int16)


def colorless_index(colors) -> int:
    """The least stored index that resolves to a voxel with no color: 254 in
    a u8 color grid, ``COLOR_NONE`` in a u16 one (the reference's
    ``resolve_color`` reads the grid's dtype)."""
    return 254 if colors.dtype == torch.uint8 else COLOR_NONE


def device_bitgrid(bg: BitGrid, device="cuda", skip_rows: bool = False,
                   color_u8: bool = False) -> dict:
    """The tensors the tracer and the shader read, on ``device``:

    * ``occ_pairs`` int32 [B, 2]: the (lo, hi) u32 words as bit patterns
      (read them back with ``& 0xFFFFFFFF`` after widening);
    * ``colors`` int16 [S^3]: the u16 color indices as bit patterns, or with
      ``color_u8`` uint8 where the palette fits a byte (:func:`color_grid`);
    * ``palette`` f32 [P, 4];
    * ``size`` and the pyramid's ``bases`` and ``dims`` as Python ints;
    * with ``skip_rows``, ``skip_rows`` int32 [n0^3, 2L]: the skip tracer's
      rows (:func:`build_skip_rows`) as bit patterns, as the reference's
      ``device_bitgrid(..., skip_rows=True)`` adds them;
    * where ``bg.mip_rgb`` is built (:func:`build_mip_colors`), each level's
      MIP colors as ``mip_rgb_{l}`` f32 [n^3, 3].
    """
    pairs = np.stack([bg.occ_lo, bg.occ_hi], axis=1).astype(np.uint32)
    out = {
        "occ_pairs": torch.from_numpy(pairs.view(np.int32)).to(device),
        "colors": torch.from_numpy(color_grid(bg.colors, color_u8)).to(device),
        "palette": torch.from_numpy(np.asarray(bg.palette, dtype=np.float32)).to(device),
        "size": int(bg.size),
        "bases": [int(b) for b in bg.level_bases],
        "dims": level_dims(bg.size, bg.n_levels),
    }
    if skip_rows:
        out["skip_rows"] = torch.from_numpy(build_skip_rows(bg).view(np.int32)).to(device)
    for l, grid in enumerate(bg.mip_rgb or ()):
        out[f"mip_rgb_{l}"] = torch.from_numpy(np.ascontiguousarray(grid, dtype=np.float32)).to(
            device)
    return out


def skip_row_index(bg: BitGrid) -> np.ndarray:
    """int32 [n0^3, L], n0 = ceil(size / 4): for every level-0 block, the
    index in the pyramid's word pairs of its ancestor at each level (the
    reference's ``skip_row_index``)."""
    n0 = max((int(bg.size) + 3) // 4, 1)
    dims = level_dims(bg.size, bg.n_levels)
    a = np.arange(n0**3)
    ax, ay, az = a % n0, (a // n0) % n0, a // (n0 * n0)
    idx = np.zeros((n0**3, bg.n_levels), dtype=np.int32)
    for k in range(bg.n_levels):
        kx, ky, kz = ax >> (2 * k), ay >> (2 * k), az >> (2 * k)
        idx[:, k] = int(bg.level_bases[k]) + kx + ky * dims[k] + kz * dims[k] * dims[k]
    return idx


def skip_rows_from_pairs(pairs, idx):
    """The skip rows ``[n0^3, 2L]`` from the word pairs ``[B, 2]`` and the
    index of :func:`skip_row_index`: level k's pair in columns 2k and 2k+1
    (the reference's ``skip_rows_from_pairs``; NumPy arrays or tensors)."""
    return pairs[idx].reshape(idx.shape[0], 2 * idx.shape[1])


def build_skip_rows(bg: BitGrid) -> np.ndarray:
    """u32 [n0^3, 2L]: for every level-0 block, the occupancy word pairs of
    the block and of all its ancestors, so that one row fetch holds every
    level of the pyramid over a position (the reference's
    ``build_skip_rows``)."""
    pairs = np.stack([bg.occ_lo, bg.occ_hi], axis=1).astype(np.uint32)
    return skip_rows_from_pairs(pairs, skip_row_index(bg))


def _reach_mask_v(tsect_c, octant):
    """The 64-bit set of sectants a ray entering at ``tsect_c`` with
    direction octant ``octant`` can still touch, as (lo, hi) u32 words held
    in int64: the product of per-axis masks replicated over nibbles, rows
    and planes."""
    t = tsect_c.long()
    sx, sy, sz = t % 4, (t // 4) % 4, t // 16
    xp = (octant & 1) != 0
    zp = (octant & 2) != 0
    yp = (octant & 4) != 0
    nib = torch.full_like(t, 0xF)
    row = torch.full_like(t, 0xFFFF)
    ones = torch.full_like(t, U32_MASK)
    zero = torch.zeros_like(t)
    xm4 = torch.where(xp, (nib << sx) & 0xF, nib >> (3 - sx))
    x32 = xm4 * 0x11111111
    ym16 = torch.where(yp, (row << (sy * 4)) & 0xFFFF, row >> ((3 - sy) * 4))
    y32 = ym16 * 0x00010001
    # z planes: plane k holds bits [16k, 16k+16); lo holds planes 0-1
    low = sz < 2
    z_lo_pos = torch.where(low, (ones << (sz.clamp(max=1) * 16)) & U32_MASK, zero)
    z_hi_pos = torch.where(low, ones, (ones << ((sz - 2).clamp(min=0) * 16)) & U32_MASK)
    z_lo_neg = torch.where(low, ones >> ((1 - sz.clamp(max=1)) * 16), ones)
    z_hi_neg = torch.where(low, zero, ones >> ((3 - sz).clamp(min=0) * 16))
    z_lo = torch.where(zp, z_lo_pos, z_lo_neg)
    z_hi = torch.where(zp, z_hi_pos, z_hi_neg)
    return x32 & y32 & z_lo, x32 & y32 & z_hi


def _level_tables(tree, device):
    """Per-level (base, blocks per axis, block edge) lookup tensors."""
    n_levels = len(tree["bases"])
    return (
        torch.tensor(tree["bases"], dtype=torch.int64, device=device),
        torch.tensor(tree["dims"], dtype=torch.int64, device=device),
        torch.tensor([4.0 ** (l + 1) for l in range(n_levels)], dtype=torch.float32,
                     device=device),
    )


def _block_address(tables, level, bmin, n_pairs):
    """The index in ``occ_pairs`` of the level-``level`` block whose min
    corner is ``bmin``."""
    bases, dims, block = tables
    level = level.long()
    bc = torch.floor(bmin / block[level][:, None]).to(torch.int64)
    n = dims[level]
    addr = bases[level] + bc[:, 0] + bc[:, 1] * n + bc[:, 2] * n * n
    return addr.clamp(0, n_pairs - 1)


def _fetch_words(tree, tables, level, bmin):
    """The (lo, hi) words of the level-``level`` block whose min corner is
    ``bmin``, widened to int64."""
    pairs = tree["occ_pairs"]
    words = pairs[_block_address(tables, level, bmin, pairs.shape[0])].long() & U32_MASK
    return words[:, 0], words[:, 1]


def make_bitgrid_tracer(n_levels: int, size: int, max_iters: int = 2048,
                        max_restarts: int = 4, lateral_step: bool = True,
                        advance_substeps: int = 2, entry_fma=(True, True, False),
                        lod_scale: float = 0.0, parent_skip: bool = False):
    """Plain PyTorch tracer over a pyramid of ``n_levels`` levels and world
    extent ``size``: ``trace(tree, origins, dirs) -> (hit, voxel, hvox,
    point, hnormal)`` over the tensors of :func:`device_bitgrid`.

    ``lateral_step``: on block exit, move straight to the same-level
    neighbor block instead of POP + re-PUSH.  ``advance_substeps``: DDA
    steps inside the current block per iteration (0 or less: an ADVANCE
    moves nothing, as the reference's empty ``range``).  ``parent_skip``: a
    lateral step whose target block is empty by its parent block's
    occupancy words ascends at once instead (the reference's quad rows: the
    words of the parent at its address in ``occ_pairs``, all ones for a
    top-level block).  Each ray stops on a hit,
    on leaving the world after ``max_restarts`` re-entries, or after
    ``max_iters`` iterations.  ``entry_fma``: on which axes the entry point
    ``o + d * enter`` is one fused multiply-add, as XLA:CPU compiles the
    reference program being matched (the renderer's frame: x and y; the
    beam prepass: z alone).

    ``lod_scale`` > 0 is the reference's distance LOD: a ray stops on an
    occupied cell of any level at or below its stop level, which each step
    takes from the distance of its point to the ray's origin
    (:func:`lod_stop_level`); ``st["hlev"]`` is the level of the hit and
    ``trace.trace_lod`` resolves its color from the MIP grids
    (``resolve_rgb_lod``)."""
    top_level = n_levels - 1
    lod = float(lod_scale) > 0.0
    lod_f32 = float(np.float32(lod_scale))
    Si = int(size)
    cell_sizes = [float(4**l) for l in range(n_levels)]
    top_block = cell_sizes[top_level] * 4.0

    def init(tree, o, dirv, start_t=None):
        """The state of rays (o, dirv) at their entry into the world box.
        ``start_t`` (f32 [R]): each ray starts at least that far along,
        clipped to just inside its exit; a ray that starts at or beyond its
        exit is inactive from the start (the reference's ``start_t``)."""
        R = o.shape[0]
        dev = o.device
        size = torch.tensor(float(tree["size"]), dtype=torch.float32, device=dev)
        dx, dy, dz = dirv[:, 0], dirv[:, 1], dirv[:, 2]
        sq = [
            fma32(dy / dx, dy / dx, fma32(dz / dx, dz / dx, 1.0)),
            fma32(dz / dy, dz / dy, fma32(dx / dy, dx / dy, 1.0)),
            fma32(dx / dz, dx / dz, (dy / dz) * (dy / dz)) + 1.0,
        ]
        sf = sqrt32(torch.stack(sq, dim=-1))
        octant = (
            (dx >= 0).int() + (dz >= 0).int() * 2 + (dy >= 0).int() * 4
        )
        t_lo = (0.0 - o) / dirv
        t_hi = (size - o) / dirv
        per_min = fmin_nan(t_lo, t_hi)
        per_max = fmax_nan(t_lo, t_hi)
        tmin_r = fmax_nan(fmax_nan(per_min[:, 0], per_min[:, 1]), per_min[:, 2])
        tmax_r = fmin_nan(fmin_nan(per_max[:, 0], per_max[:, 1]), per_max[:, 2])
        root_hit = ~((tmax_r < 0.0) | (tmin_r > tmax_r))
        zero = torch.zeros_like(tmin_r)
        enter = maximum(tmin_r, zero)
        if start_t is not None:
            # the reference's order: clip(max(enter, start_t), 0, max(tmax_r - 1e-3, 0))
            root_hit = root_hit & (start_t < tmax_r)
            enter = minimum(maximum(zero, maximum(enter, start_t)),
                            maximum(tmax_r - 1e-3, zero))
        # XLA's vector loop of the renderer's frame fuses the multiply-add on
        # x and y but not on z (entry_fma)
        step = dirv * enter[:, None]
        point = torch.stack(
            [fma32(dirv[:, c], enter, o[:, c]) if entry_fma[c] else o[:, c] + step[:, c]
             for c in range(3)], dim=1)

        level = torch.full((R,), top_level, dtype=torch.int32, device=dev)
        lo, hi = _fetch_words(tree, _level_tables(tree, dev), level, torch.zeros_like(o))
        tsect = torch.where(
            root_hit,
            _offset_sectant_v(point, torch.full((R,), top_block, device=dev)),
            torch.full((R,), OOB, dtype=torch.int32, device=dev),
        )
        tmin = _sectant_offset_v(tsect.clamp(0, 63)) * top_block
        return {
            "point": point, "tsect": tsect, "tmin": tmin,
            "tsize": torch.full((R,), cell_sizes[top_level], device=dev),
            "level": level, "lo": lo, "hi": hi, "dirv": dirv, "sf": sf,
            "octant": octant, "active": root_hit,
            "hit": torch.zeros(R, dtype=torch.bool, device=dev),
            "hvox": torch.zeros((R, 3), dtype=torch.int32, device=dev),
            "hnormal": torch.zeros((R, 3), dtype=torch.float32, device=dev),
            "restarts": torch.zeros(R, dtype=torch.int32, device=dev),
            "bmin": torch.zeros((R, 3), dtype=torch.float32, device=dev),
            "iters": torch.zeros(R, dtype=torch.int32, device=dev),  # steps taken
        } | ({"origin": o, "hlev": torch.zeros(R, dtype=torch.int32, device=dev)} if lod
             else {})

    def stop_level(point, origin):
        """The LOD stop level at ``point``: |point - o| (the squares summed
        in order, unfused) times ``lod_scale``, through the threshold
        table."""
        x = point - origin
        dist = sqrt32((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])
        return lod_stop_level(dist * lod_f32, top_level)

    def body(tree, tables, st, record=False):
        """One automaton step for rays that are all active; with ``record``,
        ``st["move"]`` is each ray's move."""
        point, tsect, tmin, tsize = st["point"], st["tsect"], st["tmin"], st["tsize"]
        level, lo, hi, bmin = st["level"], st["lo"], st["hi"], st["bmin"]
        dirv, sf = st["dirv"], st["sf"]
        R = point.shape[0]
        dev = point.device
        size = float(tree["size"])

        inb = tsect < OOB
        occupied = _occ_bit_v(lo, hi, tsect) != 0
        m_lo, m_hi = _reach_mask_v(tsect.clamp(0, 63), st["octant"])
        no_overlap = ((lo & m_lo) == 0) & ((hi & m_hi) == 0)
        at_bottom = level <= (stop_level(point, st["origin"]) if lod else 0)
        found = occupied & at_bottom & inb
        normal = _impact_normal_v(tmin, tsize, point)
        st["hit"] = st["hit"] | found
        st["hvox"] = torch.where(found[:, None], tmin.to(torch.int32), st["hvox"])
        st["hnormal"] = torch.where(found[:, None], normal, st["hnormal"])
        if lod:
            st["hlev"] = torch.where(found, level, st["hlev"])
        active = ~found

        descend = active & occupied & ~at_bottom & inb
        if lateral_step:
            lateral = active & ~inb & ~descend
            ascend = active & no_overlap & ~descend & ~lateral
        else:
            lateral = torch.zeros_like(active)
            ascend = active & (~inb | no_overlap) & ~descend
        advance = active & ~descend & ~ascend & ~lateral

        # DESCEND into the occupied cell
        d_tsect = _offset_sectant_v(point - tmin, tsize)
        d_tmin = tmin + _sectant_offset_v(d_tsect) * tsize[:, None]

        # ASCEND: the parent block, derived arithmetically
        block = tsize * 4.0
        parent_block = block * 4.0
        parent_min = bmin - _floor_mod(bmin, parent_block[:, None])
        a_ts0 = _offset_sectant_v(bmin + block[:, None] / 2.0 - parent_min, parent_block)
        # XLA:CPU fuses the block DDA's multiply-add on x only where the
        # ADVANCE's substeps exist: with none, on y and z alone
        a_new_p, a_step = _dda_step_v(dirv, sf, point, bmin, block,
                                      (advance_substeps > 0, True, True))
        a_ts = _step_sectant_v(a_ts0, a_step)
        a_tmin = bmin + a_step * block[:, None]

        if parent_skip:
            # the lateral step's target block is empty by its parent's
            # words: ascend now (a top-level block's parent words are all ones)
            p_lo, p_hi = _fetch_words(tree, tables, (level + 1).clamp(max=top_level), bmin)
            top = level >= top_level
            p_lo = torch.where(top, U32_MASK, p_lo)
            p_hi = torch.where(top, U32_MASK, p_hi)
            skip = lateral & (a_ts < OOB) & (_occ_bit_v(p_lo, p_hi, a_ts) == 0)
            lateral = lateral & ~skip
            ascend = ascend | skip

        # ADVANCE: DDA substeps inside the current block
        v_ts, v_tmin, v_p, v_go = tsect, tmin, point, advance
        n_sub = torch.zeros_like(level)  # the substeps each ray takes
        for _ in range(advance_substeps):
            n_sub = n_sub + v_go.int()
            s_new_p, s_step = _dda_step_v(dirv, sf, v_p, v_tmin, tsize)
            s_ts = _step_sectant_v(v_ts, s_step)
            s_tmin = torch.where(
                (s_ts < OOB)[:, None], v_tmin + s_step * tsize[:, None], v_tmin
            )
            v_p = torch.where(v_go[:, None], s_new_p, v_p)
            v_ts = torch.where(v_go, s_ts, v_ts)
            v_tmin = torch.where(v_go[:, None], s_tmin, v_tmin)
            stop = (v_ts >= OOB) | (_occ_bit_v(lo, hi, v_ts) != 0)
            v_go = v_go & ~stop

        # LATERAL: the same-level neighbor block
        l_bmin = bmin + a_step * block[:, None]
        l_tsect = _offset_sectant_v(a_new_p - l_bmin, block)
        l_tmin = l_bmin + _sectant_offset_v(l_tsect.clamp(0, 63)) * block[:, None]
        l_out = lateral & ((l_bmin < 0.0) | (l_bmin >= size)).any(dim=-1)
        active = active & ~l_out
        lateral = lateral & ~l_out

        point = torch.where(advance[:, None], v_p, point)
        point = torch.where((ascend | lateral)[:, None], a_new_p, point)
        tsect = torch.where(descend, d_tsect, tsect)
        tsect = torch.where(ascend, a_ts, tsect)
        tsect = torch.where(lateral, l_tsect, tsect)
        tsect = torch.where(advance, v_ts, tsect)
        new_tmin = torch.where(descend[:, None], d_tmin, tmin)
        new_tmin = torch.where(ascend[:, None], a_tmin, new_tmin)
        new_tmin = torch.where(lateral[:, None], l_tmin, new_tmin)
        new_tmin = torch.where(advance[:, None], v_tmin, new_tmin)
        tsize = torch.where(descend, tsize / 4.0, tsize)
        tsize = torch.where(ascend, block, tsize)
        level = torch.where(descend, level - 1, level)
        level = torch.where(ascend, level + 1, level)
        bmin = torch.where(descend[:, None], tmin, bmin)
        bmin = torch.where(ascend[:, None], parent_min, bmin)
        bmin = torch.where(lateral[:, None], l_bmin, bmin)
        tmin = new_tmin

        # exit, or restart a little further on, when ascending past the top
        restarts = st["restarts"]
        over_top = active & (level > top_level)
        re_point = point + dirv * 0.1  # not fused in the reference
        inside = ((re_point > 0.0) & (re_point < size)).all(dim=-1)
        can_restart = over_top & inside & (restarts < max_restarts)
        restarts = restarts + over_top.int()
        point = torch.where(over_top[:, None], re_point, point)
        active = active & (~over_top | can_restart)
        r_ts = _offset_sectant_v(point, torch.full((R,), top_block, device=dev))
        tsect = torch.where(can_restart, r_ts, tsect)
        tmin = torch.where(
            can_restart[:, None], _sectant_offset_v(r_ts.clamp(0, 63)) * top_block, tmin
        )
        tsize = torch.where(can_restart, torch.full_like(tsize, cell_sizes[top_level]), tsize)
        level = torch.where(can_restart, torch.full_like(level, top_level), level)
        bmin = torch.where(can_restart[:, None], torch.zeros_like(bmin), bmin)

        # one fetch for the rays whose block changed
        moved = descend | ascend | lateral | can_restart
        f_lo, f_hi = _fetch_words(tree, tables, level.clamp(0, top_level), bmin)
        if record:
            move = torch.where(found, MOVE_HIT, MOVE_ADVANCE + n_sub)
            move = torch.where(descend, MOVE_DESCEND, move)
            move = torch.where(ascend, MOVE_ASCEND, move)
            move = torch.where(over_top, MOVE_RESTART, move)
            move = torch.where(lateral | l_out, MOVE_LATERAL, move)
            st["move"] = move.to(torch.int8)
        st.update(
            point=point, tsect=tsect, tmin=tmin, tsize=tsize, level=level,
            lo=torch.where(moved, f_lo, lo), hi=torch.where(moved, f_hi, hi),
            bmin=bmin, restarts=restarts, active=active, iters=st["iters"] + 1,
        )
        return st

    def run(tree, st, iters, moves=None, reads=None):
        """Advance up to ``iters`` iterations, stepping only active rays
        (inactive rays are fixed points of the step).  With a list
        ``moves``, append each iteration's move of every ray to it (int8
        [R], the ``MOVE_*`` codes; ``MOVE_NONE`` for a ray that took no
        step).  With a bool tensor ``reads`` over ``occ_pairs``, set the
        entry of each block an active ray holds: the word pairs the march
        reads.  Both are off on every path, for measuring the automaton."""
        tables = _level_tables(tree, st["point"].device)
        n_pairs = tree["occ_pairs"].shape[0]

        def mark(s):
            reads[_block_address(tables, s["level"].clamp(0, top_level), s["bmin"],
                                 n_pairs)] = True

        if reads is not None:
            mark({k: st[k][st["active"]] for k in ("level", "bmin")})
        for _ in range(iters):
            idx = torch.nonzero(st["active"]).squeeze(1)
            if idx.numel() == 0:
                break
            sub = body(tree, tables, {k: v[idx] for k, v in st.items()}, moves is not None)
            if reads is not None:
                mark(sub)
            if moves is not None:
                row = torch.full_like(st["iters"], MOVE_NONE, dtype=torch.int8)
                row[idx] = sub.pop("move")
                moves.append(row)
            for k, v in sub.items():
                st[k][idx] = v
        return st

    def resolve_color(tree, hit, hvox):
        v = hvox.clamp(0, Si - 1).long()
        caddr = v[:, 0] + v[:, 1] * Si + v[:, 2] * Si * Si
        colors = tree["colors"]
        cidx = colors[caddr].int() & 0xFFFF
        cidx = torch.where(cidx >= colorless_index(colors), torch.full_like(cidx, NO_COLOR_HIT),
                           cidx)
        return torch.where(hit, cidx, torch.full_like(cidx, EMPTY_DESC))

    def resolve_rgb_lod(tree, hit, hvox, hlev):
        """The hit's albedo [R, 3]: from the palette at level 0 (0 for a
        voxel with no color), from the MIP grid ``mip_rgb_{l - 1}`` of
        :func:`device_bitgrid` at level l > 0 (the reference's
        ``resolve_rgb_lod``)."""
        voxel = resolve_color(tree, hit, hvox)
        pal = tree["palette"]
        has_color = hit & (voxel >= 0) & (voxel < NO_COLOR_HIT)
        base = pal[voxel.clamp(0, pal.shape[0] - 1).long(), :3]
        rgb = torch.where(has_color[:, None], base, torch.zeros_like(base))
        for l in range(1, n_levels + 1):
            grid = tree.get(f"mip_rgb_{l - 1}")
            if grid is None:
                break
            n = max(Si // 4**l, 1)
            cv = (hvox // 4**l).clamp(0, n - 1).long()
            addr = (cv[:, 0] + cv[:, 1] * n + cv[:, 2] * n * n).clamp(0, grid.shape[0] - 1)
            rgb = torch.where(((hlev == l) & hit)[:, None], grid[addr], rgb)
        return rgb

    def trace(tree, o, dirv):
        st = run(tree, init(tree, o, dirv), max_iters)
        voxel = resolve_color(tree, st["hit"], st["hvox"])
        return st["hit"], voxel, st["hvox"], st["point"], st["hnormal"]

    def trace_lod(tree, o, dirv):
        """``(hit, rgb, hvox, point, hnormal)``: the march, and each hit's
        albedo from the level it stopped at."""
        st = run(tree, init(tree, o, dirv), max_iters)
        hlev = st.get("hlev", torch.zeros_like(st["iters"]))
        rgb = resolve_rgb_lod(tree, st["hit"], st["hvox"], hlev)
        return st["hit"], rgb, st["hvox"], st["point"], st["hnormal"]

    trace.init = init
    trace.run = run
    trace.resolve_color = resolve_color
    trace.resolve_rgb_lod = resolve_rgb_lod
    trace.trace_lod = trace_lod
    return trace



def make_multihit_tracer(n_levels: int, size: int, max_hits: int = 4, max_iters: int = 2048,
                         skip_substeps: int | None = None, **settings):
    """Plain PyTorch multi-hit march over a pyramid of ``n_levels`` levels:
    ``trace(tree, origins, dirs, start_t=None) -> (count int32 [R], voxels
    int32 [R, K, 3], dists f32 [R, K])``, K = ``max_hits``; an empty slot
    holds voxel -1 and distance inf.  ``start_t`` (f32 [R]): each ray starts
    at least that far along, and a ray whose start is at or past its box
    exit has no hits (the tracers' start form).  With ``with_steps=True``
    it also returns each ray's steps (int32 [R]: automaton steps, or the
    skip tracer's body iterations); ``reads`` goes to the march's ``run``
    (over the word pairs, or over the skip rows).  ``settings`` go to
    :func:`make_bitgrid_tracer`.

    Each ray marches with the single-hit automaton (``init`` / ``run``);
    on a hit it records the voxel and ``|point - o|`` at its cursor, the
    hit voxel's bit is cleared in the ray's register words ``lo`` / ``hi``
    and the ray resumes at the same cell (the reference's ``_hit_step``,
    ``voxelhex_tpu/diff/soft.py:189``).  ``restarts`` carries across hits.
    A ray takes at most ``max_hits * max_iters`` steps in all, a hit's step
    included: the reference's global budget, which its lock-step rounds
    spend the same way unless a ray comes near it.

    With ``skip_substeps`` (None: the stack automaton) it marches the skip
    tracer (:func:`make_skip_tracer`, ``skip_substeps`` substeps) instead,
    as ``_hit_step``'s skip branch
    drives it: the hit ends its body iteration, whose end fetches the row
    of the hit voxel, and then the voxel's bit is cleared in the row's
    level-0 pair; ``max_hits * max_iters`` body iterations a ray."""
    skip = skip_substeps is not None
    if skip:
        base = make_skip_tracer(n_levels, size, max_iters, skip_substeps)
    else:
        base = make_bitgrid_tracer(n_levels, size, max_iters=max_iters, **settings)
    K = int(max_hits)

    def trace(tree, o, dirv, start_t=None, with_steps=False, reads=None):
        R = o.shape[0]
        dev = o.device
        st = base.init(tree, o, dirv, start_t)
        def run(s):
            return base.run(tree, s, 1, reads=reads)

        voxels = torch.full((R, K, 3), -1, dtype=torch.int32, device=dev)
        dists = torch.full((R, K), float("inf"), dtype=torch.float32, device=dev)
        cursor = torch.zeros(R, dtype=torch.int64, device=dev)
        # every unfinished ray steps once per pass, so a ray's steps are the
        # passes it took part in
        for _ in range(K * max_iters):
            if not bool(st["active"].any()):
                break
            st = run(st)
            idx = torch.nonzero(st["hit"]).squeeze(1)
            if idx.numel() == 0:
                continue
            k = cursor[idx]
            voxels[idx, k] = st["hvox"][idx]
            x = st["point"][idx] - o[idx]
            # XLA:CPU fuses the norm's sum of squares into two multiply-adds
            sq = fma32(x[:, 2], x[:, 2], fma32(x[:, 1], x[:, 1], x[:, 0] * x[:, 0]))
            dists[idx, k] = sqrt32(sq)
            cursor[idx] = k + 1
            st["hit"][idx] = False
            more = idx[k + 1 < K]
            if skip:
                w = st["v"][more].long() & 3
                s = w[:, 0] + w[:, 1] * 4 + w[:, 2] * 16
                lo, hi = st["rows"][more, 0], st["rows"][more, 1]
            else:
                s = st["tsect"][more].clamp(0, 63).long()
                lo, hi = st["lo"][more], st["hi"][more]
            bit = torch.ones_like(s) << (s % 32)
            low = s < 32
            lo = torch.where(low, lo & ~bit, lo)
            hi = torch.where(low, hi, hi & ~bit)
            if skip:
                st["rows"][more, 0], st["rows"][more, 1] = lo, hi
            else:
                st["lo"][more], st["hi"][more] = lo, hi
            st["active"][more] = True
        out = (cursor.int(), voxels, dists)
        return out + (st["iters"],) if with_steps else out

    return trace

def _to_i32(x):
    """``x.astype(int32)`` as XLA converts: toward zero, saturating at the
    int32 range, NaN to 0."""
    x = torch.nan_to_num(x.double(), nan=0.0).clamp(-2.0**31, 2.0**31 - 1)
    return x.to(torch.int64).to(torch.int32)


def make_skip_tracer(n_levels: int, size: int, max_iters: int = 2048, substeps: int = 3,
                     entry_fma=SKIP_ENTRY_FMA):
    """Plain PyTorch skip tracer over a pyramid of ``n_levels`` levels and
    world extent ``size`` (the reference's ``make_skip_tracer``):
    ``trace(tree, origins, dirs, start_t=None) -> (hit, voxel, hvox, point,
    hnormal)`` over the tensors of :func:`device_bitgrid` with
    ``skip_rows``.

    The first occupied voxel along each ray, with no stack and no restart.
    At the end of each body iteration a ray fetches the one row of its
    level-0 block (:func:`build_skip_rows`), which holds that block's word
    pair and every ancestor's.  Each of the body's ``substeps`` substeps
    tests the voxel bit where the level-0 pair is valid (a hit); else it
    takes the largest level whose pair is valid for the voxel (``blk == b0
    >> 2k``) and whose cell is empty, and makes one DDA step across that
    cell, in integer voxel coordinates.  A ray stops when it leaves ``[0,
    S)``, and after ``max_iters`` body iterations.  ``entry_fma``: on which
    axes XLA:CPU fuses the entry point's multiply-add in the reference's
    program."""
    L = int(n_levels)
    Si = int(size)
    n0 = max((Si + 3) // 4, 1)

    def row_of(b0):
        return b0[:, 0].long() + b0[:, 1].long() * n0 + b0[:, 2].long() * n0 * n0

    def fetch(tree, v):
        b0 = (v >> 2).clamp(0, n0 - 1)
        return tree["skip_rows"][row_of(b0)].long() & U32_MASK, b0

    def init(tree, o, dirv, start_t=None):
        R = o.shape[0]
        dev = o.device
        S = torch.tensor(float(tree["size"]), dtype=torch.float32, device=dev)
        dx, dy, dz = dirv[:, 0], dirv[:, 1], dirv[:, 2]
        sq = [
            fma32(dy / dx, dy / dx, fma32(dz / dx, dz / dx, 1.0)),
            fma32(dz / dy, dz / dy, fma32(dx / dy, dx / dy, 1.0)),
            fma32(dx / dz, dx / dz, (dy / dz) * (dy / dz)) + 1.0,
        ]
        sf = sqrt32(torch.stack(sq, dim=-1))
        t_lo = (0.0 - o) / dirv
        t_hi = (S - o) / dirv
        per_min = fmin_nan(t_lo, t_hi)
        per_max = fmax_nan(t_lo, t_hi)
        tmin_r = fmax_nan(fmax_nan(per_min[:, 0], per_min[:, 1]), per_min[:, 2])
        tmax_r = fmin_nan(fmin_nan(per_max[:, 0], per_max[:, 1]), per_max[:, 2])
        root_hit = ~((tmax_r < 0.0) | (tmin_r > tmax_r))
        zero = torch.zeros_like(tmin_r)
        enter = maximum(tmin_r, zero)
        if start_t is not None:
            root_hit = root_hit & (start_t < tmax_r)
            enter = minimum(maximum(zero, maximum(enter, start_t)),
                            maximum(tmax_r - 1e-3, zero))
        step = dirv * enter[:, None]
        point = torch.stack(
            [fma32(dirv[:, c], enter, o[:, c]) if entry_fma[c] else o[:, c] + step[:, c]
             for c in range(3)], dim=1)
        v = _to_i32(torch.floor(point)).clamp(0, Si - 1)
        rows, b0 = fetch(tree, v)
        return {
            "point": point, "v": v, "rows": rows, "b0": b0, "dirv": dirv, "sf": sf,
            "active": root_hit,
            "hit": torch.zeros(R, dtype=torch.bool, device=dev),
            "hvox": torch.zeros((R, 3), dtype=torch.int32, device=dev),
            "hnormal": torch.zeros((R, 3), dtype=torch.float32, device=dev),
            "iters": torch.zeros(R, dtype=torch.int32, device=dev),  # body iterations
            # the row fetches of a march: at entry, and at the end of each
            # body iteration after which the ray marches on
            "fetches": root_hit.int(),
        }

    def body(tree, st):
        """One body iteration of rays that are all active: ``substeps``
        substeps, then the row fetch at the voxel reached."""
        p, vv, act = st["point"], st["v"], st["active"]
        rows, b0 = st["rows"], st["b0"]
        dirv, sf = st["dirv"], st["sf"]
        hit, hvox, hnormal = st["hit"], st["hvox"], st["hnormal"]
        R = p.shape[0]
        ones = torch.ones(R, dtype=torch.float32, device=p.device)
        for _ in range(substeps):
            valids, occs = [], []
            for k in range(L):
                cell = vv >> (2 * k)
                valids.append(((cell >> 2) == (b0 >> (2 * k))).all(dim=-1))
                w = cell & 3
                s = w[:, 0] + w[:, 1] * 4 + w[:, 2] * 16
                occs.append(_occ_bit_v(rows[:, 2 * k], rows[:, 2 * k + 1], s) != 0)
            found = act & valids[0] & occs[0]
            nrm = _impact_normal_v(vv.float(), ones, p)
            hit = hit | found
            hvox = torch.where(found[:, None], vv, hvox)
            hnormal = torch.where(found[:, None], nrm, hnormal)
            act = act & ~found
            # the largest valid empty cell: the level to skip across
            k_sel = torch.full((R,), -1, dtype=torch.int32, device=p.device)
            for k in range(L):
                k_sel = torch.where(valids[k] & ~occs[k], k, k_sel)
            can_adv = act & (k_sel >= 0)  # else the row is stale: wait for the fetch
            csz = (torch.ones_like(k_sel) << (2 * k_sel.clamp(min=0)))[:, None]
            cmin = (vv // csz) * csz
            new_p, stp = _dda_step_v(dirv, sf, p, cmin.float(), csz[:, 0].float(),
                                     SKIP_DDA_FMA)
            sti = _to_i32(stp)
            v_cross = (cmin // csz + sti) * csz + torch.where(sti > 0, 0, csz - 1)
            v_stay = torch.minimum(torch.maximum(_to_i32(torch.floor(new_p)), cmin),
                                   cmin + csz - 1)
            v_new = torch.where(sti != 0, v_cross, v_stay)
            out = ((v_new < 0) | (v_new >= Si)).any(dim=-1)
            act = act & ~(can_adv & out)
            apply = can_adv & ~out
            p = torch.where(apply[:, None], new_p, p)
            vv = torch.where(apply[:, None], v_new, vv)
        rows, b0 = fetch(tree, vv)
        st.update(point=p, v=vv, rows=rows, b0=b0, active=act, hit=hit, hvox=hvox,
                  hnormal=hnormal, iters=st["iters"] + 1, fetches=st["fetches"] + act.int())
        return st

    def run(tree, st, iters, reads=None):
        """Up to ``iters`` body iterations of the active rays (inactive rays
        are fixed points of the body).  With a bool tensor ``reads`` over
        the skip rows, set the entry of each row that an active ray fetches:
        the rows the march reads (off on every path, for measuring)."""
        if reads is not None:
            reads[row_of(st["b0"][st["active"]])] = True
        for _ in range(iters):
            idx = torch.nonzero(st["active"]).squeeze(1)
            if idx.numel() == 0:
                break
            sub = body(tree, {k: v[idx] for k, v in st.items()})
            if reads is not None:
                reads[row_of(sub["b0"][sub["active"]])] = True
            for k, v in sub.items():
                st[k][idx] = v
        return st

    def resolve_color(tree, hit, hvox):
        v = hvox.clamp(0, Si - 1).long()
        caddr = v[:, 0] + v[:, 1] * Si + v[:, 2] * Si * Si
        colors = tree["colors"]
        cidx = colors[caddr].int() & 0xFFFF
        cidx = torch.where(cidx >= colorless_index(colors), torch.full_like(cidx, NO_COLOR_HIT),
                           cidx)
        return torch.where(hit, cidx, torch.full_like(cidx, EMPTY_DESC))

    def trace(tree, o, dirv, start_t=None):
        st = run(tree, init(tree, o, dirv, start_t), max_iters)
        voxel = resolve_color(tree, st["hit"], st["hvox"])
        return st["hit"], voxel, st["hvox"], st["point"], st["hnormal"]

    trace.init = init
    trace.run = run
    trace.resolve_color = resolve_color
    return trace


def _floor_mod(x, y):
    """``jnp.mod`` on floats: the remainder takes the sign of ``y``."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)
