"""BitGrid: the dense occupancy pyramid and its plain tracer.

Level ``l`` of the pyramid splits space into cells of ``4**l`` voxels; each
4x4x4 group of cells (a "block") stores its 64 occupancy bits as a (lo, hi)
u32 word pair, addressed arithmetically from the block's coordinates.  The
tracer runs the sectant automaton (PUSH/POP/ADVANCE) over it: DESCEND and
ASCEND fetch one word pair, ADVANCE is arithmetic inside the current block.
Color resolves after the march with one gather from a dense u16 grid.

On the card the tracer is the CUDA kernel of :mod:`voxelhex_tpu_torch.ops.
traverse`; :func:`make_bitgrid_tracer` here is its plain PyTorch version,
bit-equal to the reference's ``make_bitgrid_tracer``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from voxelhex_tpu_torch.constants import (
    COLOR_EMPTY,
    COLOR_NONE,
    EMPTY_DESC,
    NO_COLOR_HIT,
    OOB,
)
from voxelhex_tpu_torch.fp import fma32, fmax_nan, fmin_nan, maximum, sqrt32
from voxelhex_tpu_torch.render.wavefront import (
    _dda_step_v,
    _impact_normal_v,
    _occ_bit_v,
    _offset_sectant_v,
    _sectant_offset_v,
    _step_sectant_v,
)

U32_MASK = 0xFFFFFFFF


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


def device_bitgrid(bg: BitGrid, device="cuda") -> dict:
    """The tensors the tracer and the shader read, on ``device``:

    * ``occ_pairs`` int32 [B, 2]: the (lo, hi) u32 words as bit patterns
      (read them back with ``& 0xFFFFFFFF`` after widening);
    * ``colors`` int16 [S^3]: the u16 color indices as bit patterns;
    * ``palette`` f32 [P, 4];
    * ``size`` and the pyramid's ``bases`` and ``dims`` as Python ints.
    """
    pairs = np.stack([bg.occ_lo, bg.occ_hi], axis=1).astype(np.uint32)
    return {
        "occ_pairs": torch.from_numpy(pairs.view(np.int32)).to(device),
        "colors": torch.from_numpy(
            np.ascontiguousarray(bg.colors, dtype=np.uint16).view(np.int16)
        ).to(device),
        "palette": torch.from_numpy(np.asarray(bg.palette, dtype=np.float32)).to(device),
        "size": int(bg.size),
        "bases": [int(b) for b in bg.level_bases],
        "dims": level_dims(bg.size, bg.n_levels),
    }


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


def _fetch_words(tree, tables, level, bmin):
    """The (lo, hi) words of the level-``level`` block whose min corner is
    ``bmin``, widened to int64."""
    bases, dims, block = tables
    level = level.long()
    bc = torch.floor(bmin / block[level][:, None]).to(torch.int64)
    n = dims[level]
    addr = bases[level] + bc[:, 0] + bc[:, 1] * n + bc[:, 2] * n * n
    pairs = tree["occ_pairs"]
    addr = addr.clamp(0, pairs.shape[0] - 1)
    words = pairs[addr].long() & U32_MASK
    return words[:, 0], words[:, 1]


def make_bitgrid_tracer(n_levels: int, size: int, max_iters: int = 2048,
                        max_restarts: int = 4, lateral_step: bool = True,
                        advance_substeps: int = 2):
    """Plain PyTorch tracer over a pyramid of ``n_levels`` levels and world
    extent ``size``: ``trace(tree, origins, dirs) -> (hit, voxel, hvox,
    point, hnormal)`` over the tensors of :func:`device_bitgrid`.

    ``lateral_step``: on block exit, move straight to the same-level
    neighbor block instead of POP + re-PUSH.  ``advance_substeps``: DDA
    steps inside the current block per iteration.  Each ray stops on a hit,
    on leaving the world after ``max_restarts`` re-entries, or after
    ``max_iters`` iterations."""
    top_level = n_levels - 1
    Si = int(size)
    cell_sizes = [float(4**l) for l in range(n_levels)]
    top_block = cell_sizes[top_level] * 4.0

    def init(tree, o, dirv):
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
        enter = maximum(tmin_r, torch.zeros_like(tmin_r))
        # XLA's vector loop fuses the multiply-add on x and y but not on z
        step = dirv * enter[:, None]
        point = torch.cat(
            [fma32(dirv[:, :2], enter[:, None], o[:, :2]), o[:, 2:] + step[:, 2:]], dim=1
        )

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
        }

    def body(tree, tables, st):
        """One automaton step for rays that are all active."""
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
        at_bottom = level <= 0
        found = occupied & at_bottom & inb
        normal = _impact_normal_v(tmin, tsize, point)
        st["hit"] = st["hit"] | found
        st["hvox"] = torch.where(found[:, None], tmin.to(torch.int32), st["hvox"])
        st["hnormal"] = torch.where(found[:, None], normal, st["hnormal"])
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
        a_new_p, a_step = _dda_step_v(dirv, sf, point, bmin, block)
        a_ts = _step_sectant_v(a_ts0, a_step)
        a_tmin = bmin + a_step * block[:, None]

        # ADVANCE: DDA substeps inside the current block
        v_ts, v_tmin, v_p, v_go = tsect, tmin, point, advance
        for _ in range(advance_substeps):
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
        st.update(
            point=point, tsect=tsect, tmin=tmin, tsize=tsize, level=level,
            lo=torch.where(moved, f_lo, lo), hi=torch.where(moved, f_hi, hi),
            bmin=bmin, restarts=restarts, active=active, iters=st["iters"] + 1,
        )
        return st

    def run(tree, st, iters):
        """Advance up to ``iters`` iterations, stepping only active rays
        (inactive rays are fixed points of the step)."""
        tables = _level_tables(tree, st["point"].device)
        for _ in range(iters):
            idx = torch.nonzero(st["active"]).squeeze(1)
            if idx.numel() == 0:
                break
            sub = body(tree, tables, {k: v[idx] for k, v in st.items()})
            for k, v in sub.items():
                st[k][idx] = v
        return st

    def resolve_color(tree, hit, hvox):
        v = hvox.clamp(0, Si - 1).long()
        caddr = v[:, 0] + v[:, 1] * Si + v[:, 2] * Si * Si
        cidx = tree["colors"][caddr].int() & 0xFFFF
        cidx = torch.where(cidx >= COLOR_NONE, torch.full_like(cidx, NO_COLOR_HIT), cidx)
        return torch.where(hit, cidx, torch.full_like(cidx, EMPTY_DESC))

    def trace(tree, o, dirv):
        st = run(tree, init(tree, o, dirv), max_iters)
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
