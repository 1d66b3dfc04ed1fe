"""Vector helpers of the sectant automaton, on ``[R]``-batched tensors.

Counterparts of the reference's ``render/wavefront.py`` helpers.  Each keeps
the reference's operation order and its NaN and signed-zero semantics, so
the plain tracer is bit-equal to the reference on XLA:CPU.
"""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.constants import BOX_NODE_DIMENSION, OOB
from voxelhex_tpu_torch.fp import fma32, maximum, sqrt32

BIG = 1e30


def sign(x):
    """``jnp.sign``: +-1, and zero (keeping its sign) or NaN as given."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _clip_to_int(x, hi):
    """``clip(x, 0, hi).astype(int32)``; NaN becomes 0."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=hi, neginf=0.0), 0, hi)
    return x.to(torch.int32)


def _offset_sectant_v(offset, size):
    """[R,3] offsets in a cell of edge ``size`` [R] -> [R] sectant indices."""
    idx = _clip_to_int(
        torch.floor(offset * BOX_NODE_DIMENSION / size[:, None]),
        BOX_NODE_DIMENSION - 1,
    )
    return idx[:, 0] + idx[:, 1] * 4 + idx[:, 2] * 16


def _sectant_offset_v(sectant):
    """[R] sectant -> [R,3] offsets in units of the cell edge."""
    return (
        torch.stack([sectant % 4, (sectant // 4) % 4, sectant // 16], dim=-1).float()
        * 0.25
    )


def _step_sectant_v(sectant, step):
    s = sign(step).to(torch.int32)
    x = sectant % 4 + s[:, 0]
    y = (sectant // 4) % 4 + s[:, 1]
    z = sectant // 16 + s[:, 2]
    inside = (x >= 0) & (x < 4) & (y >= 0) & (y < 4) & (z >= 0) & (z < 4)
    return torch.where(inside, x + y * 4 + z * 16, torch.full_like(x, OOB))


def _dda_step_v(d, sf, point, cell_min, cell_size, fma_axes=(True, True, True)):
    """One DDA step to the nearest face of the cell: ``(new_point, step)``
    where ``step`` [R,3] holds the sign of the direction on the crossed
    axes and zero elsewhere.  ``fma_axes``: on which axes ``point + d *
    min_step`` is one fused multiply-add, as XLA:CPU compiles the reference
    program being matched (the stack tracer: all three; the skip tracer: x
    and y)."""
    signum = sign(d)
    steps_needed = cell_size[:, None] * maximum(signum, torch.zeros_like(signum)) - (
        signum * (point - cell_min)
    )
    dists = torch.abs(steps_needed * sf)
    big = torch.full_like(dists, BIG)
    dists = torch.where(d == 0.0, big, dists)
    dists = torch.where(torch.isnan(dists), big, dists)
    min_step = dists.amin(dim=-1, keepdim=True)
    if all(fma_axes):
        new_point = fma32(d, min_step, point)
    else:
        step_len = d * min_step
        new_point = torch.stack(
            [fma32(d[:, c], min_step[:, 0], point[:, c]) if fma_axes[c]
             else point[:, c] + step_len[:, c] for c in range(3)], dim=1)
    step = torch.where(dists == min_step, signum, torch.zeros_like(signum))
    return new_point, step


def _impact_normal_v(cell_min, cell_size, point):
    mid_to_impact = cell_min + cell_size[:, None] / 2.0 - point
    a = torch.abs(mid_to_impact)
    m = a.amax(dim=-1, keepdim=True)
    n = torch.where(a == m, -mid_to_impact, torch.zeros_like(a))
    sq = fma32(n[:, 2], n[:, 2], fma32(n[:, 1], n[:, 1], n[:, 0] * n[:, 0]))
    norm = sqrt32(sq)[:, None]
    return n / maximum(norm, torch.full_like(norm, 1e-12))


def _occ_bit_v(lo, hi, sectant):
    """Occupancy bit ``sectant`` of the (lo, hi) u32 words, held in int64."""
    s = torch.clamp(sectant, 0, 63).long()
    word = torch.where(s < 32, lo, hi)
    return (word >> (s % 32)) & 1
