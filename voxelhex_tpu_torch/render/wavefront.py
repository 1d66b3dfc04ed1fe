"""The wavefront renderer, and the sectant automaton's vector helpers.

Counterparts of the reference's ``render/wavefront.py``.  The helpers work
on ``[R]``-batched tensors; each keeps the reference's operation order and
its NaN and signed-zero semantics, so the plain tracers that use them are
bit-equal to the reference on XLA:CPU.

The reference's wavefront tracer advances every ray in lock-step through
one loop whose body is one phase's work a ray: a NODE step (probe the
sectant's brick once, else PUSH, POP or one ADVANCE step), a BRICK cell
step, then the restart of a ray whose stack ran dry.  No ray reads
another's state, so :func:`lockstep_run` runs each turn's body on the rays
not yet done, and the fast tracer (:mod:`voxelhex_tpu_torch.render.fast`)
is the same bodies over its packed tree.  On the card a ray is one thread
of ``flat_wavefront_kernel`` (``csrc/flat.cu``, through
:func:`voxelhex_tpu_torch.ops.flat.trace_wavefront`), which
:class:`WavefrontRenderer` launches; :func:`make_wavefront_tracer` is its
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.constants import BOX_NODE_DIMENSION, EMPTY_DESC, OOB, SOLID_FLAG
from voxelhex_tpu_torch.fp import fma32, fmax_nan, fmin_nan, maximum, minimum, sqrt32

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


# ---------------------------------------------------------------------------
# the flat-tree tracers' helpers, and the batched tracers (the wavefront's
# and the fast tracer's)
# ---------------------------------------------------------------------------

PH_NODE = 0
PH_BRICK = 1
PH_DONE = 2

META_SHIFT = 28
KEY_MASK = (1 << META_SHIFT) - 1

# The move record of lockstep_run (``record["moves"]``): each body's kind
# in bits 0-2, its DDA steps (a BRICK body's cell steps, a POP's one, an
# ADVANCE's substeps) times MOVE_DDA, and MOVE_RESTART where the body ends
# with the stack run dry (the nudge, then a restart or the end); 0 for a
# ray that is done
MOVE_BRICK, MOVE_PROBE, MOVE_PUSH, MOVE_POP, MOVE_ADVANCE = 1, 2, 3, 4, 5
MOVE_DDA = 8
MOVE_RESTART = 64

# On which axes XLA:CPU fuses the entry point o + d * enter in the
# reference's flat-tree programs (tests/test_torch_flat_renderers.py); they
# fuse every DDA step's point + d * t on all three, and no restart's point
# + d * 0.1.
ENTRY_FMA = (True, True, False)


def scale_factors(dirv, last_one=False):
    """The DDA's path length per unit step on each axis, ``sqrt(1 + (dz /
    dx)^2 + (dy / dx)^2)`` and its turns.  Each sum of squares is ``(a^2 +
    1) + b^2`` as two fused multiply-adds (the reference's scalar tracer),
    or with ``last_one`` the third is ``(a^2 + b^2) + 1`` (the reference's
    batched tracers' order), its squares as ``fma(a, a, b * b)``."""
    dx, dy, dz = dirv[:, 0], dirv[:, 1], dirv[:, 2]
    pairs = ((dz / dx, dy / dx), (dx / dy, dz / dy), (dx / dz, dy / dz))
    sq = [fma32(b, b, fma32(a, a, 1.0)) for a, b in pairs]
    if last_one:
        a, b = pairs[2]
        sq[2] = fma32(a, a, b * b) + 1.0
    return sqrt32(torch.stack(sq, dim=-1))


def octant_of(dirv):
    """The direction's octant, ``x + 2 z + 4 y`` of its non-negative axes."""
    return ((dirv[:, 0] >= 0).int() + (dirv[:, 2] >= 0).int() * 2
            + (dirv[:, 1] >= 0).int() * 4)


def intersect_root(o, dirv, size):
    """``(hit, enter, tmax)`` of rays against the world box [0, size]^3:
    the reference's slab test with ``fmin``/``fmax`` (NaN loses)."""
    t_lo = (0.0 - o) / dirv
    t_hi = (size - o) / dirv
    per_min = fmin_nan(t_lo, t_hi)
    per_max = fmax_nan(t_lo, t_hi)
    tmin = fmax_nan(fmax_nan(per_min[:, 0], per_min[:, 1]), per_min[:, 2])
    tmax = fmin_nan(fmin_nan(per_max[:, 0], per_max[:, 1]), per_max[:, 2])
    hit = ~((tmax < 0.0) | (tmin > tmax))
    return hit, maximum(tmin, torch.zeros_like(tmin)), tmax


def axpy(a, x, y, fused):
    """``y + a * x`` on [R, 3] (``x`` [R, 1]), axis c one fused
    multiply-add where ``fused[c]``."""
    x = x.expand_as(a)
    return torch.stack([fma32(a[:, c], x[:, c], y[:, c]) if fused[c]
                        else y[:, c] + a[:, c] * x[:, c] for c in range(3)], dim=1)


def where_rows(cond, a, b):
    """``where`` of [R] or [R, k] values under an [R] condition."""
    return torch.where(cond.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def xla_mod(x, y):
    """``jnp.mod`` of floats: XLA's exact remainder (``fmod``), moved into
    the divisor's sign where the signs differ and it is not zero."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


class LockstepConfig:
    """What sets one batched flat-tree tracer apart: the brick edge ``d``,
    the caps, ``packed`` (the fast tracer: child meta in the node entries,
    the occupancy row of the current node, the voxel read after the march),
    ``bitmap`` (bricks marched by their occupancy bits, ``brick_substeps``
    cells a body), the ADVANCE's substeps and the axes on which the entry
    point is fused."""

    def __init__(self, d, max_iters, max_restarts, packed=False, bitmap=False,
                 brick_substeps=1, advance_substeps=1, entry_fma=ENTRY_FMA):
        self.d = int(d)
        self.max_iters = int(max_iters)
        self.max_restarts = int(max_restarts)
        self.packed = bool(packed)
        self.bitmap = bool(bitmap)
        self.brick_substeps = int(brick_substeps) if bitmap else 1
        self.advance_substeps = int(advance_substeps)
        self.entry_fma = tuple(entry_fma)


def lockstep_init(tree, o, dirv, cfg, start_t=None):
    """The per-ray state of the batched tracers before the first body."""
    R = o.shape[0]
    dev = o.device
    size = tree["size"]
    root_hit, enter, tmax_r = intersect_root(o, dirv, size)
    if start_t is not None:
        zero = torch.zeros_like(enter)
        hi = maximum(tmax_r - np.float32(1e-3), zero)
        enter = minimum(maximum(zero, maximum(enter, start_t)), hi)
    point = axpy(dirv, enter[:, None], o, cfg.entry_fma)
    sizes = torch.full((R,), size, dtype=torch.float32, device=dev)
    tsect = torch.where(root_hit, _offset_sectant_v(point, sizes),
                        torch.full((R,), OOB, dtype=torch.int32, device=dev))
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    stack = torch.zeros((R, 4), **i32)
    root = torch.zeros(R, **i32)
    if cfg.packed:
        root = torch.full((R,), tree["root_meta"] << META_SHIFT, **i32)
        stack[:, 0] = root
    return {
        "dirv": dirv, "sf": scale_factors(dirv, last_one=True), "octant": octant_of(dirv),
        "point": point, "tsect": tsect,
        "cur_min": torch.zeros((R, 3), **f32), "cur_size": sizes.clone(),
        "tmin": _sectant_offset_v(tsect.clamp(0, 63)) * sizes[:, None],
        "tsize": sizes / BOX_NODE_DIMENSION,
        "stack": stack, "head": torch.zeros(R, **i32), "count": root_hit.int(),
        "cur": root, "probed": torch.zeros(R, dtype=torch.bool, device=dev),
        "force_pop": torch.zeros(R, dtype=torch.bool, device=dev),
        "restarts": torch.zeros(R, **i32),
        "phase": torch.where(root_hit, PH_NODE, PH_DONE).int(),
        "b_lo": torch.zeros(R, dtype=torch.int64, device=dev),
        "b_hi": torch.zeros(R, dtype=torch.int64, device=dev),
        "bidx": torch.zeros(R, **i32), "bcell": torch.zeros((R, 3), **i32),
        "bmin": torch.zeros((R, 3), **f32), "bsize": torch.ones(R, **f32),
        "b_uniform": torch.zeros(R, dtype=torch.bool, device=dev),
        "hit": torch.zeros(R, dtype=torch.bool, device=dev),
        "voxel": torch.full((R,), EMPTY_DESC, **i32),
        "hbrick": torch.full((R,), -1, **i32), "hcell": torch.full((R,), -1, **i32),
        "hnormal": torch.zeros((R, 3), **f32),
        "iters": torch.zeros(R, **i32),
    }


def _brick_steps(tree, st, cfg):
    """The BRICK phase of rays that march a brick: one DDA cell step with a
    voxel read, or (``cfg.bitmap``) up to ``brick_substeps`` steps on the
    brick's occupancy bits."""
    d = cfg.d
    if "record" in st:
        st["record"]["bricks"][st["bidx"].clamp(0, tree["bricks"].shape[0] - 1).long()] = True
    point, bcell, bmin = st["point"], st["bcell"], st["bmin"]
    unit = st["bsize"] / d
    marching = torch.ones_like(st["hit"])
    dda = torch.zeros_like(st["iters"])
    for _ in range(cfg.brick_substeps):
        inb = ((bcell >= 0) & (bcell < d)).all(dim=1)
        flat = bcell[:, 0] + bcell[:, 1] * d + bcell[:, 2] * d * d
        if cfg.bitmap:
            scale = 4 // d
            bit = bcell[:, 0] * scale + bcell[:, 1] * scale * 4 + bcell[:, 2] * scale * 16
            occupied = _occ_bit_v(st["b_lo"], st["b_hi"], bit) != 0
        else:
            rows = tree["bricks"]
            bvox = rows[st["bidx"].clamp(0, rows.shape[0] - 1).long(),
                        flat.clamp(0, d * d * d - 1).long()]
            occupied = bvox != EMPTY_DESC
        found = marching & inb & occupied
        cell_min = bmin + bcell.float() * unit[:, None]
        new_p, step = _dda_step_v(st["dirv"], st["sf"], point, cell_min, unit)
        bnormal = _impact_normal_v(cell_min, unit, point)
        st["hit"] = st["hit"] | found
        if not cfg.packed:
            st["voxel"] = torch.where(found, bvox, st["voxel"])
        st["hbrick"] = torch.where(found, st["bidx"], st["hbrick"])
        st["hcell"] = torch.where(found, flat, st["hcell"])
        st["hnormal"] = where_rows(found, bnormal, st["hnormal"])
        b_exit = marching & ~inb
        go = marching & ~found & inb
        point = where_rows(go, new_p, point)
        bcell = where_rows(go, bcell + step.int(), bcell)
        dda = dda + go.int()
        st["phase"] = torch.where(found, PH_DONE, torch.where(b_exit, PH_NODE, st["phase"])).int()
        st["probed"] = st["probed"] | b_exit
        st["force_pop"] = st["force_pop"] | (b_exit & st["b_uniform"])
        marching = go
    st["point"], st["bcell"] = point, bcell
    if "move" in st:
        st["move"] = (MOVE_BRICK + MOVE_DDA * dda).to(torch.int8)
    return st


def _node_step(tree, st, cfg):
    """The NODE phase of rays at a node: probe the sectant's brick once,
    else one PUSH, POP or ADVANCE."""
    from voxelhex_tpu_torch.render.bitgrid import U32_MASK, _reach_mask_v

    d = cfg.d
    n = st["point"].shape[0]
    rows = torch.arange(n, device=st["point"].device)
    point, tsect, tmin, tsize = st["point"], st["tsect"], st["tmin"], st["tsize"]
    cur_min, cur_size, cur = st["cur_min"], st["cur_size"], st["cur"]
    stack, head, count = st["stack"], st["head"], st["count"]
    if cfg.packed:
        key = cur & KEY_MASK
        occ = tree["node_ocbits"][key.long()].long() & U32_MASK
        meta = (cur >> META_SHIFT) & 3
    else:
        key = cur
        occ = tree["node_ocbits"][stack[rows, head.long()].long()].long() & U32_MASK
        meta = tree["node_meta"][key.long()]
    occ_lo, occ_hi = occ[:, 0], occ[:, 1]
    is_leaf = (meta & 1) != 0
    is_uniform = (meta & 2) != 0
    tsect_c = tsect.clamp(0, 63)
    desc = tree["node_children"][key.long(), tsect_c.long()]
    if "record" in st:
        st["record"]["nodes"][key.long()] = True
        if not cfg.packed:
            st["record"]["nodes"][stack[rows, head.long()].long()] = True

    can_probe = is_leaf & (tsect < OOB) & ~st["probed"]
    desc_solid = (desc != EMPTY_DESC) & ((desc & SOLID_FLAG) != 0)
    desc_parted = (desc != EMPTY_DESC) & ((desc & SOLID_FLAG) == 0)
    p_bmin = where_rows(is_uniform, cur_min, cur_min + _sectant_offset_v(tsect_c) * cur_size[:, None])
    p_bsize = torch.where(is_uniform, cur_size, cur_size / BOX_NODE_DIMENSION)

    s_hit = can_probe & desc_solid
    s_normal = _impact_normal_v(p_bmin, p_bsize, point)
    st["hit"] = st["hit"] | s_hit
    solid_voxel = desc & (SOLID_FLAG - 1) if cfg.packed else desc & ~SOLID_FLAG
    st["voxel"] = torch.where(s_hit, solid_voxel, st["voxel"])
    minus = torch.full_like(desc, -1)
    st["hbrick"] = torch.where(s_hit, minus, st["hbrick"])
    st["hcell"] = torch.where(s_hit, minus, st["hcell"])
    st["hnormal"] = where_rows(s_hit, s_normal, st["hnormal"])

    enter_brick = can_probe & desc_parted
    if cfg.packed:
        borow = tree["brick_ocbits"][desc.clamp(0, tree["brick_ocbits"].shape[0] - 1).long()]
        borow = borow.long() & U32_MASK
        st["b_lo"] = torch.where(enter_brick, borow[:, 0], st["b_lo"])
        st["b_hi"] = torch.where(enter_brick, borow[:, 1], st["b_hi"])
    rel = (point - p_bmin) * d / p_bsize[:, None]
    start_cell = _clip_to_int(torch.trunc(rel), d - 1)
    st["bidx"] = torch.where(enter_brick, desc.clamp(min=0), st["bidx"])
    st["bcell"] = where_rows(enter_brick, start_cell, st["bcell"])
    st["bmin"] = where_rows(enter_brick, p_bmin, st["bmin"])
    st["bsize"] = torch.where(enter_brick, p_bsize, st["bsize"])
    st["b_uniform"] = torch.where(enter_brick, is_uniform, st["b_uniform"])
    st["phase"] = torch.where(s_hit, PH_DONE, torch.where(enter_brick, PH_BRICK,
                                                          st["phase"])).int()

    missed = can_probe & (desc == EMPTY_DESC)
    force_pop = st["force_pop"] | (missed & is_uniform)
    probed = st["probed"] | missed
    decide = ~enter_brick & ~s_hit & (~can_probe | missed)

    m_lo, m_hi = _reach_mask_v(tsect_c, st["octant"])
    occ_zero = (occ_lo == 0) & (occ_hi == 0)
    no_overlap = ((occ_lo & m_lo) == 0) & ((occ_hi & m_hi) == 0)
    pop = decide & (force_pop | (tsect >= OOB) | occ_zero | no_overlap)
    push = decide & ~pop & ~is_leaf & (_occ_bit_v(occ_lo, occ_hi, tsect) != 0) & (tsect < OOB)
    adv = decide & ~pop & ~push

    # POP
    pop_count = count - 1
    pop_head = torch.remainder(head - 1, 4)
    pop_cur_size = cur_size * BOX_NODE_DIMENSION
    pop_cur_min = cur_min - xla_mod(cur_min, pop_cur_size[:, None])
    pop_ts = _offset_sectant_v(cur_min + cur_size[:, None] / 2.0 - pop_cur_min, pop_cur_size)
    pop_p, pop_step = _dda_step_v(st["dirv"], st["sf"], point, cur_min, cur_size)
    pop_ts = _step_sectant_v(pop_ts, pop_step)
    pop_tmin = cur_min + pop_step * cur_size[:, None]
    pop_cur = stack[rows, pop_head.long()]

    # PUSH
    push_ts = _offset_sectant_v(point - tmin, tsize)
    push_tmin = tmin + _sectant_offset_v(push_ts) * tsize[:, None]
    push_head = torch.remainder(head + 1, 4)

    # ADVANCE, its substeps stopping at an occupied sectant or the block's
    # edge
    adv_p, adv_ts, adv_tmin, go = point, tsect, tmin, adv
    adv_dda = torch.zeros_like(tsect)
    for _ in range(cfg.advance_substeps):
        adv_dda = adv_dda + go.int()
        a_p, a_step = _dda_step_v(st["dirv"], st["sf"], adv_p, adv_tmin, tsize)
        a_ts = _step_sectant_v(adv_ts, a_step)
        a_tmin = where_rows(a_ts < OOB, adv_tmin + a_step * tsize[:, None], adv_tmin)
        adv_p = where_rows(go, a_p, adv_p)
        adv_ts = torch.where(go, a_ts, adv_ts)
        adv_tmin = where_rows(go, a_tmin, adv_tmin)
        go = go & ~((adv_ts >= OOB) | (_occ_bit_v(occ_lo, occ_hi, adv_ts) != 0))

    st["point"] = where_rows(pop, pop_p, where_rows(adv, adv_p, point))
    st["tsect"] = torch.where(pop, pop_ts, torch.where(push, push_ts,
                                                       torch.where(adv, adv_ts, tsect)))
    st["tmin"] = where_rows(pop, pop_tmin, where_rows(push, push_tmin, where_rows(adv, adv_tmin, tmin)))
    st["tsize"] = torch.where(pop, cur_size, torch.where(push, tsize / BOX_NODE_DIMENSION,
                                                         tsize))
    st["cur_min"] = where_rows(pop, pop_cur_min, where_rows(push, tmin, cur_min))
    st["cur_size"] = torch.where(pop, pop_cur_size, torch.where(push, tsize, cur_size))
    st["cur"] = torch.where(push, desc, torch.where(pop & (pop_count > 0), pop_cur, cur))
    new_stack = stack.clone()
    new_stack[rows, push_head.long()] = torch.where(push, desc, stack[rows, push_head.long()])
    st["stack"] = new_stack
    st["head"] = torch.where(pop, pop_head, torch.where(push, push_head, head))
    st["count"] = torch.where(pop, pop_count,
                              torch.where(push, torch.clamp(count + 1, max=4), count))
    moved = pop | push | adv
    st["probed"] = probed & ~moved
    st["force_pop"] = force_pop & ~moved
    if "move" in st:
        kind = torch.where(pop, MOVE_POP + MOVE_DDA,
                           torch.where(push, MOVE_PUSH, MOVE_ADVANCE + MOVE_DDA * adv_dda))
        st["move"] = torch.where(s_hit | enter_brick, MOVE_PROBE, kind).to(torch.int8)
    return st


def _restart(tree, st, cfg):
    """Rays at a node whose stack has run dry: nudged 0.1 on, and started
    again from the root while inside the world and under the restart cap,
    else done."""
    size = tree["size"]
    n = st["point"].shape[0]
    dev = st["point"].device
    exhausted = (st["phase"] == PH_NODE) & (st["count"] <= 0)
    if not bool(exhausted.any()):
        return st
    re_point = st["point"] + st["dirv"] * np.float32(0.1)
    inside = ((re_point > 0.0) & (re_point < size)).all(dim=1)
    again = exhausted & inside & (st["restarts"] < cfg.max_restarts)
    st["point"] = where_rows(exhausted, re_point, st["point"])
    st["restarts"] = st["restarts"] + exhausted.int()
    sizes = torch.full((n,), size, dtype=torch.float32, device=dev)
    r_ts = _offset_sectant_v(st["point"], sizes)
    st["tsect"] = torch.where(again, r_ts, st["tsect"])
    st["cur_min"] = where_rows(again, torch.zeros_like(st["cur_min"]), st["cur_min"])
    st["cur_size"] = torch.where(again, sizes, st["cur_size"])
    st["tmin"] = where_rows(again, _sectant_offset_v(r_ts.clamp(0, 63)) * size, st["tmin"])
    st["tsize"] = torch.where(again, sizes / BOX_NODE_DIMENSION, st["tsize"])
    st["head"] = torch.where(again, 0, st["head"]).int()
    st["count"] = torch.where(again, 1, st["count"]).int()
    root = torch.zeros_like(st["cur"])
    if cfg.packed:
        root = root + (tree["root_meta"] << META_SHIFT)
    st["cur"] = torch.where(again, root, st["cur"])
    fresh = torch.zeros_like(st["stack"])
    fresh[:, 0] = root
    st["stack"] = where_rows(again, fresh, st["stack"])
    st["probed"] = st["probed"] & ~again
    st["force_pop"] = st["force_pop"] & ~again
    st["phase"] = torch.where(exhausted & ~again, PH_DONE, st["phase"]).int()
    return st


def lockstep_run(tree, st, cfg, record=None):
    """Bodies of the batched tracer until every ray is done or has run
    ``cfg.max_iters`` of them; each body is a BRICK step of the rays in a
    brick, a NODE step of those at a node, then the restarts.  A body
    changes nothing of a done ray, so each turn runs on the rays not yet
    done, as the lock-step loop's masks do.  ``record``: a dict that gets
    each ray's bodies (``steps`` [R]) and which node rows and brick rows
    the march reads (``nodes`` [N], ``bricks`` [B]: bool); and where it
    holds ``moves`` (a list), an int8 [R] a turn appended to it, each
    ray's body in that turn (``MOVE_*``)."""
    const = ("dirv", "sf", "octant")
    moves = None if record is None else record.get("moves")
    if moves is not None:
        st["move"] = torch.zeros(st["point"].shape[0], dtype=torch.int8,
                                 device=st["point"].device)
    if record is not None:
        dev = st["point"].device
        record.update(nodes=torch.zeros(tree["node_children"].shape[0], dtype=torch.bool,
                                        device=dev),
                      bricks=torch.zeros(tree["bricks"].shape[0], dtype=torch.bool, device=dev))
    for _ in range(cfg.max_iters):
        live = torch.nonzero(st["phase"] != PH_DONE).squeeze(1)
        if live.numel() == 0:
            break
        sub = {k: v[live] for k, v in st.items()}
        in_brick = torch.nonzero(sub["phase"] == PH_BRICK).squeeze(1)
        in_node = torch.nonzero(sub["phase"] == PH_NODE).squeeze(1)
        for rows, step in ((in_brick, _brick_steps), (in_node, _node_step)):
            if rows.numel():
                part = {k: v[rows] for k, v in sub.items()}
                if record is not None:
                    part["record"] = record
                part = step(tree, part, cfg)
                for k, v in part.items():
                    if k not in const and k != "record":
                        sub[k][rows] = v
        if moves is not None:
            dry = (sub["phase"] == PH_NODE) & (sub["count"] <= 0)
            turn = torch.zeros_like(st["move"])
            turn[live] = sub["move"] | (dry.to(torch.int8) * MOVE_RESTART)
            moves.append(turn)
        sub = _restart(tree, sub, cfg)
        sub["iters"] = sub["iters"] + 1
        for k, v in sub.items():
            if k not in const:
                st[k][live] = v
    if record is not None:
        record["steps"] = st["iters"].long()
    st.pop("move", None)
    return st


def warp_moves(moves, width, height, tile=None):
    """The warps' view of a move record (``lockstep_run``'s ``moves``) of a
    frame ``width`` x ``height`` in row order: its rays in warps of 32 in
    a row (``trace()``'s launch), or with ``tile = (w, h)`` of a w x h
    pixel tile (w * h = 32; lanes past the frame idle).  Each warp runs as many turns as its
    longest ray has bodies; in a turn it runs a DDA loop as long as its
    lanes' most DDA steps (one shared DDA step a loop turn), or with a
    branch a move the longest BRICK body's steps, one POP step if any lane
    pops, and the longest ADVANCE's.  Returns ``warps``, ``turns`` (summed
    over warps), ``lane_turns`` (bodies), ``working`` (lane_turns / (turns
    * 32)), ``dda_shared`` and ``dda_branches`` (summed over warps and
    turns)."""
    n = width * height
    dev = moves[0].device if moves else torch.device("cpu")
    if tile is None:
        index = torch.arange(-(-n // 32) * 32, device=dev).clamp(max=n).reshape(-1, 32)
    else:
        tw, th = tile
        if tw * th != 32:
            raise ValueError(f"a warp is 32 lanes, not a {tw} x {th} tile")
        wx, wy = -(-width // tw), -(-height // th)
        ys = torch.arange(wy * th, device=dev).reshape(wy, th)
        xs = torch.arange(wx * tw, device=dev).reshape(wx, tw)
        py = ys[:, None, :, None].expand(wy, wx, th, tw).reshape(-1, 32)
        px = xs[None, :, None, :].expand(wy, wx, th, tw).reshape(-1, 32)
        inside = (px < width) & (py < height)
        index = torch.where(inside, py * width + px, torch.full_like(px, n))
    out = {"warps": int(index.shape[0]), "turns": 0, "lane_turns": 0, "dda_shared": 0,
           "dda_branches": 0}
    for turn in moves:
        m = torch.cat([turn[:n].long(), torch.zeros(1, dtype=torch.long, device=dev)])[index]
        kind, dda = m & 7, (m // MOVE_DDA) & 7
        live = kind > 0
        out["turns"] += int(live.any(dim=1).sum())
        out["lane_turns"] += int(live.sum())
        out["dda_shared"] += int(dda.amax(dim=1).sum())
        for k in (MOVE_BRICK, MOVE_POP, MOVE_ADVANCE):
            out["dda_branches"] += int(torch.where(kind == k, dda, 0).amax(dim=1).sum())
    out["working"] = out["lane_turns"] / max(32 * out["turns"], 1)
    return out


def make_wavefront_tracer(brick_dim: int, max_iters: int = 4096, max_restarts: int = 8):
    """The plain tracer of the reference's ``make_wavefront_tracer``:
    ``trace(tree, o, dirv) -> (hit, voxel, brick, cell, point, normal)``
    over ``[R]`` rays on the tensors of :func:`~voxelhex_tpu_torch.render.
    jax_renderer.device_tree`; ``point`` is where each ray's march ended."""
    cfg = LockstepConfig(brick_dim, max_iters, max_restarts)

    def trace(tree, o, dirv, record=None):
        st = lockstep_run(tree, lockstep_init(tree, o, dirv, cfg), cfg, record)
        return st["hit"], st["voxel"], st["hbrick"], st["hcell"], st["point"], st["hnormal"]

    trace.config = cfg
    return trace


class WavefrontRenderer:
    """Whole-frame renderer over the wavefront tracer, a ray a thread of
    ``flat_wavefront_kernel`` (the reference's ``WavefrontRenderer``).
    ``device="cpu"`` runs the plain version; without a card the default
    raises."""

    def __init__(self, flat, max_iters: int = 4096, device="cuda"):
        from voxelhex_tpu_torch.render.jax_renderer import device_tree
        from voxelhex_tpu_torch.render.renderer import resolve_device

        self.flat = flat
        self.device = resolve_device(device)
        self.tree = device_tree(flat, self.device)
        self.brick_dim = flat.brick_dim
        self.max_iters = int(max_iters)

    def trace(self, origins, directions):
        """Raw per-ray results: ``(hit [R], voxel [R], brick [R], cell [R],
        point [R, 3], normal [R, 3])`` on the renderer's device; ``point``
        is where the march ended."""
        from voxelhex_tpu_torch.ops.flat import trace_wavefront
        from voxelhex_tpu_torch.render.jax_renderer import rays_on

        o, d = rays_on(origins, directions, self.device)
        return trace_wavefront(self.tree, self.brick_dim, o, d, self.max_iters)

    def render(self, camera, bg=(0.0, 0.0, 0.0)):
        """A frame of ``camera``'s host rays: f32 NumPy [H, W, 3]."""
        from voxelhex_tpu_torch.ops.flat import trace_wavefront
        from voxelhex_tpu_torch.render.jax_renderer import rays_on, shade_frame

        origins, dirs = camera.rays()
        h, w = origins.shape[:2]
        o, d = rays_on(origins, dirs, self.device)
        hit, voxel, _b, _c, _p, normal = trace_wavefront(self.tree, self.brick_dim, o, d,
                                                         self.max_iters, _width=w)
        rgb = shade_frame(self.tree["palette"], hit, voxel, normal, bg)
        return rgb.cpu().numpy().reshape(h, w, 3)
