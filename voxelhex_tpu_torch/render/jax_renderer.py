"""The per-ray boxtree automaton over the flat tree, and its renderer.

The port's counterpart of the reference's ``render/jax_renderer.py`` (the
name is kept so that a reader finds it).  It marches one ray at a time
through a :class:`~voxelhex_tpu_torch.tree.flat.FlatTree`: clip to the
world box, then the sectant automaton (PUSH/POP/ADVANCE over a node's 64
sectants with a 4-deep wrap-around stack of node keys, occupancy culling
by the ray's reach masks), a DDA march inside each parted brick it probes,
and up to 8 restarts from the root a little further on.

On the card a ray is one thread of ``flat_vmap_kernel`` (``csrc/flat.cu``,
through :func:`voxelhex_tpu_torch.ops.flat.trace_vmap`).
:func:`make_trace_ray` here is its plain PyTorch version: the reference's
``_make_trace_ray`` vmapped over ``[R]`` rays, its ``while`` loops run over
the rays whose loop goes on, its ``cond`` branches computed for every ray
and selected, as ``vmap`` turns them into selects.  It is bit-equal to the
reference on XLA:CPU: the multiply-adds that XLA fuses in that program are
fused here (:data:`ADVANCE0_FMA`, :data:`~voxelhex_tpu_torch.render.wavefront.ENTRY_FMA`).

:func:`device_tree` uploads the tree's arrays; :class:`JaxRenderer` traces
rays and renders frames through the kernel (or, on the CPU, the plain
version), shading through ``csrc/shade.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.constants import (
    BOX_NODE_DIMENSION,
    EMPTY_DESC,
    OOB,
    SOLID_FLAG,
)
from voxelhex_tpu_torch.render.bitgrid import U32_MASK, _reach_mask_v
from voxelhex_tpu_torch.render.wavefront import (
    ENTRY_FMA,
    _clip_to_int,
    _dda_step_v,
    _impact_normal_v,
    _occ_bit_v,
    _offset_sectant_v,
    _sectant_offset_v,
    _step_sectant_v,
    axpy,
    intersect_root,
    octant_of,
    scale_factors,
    where_rows,
    xla_mod,
)
from voxelhex_tpu_torch.tree.flat import FlatTree

# On which axes XLA:CPU fuses the new point of the ADVANCE's first DDA step
# in the reference's vmapped tracer (every other DDA step: all three; the
# entry point: render.wavefront.ENTRY_FMA; the restart's nudge: none)
ADVANCE0_FMA = (True, True, False)

ADVANCE_STEPS = 16  # the ADVANCE's loop: at most this many steps after the first


def device_tree(flat: FlatTree, device="cuda") -> dict:
    """The tree's arrays as tensors on ``device`` (int32 bit patterns for
    the u32 words), and its extent ``size`` as a float.  A tree with no
    parted brick is padded to one empty brick (and node row) so that every
    gather has a row."""
    if flat.bricks.shape[0] == 0:
        flat = flat.with_padding(node_multiple=1, brick_multiple=1)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(device)

    return {
        "node_meta": t(flat.node_meta.astype(np.uint32), np.int32),
        "node_children": t(flat.node_children.astype(np.int32), np.int32),
        "node_ocbits": t(flat.node_ocbits.astype(np.uint32), np.int32),
        "node_mips": t(flat.node_mips.astype(np.int32), np.int32),
        "bricks": t(flat.bricks.astype(np.int32), np.int32),
        "palette": t(flat.palette.astype(np.float32), np.float32),
        "size": float(np.float32(flat.size)),
    }


def words(tree, key):
    """The (lo, hi) occupancy words of nodes ``key``, widened to int64."""
    w = tree["node_ocbits"][key.long()].long() & U32_MASK
    return w[:, 0], w[:, 1]


def make_trace_ray(brick_dim: int, max_outer: int = 8, max_inner: int = 512):
    """The plain tracer of the reference's ``_make_trace_ray(brick_dim,
    max_outer, max_inner)``, over ``[R]`` rays: ``trace(tree, o, dirv) ->
    (hit, voxel, brick, cell, point, normal)`` on the tensors of
    :func:`device_tree`.  Each ray makes at most ``max_outer`` passes from
    the root, each of at most ``max_inner`` automaton steps; each brick
    probe marches at most ``max_inner`` cells, and an ADVANCE takes its
    first DDA step and at most 16 more."""
    d = int(brick_dim)

    def probe(tree, desc, point, dirv, sf, bmin, bsize):
        """``probe_brick`` for rays that probe: (hit, voxel, brick, cell,
        point after, normal)."""
        n = desc.shape[0]
        dev = desc.device
        is_solid = (desc != EMPTY_DESC) & ((desc & SOLID_FLAG) != 0)
        is_parted = (desc != EMPTY_DESC) & ((desc & SOLID_FLAG) == 0)
        hit = is_solid.clone()
        voxel = torch.where(is_solid, desc & ~SOLID_FLAG, torch.full_like(desc, EMPTY_DESC))
        brick = torch.full_like(desc, -1)
        cell = torch.full_like(desc, -1)
        p_out = point.clone()
        normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        s = torch.nonzero(is_solid).squeeze(1)
        if s.numel():
            normal[s] = _impact_normal_v(bmin[s], bsize[s], point[s])
        q = torch.nonzero(is_parted).squeeze(1)
        if q.numel():
            qd, qp, qb, qs = desc[q], point[q], bmin[q], bsize[q]
            qdir, qsf = dirv[q], sf[q]
            unit = qs / d
            rel = (qp - qb) * d / qs[:, None]
            idx = _clip_to_int(torch.trunc(rel), d - 1)
            row = tree["bricks"][qd.clamp(min=0).long()]
            m = q.numel()
            qhit = torch.zeros(m, dtype=torch.bool, device=dev)
            qvox = torch.full((m,), EMPTY_DESC, dtype=torch.int32, device=dev)
            for _ in range(max_inner):
                go = ((idx >= 0) & (idx < d)).all(dim=1) & ~qhit
                g = torch.nonzero(go).squeeze(1)
                if g.numel() == 0:
                    break
                gi, gp = idx[g], qp[g]
                flat = gi[:, 0] + gi[:, 1] * d + gi[:, 2] * d * d
                vox = row[g, flat.long()]
                found = vox != EMPTY_DESC
                cmin = qb[g] + gi.float() * unit[g, None]
                new_p, step = _dda_step_v(qdir[g], qsf[g], gp, cmin, unit[g])
                qp[g] = where_rows(found, gp, new_p)
                idx[g] = where_rows(found, gi, gi + step.to(torch.int32))
                qhit[g] = found
                qvox[g] = torch.where(found, vox, qvox[g])
            cmin = qb + idx.float() * unit[:, None]
            qn = _impact_normal_v(cmin, unit, qp)
            ic = idx.clamp(0, d - 1)
            hit[q], voxel[q], brick[q] = qhit, qvox, qd
            cell[q] = ic[:, 0] + ic[:, 1] * d + ic[:, 2] * d * d
            p_out[q], normal[q] = qp, qn
        return hit, voxel, brick, cell, p_out, normal

    def advance(st, occ_lo, occ_hi, dirv, sf):
        """The ADVANCE of the rays of ``st``: (point, tsect, tmin)."""
        point, tsect, tmin, tsize = st["point"], st["tsect"], st["tmin"], st["tsize"]
        new_p, step = _dda_step_v(dirv, sf, point, tmin, tsize, ADVANCE0_FMA)
        ts = _step_sectant_v(tsect, step)
        tm = where_rows(ts < OOB, tmin + step * tsize[:, None], tmin)
        for _ in range(ADVANCE_STEPS):
            go = ~((ts >= OOB) | (_occ_bit_v(occ_lo, occ_hi, ts) != 0))
            g = torch.nonzero(go).squeeze(1)
            if g.numel() == 0:
                break
            gp, gstep = _dda_step_v(dirv[g], sf[g], new_p[g], tm[g], tsize[g])
            gts = _step_sectant_v(ts[g], gstep)
            tm[g] = where_rows(gts < OOB, tm[g] + gstep * tsize[g, None], tm[g])
            ts[g], new_p[g] = gts, gp
        return new_p, ts, tm

    def body(tree, st, record):
        """One automaton step of rays whose pass goes on (count > 0, no
        hit): the reference's ``inner.body``."""
        point, tsect, tmin, tsize = st["point"], st["tsect"], st["tmin"], st["tsize"]
        cur_min, cur_size, cur_key = st["cur_min"], st["cur_size"], st["cur_key"]
        stack, head, count = st["stack"], st["head"], st["count"]
        dirv, sf = st["dirv"], st["sf"]
        n = point.shape[0]
        rows = torch.arange(n, device=point.device)

        top = stack[rows, head.long()]
        occ_lo, occ_hi = words(tree, top)
        meta = tree["node_meta"][cur_key.long()]
        is_leaf = (meta & 1) != 0
        is_uniform = (meta & 2) != 0
        tsect_c = tsect.clamp(0, 63)
        desc = tree["node_children"][cur_key.long(), tsect_c.long()]
        if record is not None:
            record["nodes"][top.long()] = True
            record["nodes"][cur_key.long()] = True
            parted = desc[is_leaf & (tsect < OOB) & (desc >= 0) & ((desc & SOLID_FLAG) == 0)]
            record["bricks"][parted.long()] = True
        child_off = _sectant_offset_v(tsect_c) * cur_size[:, None]
        bmin = where_rows(is_uniform, cur_min, cur_min + child_off)
        bsize = torch.where(is_uniform, cur_size, cur_size / BOX_NODE_DIMENSION)

        do_probe = is_leaf & (tsect < OOB)
        p_hit = torch.zeros_like(do_probe)
        pr = torch.nonzero(do_probe).squeeze(1)
        if pr.numel():
            ph, pv, pb, pc, pp, pn = probe(tree, desc[pr], point[pr], dirv[pr], sf[pr],
                                           bmin[pr], bsize[pr])
            point = point.clone()
            point[pr] = pp
            p_hit[pr] = ph
            hr = pr[ph]
            st["voxel"][hr], st["hbrick"][hr], st["hcell"][hr] = pv[ph], pb[ph], pc[ph]
            st["hpoint"][hr], st["hnormal"][hr] = pp[ph], pn[ph]
        st["hit"] = p_hit
        st["point"] = point

        occ_zero = (occ_lo == 0) & (occ_hi == 0)
        m_lo, m_hi = _reach_mask_v(tsect_c, st["octant"])
        no_overlap = ((occ_lo & m_lo) == 0) & ((occ_hi & m_hi) == 0)
        want_pop = is_uniform | (tsect >= OOB) | occ_zero | no_overlap
        want_push = ~is_leaf & (_occ_bit_v(occ_lo, occ_hi, tsect) != 0) & (tsect < OOB)
        pop = want_pop & ~p_hit
        push = want_push & ~pop & ~p_hit
        adv = ~pop & ~push & ~p_hit

        # POP
        new_count = count - 1
        pop_head = torch.remainder(head - 1, 4)
        p_cur_size = cur_size * BOX_NODE_DIMENSION
        p_cur_min = cur_min - xla_mod(cur_min, p_cur_size[:, None])
        pts = _offset_sectant_v(cur_min + cur_size[:, None] / 2.0 - p_cur_min, p_cur_size)
        pop_p, pop_step = _dda_step_v(dirv, sf, point, cur_min, cur_size)
        pts = _step_sectant_v(pts, pop_step)
        pop_tmin = cur_min + pop_step * cur_size[:, None]
        pop_key = torch.where(new_count > 0, stack[rows, pop_head.long()], cur_key)

        # PUSH
        push_ts = _offset_sectant_v(point - tmin, tsize)
        push_tmin = tmin + _sectant_offset_v(push_ts) * tsize[:, None]
        push_head = torch.remainder(head + 1, 4)

        # ADVANCE
        adv_p, adv_ts, adv_tmin = point, tsect, tmin
        a = torch.nonzero(adv).squeeze(1)
        if a.numel():
            sub = {k: st[k][a] for k in ("tsect", "tmin", "tsize")}
            sub["point"] = point[a]
            ap, ats, atm = advance(sub, occ_lo[a], occ_hi[a], dirv[a], sf[a])
            adv_p, adv_ts, adv_tmin = point.clone(), tsect.clone(), tmin.clone()
            adv_p[a], adv_ts[a], adv_tmin[a] = ap, ats, atm

        st["point"] = where_rows(pop, pop_p, where_rows(adv, adv_p, point))
        st["tsect"] = torch.where(pop, pts, torch.where(push, push_ts,
                                                        torch.where(adv, adv_ts, tsect)))
        st["tmin"] = where_rows(pop, pop_tmin, where_rows(push, push_tmin, where_rows(adv, adv_tmin, tmin)))
        st["tsize"] = torch.where(pop, cur_size,
                                  torch.where(push, tsize / BOX_NODE_DIMENSION, tsize))
        st["cur_min"] = where_rows(pop, p_cur_min, where_rows(push, tmin, cur_min))
        st["cur_size"] = torch.where(pop, p_cur_size, torch.where(push, tsize, cur_size))
        st["cur_key"] = torch.where(pop, pop_key, torch.where(push, desc, cur_key))
        new_stack = stack.clone()
        new_stack[rows, push_head.long()] = torch.where(push, desc,
                                                        stack[rows, push_head.long()])
        st["stack"] = new_stack
        st["head"] = torch.where(pop, pop_head, torch.where(push, push_head, head))
        st["count"] = torch.where(pop, new_count,
                                  torch.where(push, torch.clamp(count + 1, max=4), count))
        return st

    def trace(tree, o, dirv, record=None):
        """``record``: a dict that gets each ray's automaton steps
        (``steps`` [R]) and which node rows and brick rows the march reads
        (``nodes`` [N], ``bricks`` [B]: bool)."""
        R = o.shape[0]
        dev = o.device
        size = tree["size"]
        if record is not None:
            record.update(steps=torch.zeros(R, dtype=torch.int64, device=dev),
                          nodes=torch.zeros(tree["node_children"].shape[0], dtype=torch.bool,
                                            device=dev),
                          bricks=torch.zeros(tree["bricks"].shape[0], dtype=torch.bool,
                                             device=dev))
        sf = scale_factors(dirv)
        octant = octant_of(dirv)
        root_hit, enter, _tmax = intersect_root(o, dirv, size)
        point = axpy(dirv, enter[:, None], o, ENTRY_FMA)
        sizes = torch.full((R,), size, dtype=torch.float32, device=dev)
        tsect = torch.where(root_hit, _offset_sectant_v(point, sizes),
                            torch.full((R,), OOB, dtype=torch.int32, device=dev))
        hit = torch.zeros(R, dtype=torch.bool, device=dev)
        out = {
            "voxel": torch.full((R,), EMPTY_DESC, dtype=torch.int32, device=dev),
            "hbrick": torch.full((R,), -1, dtype=torch.int32, device=dev),
            "hcell": torch.full((R,), -1, dtype=torch.int32, device=dev),
            "hpoint": torch.zeros((R, 3), dtype=torch.float32, device=dev),
            "hnormal": torch.zeros((R, 3), dtype=torch.float32, device=dev),
        }
        for _ in range(max_outer):
            live = torch.nonzero((tsect < OOB) & ~hit).squeeze(1)
            if live.numel() == 0:
                break
            n = live.numel()
            cur_size = torch.full((n,), size, dtype=torch.float32, device=dev)
            st = {
                "point": point[live], "tsect": tsect[live],
                "tmin": _sectant_offset_v(tsect[live]) * cur_size[:, None],
                "tsize": cur_size / BOX_NODE_DIMENSION,
                "cur_min": torch.zeros((n, 3), dtype=torch.float32, device=dev),
                "cur_size": cur_size,
                "cur_key": torch.zeros(n, dtype=torch.int32, device=dev),
                "stack": torch.zeros((n, 4), dtype=torch.int32, device=dev),
                "head": torch.zeros(n, dtype=torch.int32, device=dev),
                "count": torch.ones(n, dtype=torch.int32, device=dev),
                "hit": torch.zeros(n, dtype=torch.bool, device=dev),
                "dirv": dirv[live], "sf": sf[live], "octant": octant[live],
            } | {k: v[live] for k, v in out.items()}
            for _ in range(max_inner):
                g = torch.nonzero((st["count"] > 0) & ~st["hit"]).squeeze(1)
                if g.numel() == 0:
                    break
                if record is not None:
                    record["steps"][live[g]] += 1
                sub = body(tree, {k: v[g] for k, v in st.items()}, record)
                for k, v in sub.items():
                    st[k][g] = v
            # the restart: nudge forward and take the sectant there
            p = st["point"] + st["dirv"] * np.float32(0.1)
            inside = ((p > 0.0) & (p < size)).all(dim=1)
            ts = torch.where(inside, _offset_sectant_v(p, cur_size.new_full((n,), size)),
                             torch.full_like(st["tsect"], OOB))
            point[live] = p
            tsect[live] = torch.where(st["hit"], torch.full_like(ts, OOB), ts)
            hit[live] = st["hit"]
            for k in out:
                out[k][live] = st[k]
        return hit, out["voxel"], out["hbrick"], out["hcell"], out["hpoint"], out["hnormal"]

    return trace


def shade_frame(palette, hit, voxel, normal, bg):
    """The reference's ``_shade`` of traced rays, f32 [R, 3]."""
    from voxelhex_tpu_torch.ops.shade import shade

    return shade(hit, voxel, normal, palette, bg, out_u8=False)


class JaxRenderer:
    """Whole-frame renderer over the flat tree, a ray a thread of
    ``flat_vmap_kernel`` (the reference's ``JaxRenderer``).  ``device="cpu"``
    runs the plain version; without a card the default raises."""

    def __init__(self, flat: FlatTree, max_inner: int = 2048, device="cuda"):
        from voxelhex_tpu_torch.render.renderer import resolve_device

        self.flat = flat
        self.device = resolve_device(device)
        self.tree = device_tree(flat, self.device)
        self.brick_dim = flat.brick_dim
        self.max_inner = int(max_inner)

    def trace(self, origins, directions):
        """Raw per-ray results: ``(hit [R], voxel [R], brick [R], cell [R],
        point [R, 3], normal [R, 3])`` on the renderer's device; ``point``
        is the hit point."""
        from voxelhex_tpu_torch.ops.flat import trace_vmap

        o, d = rays_on(origins, directions, self.device)
        return trace_vmap(self.tree, self.brick_dim, o, d, self.max_inner)

    def render(self, camera, bg=(0.0, 0.0, 0.0)):
        """A frame of ``camera``'s host rays: f32 NumPy [H, W, 3]."""
        origins, dirs = camera.rays()
        h, w = origins.shape[:2]
        hit, voxel, _b, _c, _p, normal = self.trace(origins, dirs)
        rgb = shade_frame(self.tree["palette"], hit, voxel, normal, bg)
        return rgb.cpu().numpy().reshape(h, w, 3)


def rays_on(origins, directions, device):
    """Rays as contiguous f32 [R, 3] tensors on ``device``."""

    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))
        return a.to(device=device, dtype=torch.float32).reshape(-1, 3).contiguous()

    return t(origins), t(directions)


