"""Out-of-core streaming: a camera-following window over a large scene, and
the coarse LOD rings of its far field.

The port of the reference's ``voxelhex_tpu/render/streaming.py``.  The
*view* is a BitGrid of edge ``view_size`` (a multiple of ``REGION``) whose
world origin snaps to the region grid around the camera.  Scene content is
rasterized region by region from the host tree into the view's host
mirrors and paged onto the device, at most ``regions_per_update`` regions an
update (frustum first, nearest first); regions that leave the window are
dropped when it moves, and tree edits mark the regions they touch dirty.
Regions not paged yet show coarse placeholder content, and regions inside
fully occluded tree nodes stay at that content (occlusion pruning).  Beyond
the window, the far field renders the rest of the world through nested
coarse BitGrids (``FarField``, ``FarTier``), each with the box of the layer
inside it cut out.

Host work (rasterizing, packing, sampling) is NumPy and the host library
(:mod:`voxelhex_tpu_torch.native`); ``async_uploads`` and ``async_far`` move
it to worker threads, which touch only the host.  The device work is the
port's kernels, launched from the render thread: the region scatter, the
coarse rebuild and the window shift (:mod:`voxelhex_tpu_torch.ops.stream`)
keep the window's device grids current, and a frame with its far field is
one launch of :mod:`voxelhex_tpu_torch.ops.far` (a frame without one, one
launch of the frame kernel).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from voxelhex_tpu_torch import native
from voxelhex_tpu_torch.constants import COLOR_EMPTY, EMPTY_DESC, NO_COLOR_HIT
from voxelhex_tpu_torch.ops.far import render_far
from voxelhex_tpu_torch.ops.stream import (
    check_corners,
    coarse_rebuild,
    moved_grid,
    region_scatter,
    window_shift,
)
from voxelhex_tpu_torch.render.bitgrid import (
    BitGrid,
    _pack_bits,
    _pack_bits_batch,
    _pack_pyramid,
    device_bitgrid,
)
from voxelhex_tpu_torch.render.renderer import BitGridRenderer, check_options, resolve_device
from voxelhex_tpu_torch.tree.boxtree import BoxTree
from voxelhex_tpu_torch.tree.flat import coarse_candidate_cells, flatten, sample_coarse

REGION = 16  # voxels a paged region's edge (one region = 4^3 blocks)


def _padded_palette(tree: BoxTree) -> np.ndarray:
    """The tree's palette as f32 [P, 4] rows padded to a power of two of at
    least 64, so that edits adding colors keep the row count."""
    n_rows = 64
    while n_rows < max(1, len(tree.color_palette)):
        n_rows *= 2
    pal = np.zeros((n_rows, 4), dtype=np.float32)
    for i, c in enumerate(tree.color_palette):
        pal[i] = [c.r / 255.0, c.g / 255.0, c.b / 255.0, c.a / 255.0]
    return pal


def _color16(occ, col):
    """Sampled flat voxel values as u16 color indices: NO_COLOR_HIT becomes
    0xFFFE, an unoccupied cell the empty color."""
    col16 = np.where(col == NO_COLOR_HIT, 0xFFFE, np.clip(col, 0, 0xFFFD)).astype(np.uint16)
    return np.where(occ, col16, COLOR_EMPTY).astype(np.uint16)


def _upper_levels(lo0, hi0, nb):
    """Every level of a pyramid from its level-0 words (flat, x fastest):
    ``(occ_lo, occ_hi)`` of all levels, concatenated."""
    coarse0 = ((lo0 | hi0) != 0).reshape(nb, nb, nb).transpose(2, 1, 0)  # [x, y, z]
    levels_lo, levels_hi = [lo0], [hi0]
    grid = coarse0
    while grid.shape[0] > 1:
        lo, hi, grid = _pack_bits(grid)
        levels_lo.append(lo)
        levels_hi.append(hi)
    return np.concatenate(levels_lo), np.concatenate(levels_hi)


class FarTier:
    """One coarse LOD ring: a BitGrid over the world box [origin, origin +
    cells * factor) at cell edge ``factor``, with the box of the layer
    inside it (the window, or the next finer ring) cut out of its
    occupancy.  Cells are colored by coarse samples of the tree
    (``sample_coarse``) and found by a walk of its occupancy bits
    (``coarse_candidate_cells``), so a build costs what the content does."""

    def __init__(self, view: "StreamingView", factor: int, origin, cells: int,
                 anchor_align: int | None = None):
        self.view = view
        self.factor = int(factor)
        self.cells = int(cells)
        self.extent = self.cells * self.factor
        self.origin = np.asarray(origin, dtype=np.int64)
        # the alignment of a re-anchored origin (the next ring's cell edge,
        # so that this ring's box stays cuttable there); None: fixed
        self.anchor_align = anchor_align
        self._dirty_boxes: list = []  # world (lo, hi) boxes of edits
        self._hole = None  # the last (lo, hi) world box cut out
        self.renderer: BitGridRenderer | None = None
        self._occ, self._col = self._compute_pristine(self.origin, view._flat_snapshot())

    def world_box(self):
        return self.origin.copy(), self.origin + self.extent

    def _sample_cells(self, centers, flat):
        occ, col = sample_coarse(flat, centers, self.factor)
        return occ, _color16(occ, col)

    def _compute_pristine(self, origin, flat):
        """The (occ, col) grids of the world box at ``origin``, from the
        candidate cells of the tree's occupancy walk; mutates nothing."""
        C, F = self.cells, self.factor
        lo = np.asarray(origin, dtype=np.int64)
        hi = lo + self.extent
        occ_a = np.zeros((C, C, C), dtype=bool)
        col_a = np.full((C, C, C), COLOR_EMPTY, dtype=np.uint16)
        cand = coarse_candidate_cells(flat, F, lo, hi)
        if cand.shape[0] == 0:
            return occ_a, col_a
        occ, col16 = self._sample_cells(cand * F + F // 2, flat)
        local = cand - lo // F
        occ_a[local[:, 0], local[:, 1], local[:, 2]] = occ
        col_a[local[:, 0], local[:, 1], local[:, 2]] = col16
        return occ_a, col_a

    def _compute_update(self, occ_a, col_a, lo, hi, origin, flat):
        """Re-sample the cells of the world box [lo, hi) into the caller's
        (occ_a, col_a)."""
        C, F = self.cells, self.factor
        tlo = np.asarray(origin, dtype=np.int64)
        thi = tlo + self.extent
        c0 = np.maximum(np.asarray(lo, dtype=np.int64), tlo) // F
        c1 = (np.minimum(np.asarray(hi, dtype=np.int64), thi) + F - 1) // F
        base = tlo // F
        c0 = np.maximum(c0 - base, 0)
        c1 = np.minimum(c1 - base, C)
        if np.any(c1 <= c0):
            return
        axes = [np.arange(a, b, dtype=np.int64) for a, b in zip(c0, c1)]
        pts = (np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
               + base) * F + F // 2
        occ, col16 = self._sample_cells(pts, flat)
        shape = tuple(int(b - a) for a, b in zip(c0, c1))
        sl = tuple(slice(int(a), int(b)) for a, b in zip(c0, c1))
        occ_a[sl] = occ.reshape(shape)
        col_a[sl] = col16.reshape(shape)

    def note_edit(self, lo, hi):
        self._dirty_boxes.append((np.asarray(lo), np.asarray(hi)))

    def plan_refresh(self, hole_lo, hole_hi, flat):
        """The host side of a refresh, safe on a worker (it reads the tier
        and mutates nothing): the re-anchor, the edits' re-samples, the hole
        cut and the pyramid pack.  None when the ring is current, else the
        plan that :meth:`apply_refresh` takes."""
        C, F = self.cells, self.factor
        origin = self.origin
        re_anchor = False
        if self.anchor_align is not None:
            lo, hi = origin, origin + self.extent
            if not (np.all(np.asarray(hole_lo) >= lo) and np.all(np.asarray(hole_hi) <= hi)):
                W = int(self.view.tree.size)
                a = int(self.anchor_align)
                center = (np.asarray(hole_lo) + np.asarray(hole_hi)) // 2
                o = ((center - self.extent // 2) // a) * a
                origin = np.clip(o, 0, W - self.extent).astype(np.int64)
                re_anchor = True
        n_dirty = len(self._dirty_boxes)
        dirty = list(self._dirty_boxes[:n_dirty])
        hole = (tuple(int(v) for v in hole_lo), tuple(int(v) for v in hole_hi))
        edited = re_anchor or bool(dirty)
        if not edited and hole == self._hole and self.renderer is not None:
            return None
        if re_anchor:
            occ, col = self._compute_pristine(origin, flat)
        elif dirty:
            occ, col = self._occ.copy(), self._col.copy()
            for lo_e, hi_e in dirty:
                self._compute_update(occ, col, lo_e, hi_e, origin, flat)
        else:
            occ, col = self._occ, self._col
        holed = occ.copy()
        h0 = np.clip((np.asarray(hole_lo) - origin) // F, 0, C)
        h1 = np.clip((np.asarray(hole_hi) - origin + F - 1) // F, 0, C)
        holed[h0[0]:h1[0], h0[1]:h1[1], h0[2]:h1[2]] = False
        return {"origin": origin, "re_anchor": re_anchor, "n_dirty": n_dirty, "occ": occ,
                "col": col, "hole": hole, "edited": edited, "levels": _pack_pyramid(holed)}

    def apply_refresh(self, plan):
        """Swap a :meth:`plan_refresh` result in and update the ring on the
        device, from the render thread: the whole BitGrid after an edit or
        a re-anchor, only the word pairs after a move of the hole."""
        del self._dirty_boxes[: plan["n_dirty"]]
        if plan["re_anchor"]:
            self.origin = plan["origin"]
        self._occ, self._col = plan["occ"], plan["col"]
        self._hole = plan["hole"]
        levels_lo, levels_hi, bases = plan["levels"]
        dev = self.view.device
        if self.renderer is None or plan["edited"]:
            bg = BitGrid(size=self.cells, n_levels=len(levels_lo), level_bases=bases,
                         occ_lo=np.concatenate(levels_lo), occ_hi=np.concatenate(levels_hi),
                         colors=self._col.transpose(2, 1, 0).ravel(),
                         palette=_padded_palette(self.view.tree))
            if self.renderer is None:
                self.renderer = BitGridRenderer(bg, device=dev)
            else:
                self.renderer.bitgrid = bg
                self.renderer.tree = device_bitgrid(bg, dev)
                self.renderer.invalidate_beam()
            return
        bg = self.renderer.bitgrid
        bg.occ_lo = np.concatenate(levels_lo)
        bg.occ_hi = np.concatenate(levels_hi)
        pairs = np.stack([bg.occ_lo, bg.occ_hi], axis=1).astype(np.uint32)
        self.renderer.tree["occ_pairs"] = torch.from_numpy(pairs.view(np.int32)).to(dev)


class FarField:
    """Nested coarse LOD rings behind the window (a clipmap).

    A world at most 4 times the window is one whole-world grid at factor
    world / window (2 or 4).  A larger one is a stack of rings: the
    innermost is a box 4 times the window's at factor 4, anchored around
    the window; each next ring is 4 times larger at 4 times the factor, and
    the outermost covers the world.  Each ring cuts out the box of the layer
    inside it, so content renders once, at the finest layer that holds it.
    Rays that miss in the window continue through the rings inside-out."""

    def __init__(self, view: "StreamingView"):
        self.view = view
        self._job = None  # the ring build in flight: (future, generation)
        self._gen = 0  # edits so far; a build of an older generation is dropped
        self.swaps = 0  # ring refreshes applied (content_version)
        W = int(view.tree.size)
        S = int(view.view_size)
        self.tiers: list[FarTier] = []
        if W // S <= 4:
            F = max(W // S, 1)
            assert F * S == W and (F & (F - 1)) == 0
            assert REGION % F == 0
            self.tiers.append(FarTier(view, F, (0, 0, 0), W // F))
        else:
            F = 4  # the innermost ring's factor
            while True:
                extent = S * F  # S cells a ring
                if extent >= W:
                    self.tiers.append(FarTier(view, F, (0, 0, 0), W // F))
                    break
                o = self._center_origin(view, extent, 4 * F, W)
                self.tiers.append(FarTier(view, F, o, extent // F, anchor_align=4 * F))
                F *= 4

    @staticmethod
    def _center_origin(view, extent, align, W):
        center = view.origin + view.view_size // 2
        o = ((center - extent // 2) // align) * align
        return np.clip(o, 0, W - extent).astype(np.int64)

    # the innermost ring's fields, as the reference's single-tier surface
    @property
    def factor(self):
        return self.tiers[0].factor

    @property
    def _occ(self):
        return self.tiers[0]._occ

    @property
    def _col(self):
        return self.tiers[0]._col

    def note_edit(self, lo, hi):
        self._gen += 1
        for t in self.tiers:
            t.note_edit(lo, hi)

    def _plan_all(self, hole_lo, hole_hi, flat):
        """Plan every ring inside-out; a ring's hole is the box of the layer
        inside it, where a planned re-anchor moved it."""
        plans = []
        for t in self.tiers:
            p = t.plan_refresh(hole_lo, hole_hi, flat)
            plans.append(p)
            if p is not None and p["re_anchor"]:
                hole_lo = p["origin"]
                hole_hi = hole_lo + t.extent
            else:
                hole_lo, hole_hi = t.world_box()
        return plans

    def refresh(self):
        """Bring every ring up to date on the render thread."""
        view = self.view
        hole_lo = np.asarray(view.origin, dtype=np.int64)
        plans = self._plan_all(hole_lo, hole_lo + int(view.view_size), view._flat_snapshot())
        for t, p in zip(self.tiers, plans):
            if p is not None:
                t.apply_refresh(p)
                self.swaps += 1

    def refresh_async(self, pool) -> bool:
        """The refresh's host work on ``pool`` from a snapshot of the tree,
        while the old rings serve frames; a finished plan of the current
        generation swaps in here, on the render thread.  True when one
        landed in this call."""
        view = self.view
        if any(t.renderer is None for t in self.tiers):
            self.refresh()  # the first frame needs its rings
            return True
        swapped = False
        if self._job is not None:
            fut, gen = self._job
            if not fut.done():
                return False
            self._job = None
            if gen == self._gen:
                for t, p in zip(self.tiers, fut.result()):
                    if p is not None:
                        t.apply_refresh(p)
                        self.swaps += 1
                        swapped = True
        hole_lo = np.asarray(view.origin, dtype=np.int64)
        hole_hi = hole_lo + int(view.view_size)
        needs = any(t._dirty_boxes for t in self.tiers)
        if not needs:
            hl, hh = hole_lo, hole_hi
            for t in self.tiers:
                if (tuple(int(v) for v in hl), tuple(int(v) for v in hh)) != t._hole:
                    needs = True
                    break
                hl, hh = t.world_box()
        if needs:
            self._job = (pool.submit(self._plan_all, hole_lo, hole_hi, view._flat_snapshot()),
                         self._gen)
        return swapped


class StreamingView:
    """A camera-following resident window over a (possibly huge) host tree.

    Takes the reference's parameters in its order, then two keyword-only
    ones: ``device`` (``"cuda"`` by default; ``"cpu"`` runs the kernels'
    plain versions) and ``native`` (regions rasterize and pack in the host
    library, :mod:`voxelhex_tpu_torch.native`, whose failed build raises;
    ``False`` fills them one voxel at a time from the tree and packs them
    in NumPy, the same content).  ``fuse_plan`` changes no result and is
    accepted; ``prepass=True``, ``tracer="skip"`` and ``beam_prepass=True``
    raise ``NotImplementedError`` (ROADMAP.md queue 1 item 11)."""

    _ASYNC_CHUNK = 64  # regions a worker job

    def __init__(self, tree: BoxTree, view_size: int = 256, regions_per_update: int = 64,
                 prepass: bool = False, placeholder_lod: bool = True,
                 async_uploads: bool = False, occlusion_prune: bool = True,
                 far_field: bool = True, tracer: str = "stack", fuse_plan: bool = False,
                 beam_prepass: bool = False, async_far: bool = False, *, device="cuda",
                 native: bool = True):
        if view_size % REGION:
            raise ValueError(f"view_size {view_size} is not a multiple of {REGION}")
        check_options({"prepass": prepass, "tracer": tracer, "fuse_plan": fuse_plan})
        if beam_prepass:
            raise NotImplementedError("beam_prepass is not ported (ROADMAP.md queue 1 item 11, "
                                      "with item 3)")
        self.device = resolve_device(device)
        self.native = bool(native)
        self.tree = tree
        # the far field renders content beyond the window at coarse colors,
        # when the world is larger than the window
        self.far: FarField | None = None
        self._want_far = bool(far_field) and int(tree.size) > int(view_size)
        self.async_far = bool(async_far)
        self._far_pool = ThreadPoolExecutor(max_workers=1) if self.async_far else None
        self.view_size = int(view_size)
        self.regions_per_update = int(regions_per_update)
        self.placeholder_lod = bool(placeholder_lod)
        self._placeholder: set = set()  # regions holding coarse LOD content
        # regions inside a fully occluded tree node page coarse content once
        # and never real voxels
        self.occlusion_prune = bool(occlusion_prune)
        self._occluded: set = set()  # regions parked at LOD by occlusion
        self._occ_checked: set = set()  # dirty regions classified already
        self.origin = np.zeros(3, dtype=np.int64)  # the window's min corner

        # workers rasterize from an immutable snapshot; the mirrors and the
        # device are written on the render thread
        self._async = bool(async_uploads)
        self._gen = 0  # edits so far: a job of an older generation is dropped
        self._inflight: list = []  # (future, generation, origin, regions) chunks
        self._pool = ThreadPoolExecutor(max_workers=2) if self._async else None

        # the host mirrors of the window's grids
        S = self.view_size
        self._occ = np.zeros((S, S, S), dtype=bool)
        self._col = np.full((S, S, S), COLOR_EMPTY, dtype=np.uint16)
        self._resident = set()  # regions rasterized
        self._dirty: set = set()  # regions to (re-)page
        self.uploads = 0  # regions paged so far
        self._flat = None
        self._dev_palette_count = -1
        # the device window's level 0 changed since its levels above were
        # built: `update` rebuilds them once, after its last level-0 write
        self._levels_stale = False

        tree.update_triggers.append(self._on_tree_update)
        self.renderer: BitGridRenderer | None = None
        self._mark_window_dirty()

    # ------------------------------------------------------------------

    def _region_range(self):
        return self.view_size // REGION

    def _mark_window_dirty(self):
        n = self._region_range()
        self._dirty = {(x, y, z) for x in range(n) for y in range(n) for z in range(n)}
        self._resident.clear()
        self._occluded.clear()
        self._occ_checked.clear()

    def _on_tree_update(self, access_stack, sectants):
        """A tree edit: mark the edited node's regions dirty, re-classify
        every parked region (clearing a wall un-occludes what is behind it)
        and note the edit in the far field."""
        self._flat = None
        self._gen += 1
        if self._occluded:
            self._dirty |= self._occluded
            self._occluded.clear()
        self._occ_checked.clear()
        # the deepest node of the path: [mn, mn + size)
        size = float(self.tree.size)
        mn = np.zeros(3)
        for _key, sectant in access_stack[:-1]:
            size /= 4.0
            mn = mn + np.array([sectant % 4, (sectant // 4) % 4, sectant // 16]) * size
        if self.far is not None:
            self.far.note_edit(mn, mn + size)
        lo = np.maximum(mn - self.origin, 0)
        hi = np.minimum(mn + size - self.origin, self.view_size)
        if np.any(hi <= 0) or np.any(lo >= self.view_size):
            return
        r0 = (lo // REGION).astype(int)
        r1 = np.ceil(hi / REGION).astype(int)
        for x in range(r0[0], r1[0]):
            for y in range(r0[1], r1[1]):
                for z in range(r0[2], r1[2]):
                    self._dirty.add((x, y, z))
                    self._resident.discard((x, y, z))
                    self._placeholder.discard((x, y, z))
                    self._occluded.discard((x, y, z))

    # ------------------------------------------------------------------

    def _region_occluded(self, region) -> bool:
        """True when the region lies inside a tree node whose six same-size
        neighbours are all full (``occlusion == 0x3F``): its content cannot
        be a first hit, so it pages coarse content only."""
        lo = np.asarray(region, dtype=np.float64) * REGION + self.origin
        hi = lo + REGION
        if np.any(lo < 0) or np.any(hi > self.tree.size):
            return False
        stack = self.tree.access_stack(lo + REGION / 2.0)
        for key, bmin, bsize in stack[1:]:  # the root has no siblings
            if not (np.all(lo >= bmin) and np.all(hi <= bmin + bsize)):
                break  # the node no longer holds the whole region
            if (self.tree.node(key).occlusion & 0x3F) == 0x3F:
                return True
        return False

    def _desired_origin(self, camera_origin):
        """The window's min corner around ``camera_origin``, on the region
        grid and inside the world."""
        center = np.asarray(camera_origin, dtype=np.float64)
        origin = np.floor((center - self.view_size / 2.0) / REGION) * REGION
        origin = np.clip(origin, 0, max(self.tree.size - self.view_size, 0))
        return origin.astype(np.int64)

    def _frustum_order(self, camera):
        """The dirty regions in paging order: those in the camera's frustum
        first, each group nearest first."""
        regions = sorted(self._dirty)
        if not regions:
            return []
        arr = np.asarray(regions, dtype=np.float64)
        centers = arr * REGION + REGION / 2.0 + self.origin
        co = np.asarray(camera.origin, dtype=np.float64)
        forward, right, up = camera.basis()
        rel = centers - co
        dist = np.linalg.norm(rel, axis=1)
        z = rel @ np.asarray(forward, dtype=np.float64)
        x = rel @ np.asarray(right, dtype=np.float64)
        y = rel @ np.asarray(up, dtype=np.float64)
        tan_y = float(np.tan(np.radians(camera.fov_y_deg) / 2.0))
        w, h = camera.resolution
        tan_x = tan_y * w / h
        margin = REGION * 0.87  # the region's half diagonal
        inside = ((z > -margin)
                  & (np.abs(x) <= np.maximum(z, 0.0) * tan_x + 2 * margin)
                  & (np.abs(y) <= np.maximum(z, 0.0) * tan_y + 2 * margin))
        order = np.lexsort((dist, ~inside))
        return [regions[i] for i in order]

    def update(self, camera_origin, camera=None) -> int:
        """Move the window if needed and page up to ``regions_per_update``
        dirty regions (frustum first when ``camera`` is given); the device
        window's upper levels are rebuilt once, after the last level-0 write
        (none after a full upload).  Returns the number of regions still
        dirty."""
        new_origin = self._desired_origin(camera_origin)
        if not np.array_equal(new_origin, self.origin):
            shift = new_origin - self.origin
            self._shift_window(shift)
            if self.renderer is not None:
                self._shift_device(shift)
            self.origin = new_origin

        filled = []
        if self.occlusion_prune and self._dirty:
            to_check = self._dirty - self._occ_checked
            self._occ_checked |= to_check
            parked = {r for r in to_check if self._region_occluded(r)}
            if parked:
                fresh = [r for r in parked if r not in self._placeholder]
                if fresh:
                    self._fill_placeholders(fresh)
                    filled += fresh
                self._dirty -= parked
                self._occluded |= parked

        if self.placeholder_lod and self._dirty:
            fresh = [r for r in self._dirty if r not in self._placeholder]
            if fresh:
                self._fill_placeholders(fresh)
                filled += fresh

        queue = None
        if camera is not None and len(self._dirty) > self.regions_per_update:
            queue = self._frustum_order(camera)
        if self._async:
            uploaded, packed = self._drain_async()
            self._submit_async(queue)
        else:
            if queue is None:
                queue = list(self._dirty)
            batch = queue[: self.regions_per_update]
            packed = self._rasterize_batch_sync(batch)
            uploaded = []
            for region in batch:
                self._dirty.discard(region)
                self._resident.add(region)
                self._placeholder.discard(region)
                self.uploads += 1
                uploaded.append(region)

        touched = list({*uploaded, *filled})
        if self.renderer is None or len(touched) > (self._region_range() ** 3) // 2:
            if touched or self.renderer is None:
                self._rebuild_device()
        elif touched:
            self._update_device_partial(touched, packed=packed)
        if self._levels_stale:
            coarse_rebuild(self.renderer.tree)
            self._levels_stale = False
        return len(self._dirty)

    def _region_slice(self, region):
        return np.s_[region[0] * REGION: region[0] * REGION + REGION,
                     region[1] * REGION: region[1] * REGION + REGION,
                     region[2] * REGION: region[2] * REGION + REGION]

    def _rasterize_batch_sync(self, regions):
        """Fill a batch of regions' mirrors in one call of the host library;
        returns each region's wire rows ``(col_row, lo_row, hi_row)`` ({} on
        the NumPy route, whose device update packs from the mirrors)."""
        if not regions:
            return {}
        if not self.native:
            for region in regions:
                self._rasterize_region(region)
            return {}
        origin = tuple(int(v) for v in self.origin)
        wmins = [tuple(int(c) * REGION + o for c, o in zip(r, origin)) for r in regions]
        occ_xyz, col_xyz, col_rows, lo, hi = self._rasterize_batch_data(
            self._flat_snapshot(), wmins)
        packed = {}
        for i, region in enumerate(regions):
            sl = self._region_slice(region)
            self._occ[sl] = occ_xyz[i]
            self._col[sl] = col_xyz[i]
            packed[region] = (col_rows[i], lo[i], hi[i])
        return packed

    def _shift_window(self, shift):
        """The window moved: keep the content it still holds, mark the rest
        dirty."""
        S = self.view_size
        new_occ = np.zeros_like(self._occ)
        new_col = np.full_like(self._col, COLOR_EMPTY)
        src_lo = np.maximum(shift, 0)
        src_hi = np.minimum(S + shift, S)
        dst_lo = np.maximum(-shift, 0)
        if np.all(src_hi > src_lo):
            sl_src = tuple(slice(int(a), int(b)) for a, b in zip(src_lo, src_hi))
            spans = [int(b - a) for a, b in zip(src_lo, src_hi)]
            sl_dst = tuple(slice(int(a), int(a + s)) for a, s in zip(dst_lo, spans))
            new_occ[sl_dst] = self._occ[sl_src]
            new_col[sl_dst] = self._col[sl_src]
        self._occ, self._col = new_occ, new_col

        n = self._region_range()
        shift_r = shift // REGION

        def shift_set(regions):
            out = set()
            for x, y, z in regions:
                nx, ny, nz = x - shift_r[0], y - shift_r[1], z - shift_r[2]
                if 0 <= nx < n and 0 <= ny < n and 0 <= nz < n:
                    out.add((int(nx), int(ny), int(nz)))
            return out

        self._resident = shift_set(self._resident)
        self._placeholder = shift_set(self._placeholder)
        self._occluded = shift_set(self._occluded)
        self._occ_checked.clear()
        self._dirty = {(x, y, z) for x in range(n) for y in range(n) for z in range(n)
                       if (x, y, z) not in self._resident and (x, y, z) not in self._occluded}

    # ------------------------------------------------------------------
    # async uploads: workers rasterize from an immutable snapshot; the
    # mirrors and the device are written on the render thread

    @staticmethod
    def _rasterize_batch_data(flat, wmins):
        """Regions at world corners ``wmins`` rasterized and packed in one
        call of the host library (safe on a worker): ``(occ_xyz [K, R, R,
        R] bool, col_xyz [K, R, R, R] u16, col_rows [K, R^3] wire rows, lo
        [K, n^3], hi [K, n^3])``."""
        corners = np.asarray(wmins, dtype=np.int32)
        occ, col, lo, hi = native.rasterize_regions(flat, corners, REGION)
        K = corners.shape[0]
        shape = (K, REGION, REGION, REGION)
        occ_xyz = occ.reshape(shape).transpose(0, 3, 2, 1) != 0
        col_xyz = np.ascontiguousarray(col.reshape(shape).transpose(0, 3, 2, 1))
        return occ_xyz, col_xyz, col_xyz.reshape(K, -1), lo, hi

    def _submit_async(self, queue=None):
        if not self._dirty:
            return
        flat = self._flat_snapshot()
        gen, origin = self._gen, tuple(int(v) for v in self.origin)
        queued = {r for (_f, _g, _o, regions) in self._inflight for r in regions}
        budget = self.regions_per_update - len(queued)
        chunk = []
        for region in (queue if queue is not None else sorted(self._dirty)):
            if budget <= 0:
                break
            if region in queued:
                continue
            chunk.append(region)
            budget -= 1
        for i in range(0, len(chunk), self._ASYNC_CHUNK):
            part = chunk[i: i + self._ASYNC_CHUNK]
            wmins = [tuple(int(c) * REGION + o for c, o in zip(r, origin)) for r in part]
            fut = (self._pool.submit(self._rasterize_batch_data, flat, wmins) if self.native
                   else self._pool.submit(lambda: None))
            self._inflight.append((fut, gen, origin, tuple(part)))

    def _drain_async(self):
        """Apply the finished worker chunks to the mirrors: ``(regions,
        packed)``, the wire rows of each region for the device update."""
        done, packed = [], {}
        n = self._region_range()
        cur_origin = tuple(int(v) for v in self.origin)
        still = []
        for entry in self._inflight:
            fut, gen, origin, regions = entry
            if not fut.done():
                still.append(entry)
                continue
            if gen != self._gen:
                continue  # an edit came after the job's snapshot
            data = fut.result()  # None on the NumPy route
            for i, key in enumerate(regions):
                # a job holds world content: its regions in today's window
                region = tuple(k + (o - co) // REGION
                               for k, o, co in zip(key, origin, cur_origin))
                if not all(0 <= c < n for c in region) or region not in self._dirty:
                    continue
                if data is None:
                    self._rasterize_region(region)
                else:
                    occ_xyz, col_xyz, col_rows, lo, hi = data
                    sl = self._region_slice(region)
                    self._occ[sl] = occ_xyz[i]
                    self._col[sl] = col_xyz[i]
                    packed[region] = (col_rows[i], lo[i], hi[i])
                self._dirty.discard(region)
                self._resident.add(region)
                self._placeholder.discard(region)
                self.uploads += 1
                done.append(region)
        self._inflight = still
        return done, packed

    def close(self):
        """Stop the worker threads (a job that runs is waited for, the queued
        ones dropped) and take the view off its tree's ``update_triggers``,
        so that nothing the tree or a worker holds keeps the closed view and
        its device window alive.  A second call does nothing."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
        if self._far_pool is not None:
            self._far_pool.shutdown(wait=True, cancel_futures=True)
        if self._on_tree_update in self.tree.update_triggers:
            self.tree.update_triggers.remove(self._on_tree_update)

    def _shift_device(self, shift):
        """The window moved by ``shift`` (world voxels, multiples of
        ``REGION``): move the device grids by -shift (the window shift
        kernel, into new buffers; their upper levels wait for the update's
        one coarse rebuild), and move the host pyramid's level 0 likewise,
        its upper levels re-derived from it.  The exposed slab pages in as
        its regions rasterize."""
        S = self.view_size
        nb = S // 4
        bg = self.renderer.bitgrid
        tree_dev = self.renderer.tree
        tree_dev["colors"], tree_dev["occ_pairs"] = window_shift(tree_dev, shift)
        self._levels_stale = True

        sb = [int(v) // 4 for v in shift]
        lo0, hi0 = (moved_grid(torch.from_numpy(w[: nb**3].view(np.int32).reshape(nb, nb, nb)),
                               sb, 0).numpy().view(np.uint32).ravel()
                    for w in (bg.occ_lo, bg.occ_hi))
        bg.occ_lo, bg.occ_hi = _upper_levels(lo0, hi0, nb)
        bg.colors = self._col.transpose(2, 1, 0).ravel()
        self.renderer.invalidate_beam()

    def _flat_snapshot(self):
        """The flat snapshot of the host tree, cached until the next edit."""
        if self._flat is None:
            self._flat = flatten(self.tree)
        return self._flat

    def _fill_placeholders(self, regions):
        """Coarse placeholder content for regions not paged yet: each 4^3
        block of a region is a solid block of its coarse sample's color."""
        B = 4  # the placeholder block's edge, a bitmap block
        nb = REGION // B
        regions = [tuple(int(c) for c in r) for r in regions]
        base = np.asarray(regions, dtype=np.int64) * REGION + self.origin
        offs = np.stack(np.meshgrid(*[np.arange(nb)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
        q = (base[:, None, :] + offs[None, :, :] * B + B // 2).reshape(-1, 3)
        inside = np.all((q >= 0) & (q < self.tree.size), axis=1)
        occ = np.zeros(q.shape[0], dtype=bool)
        col = np.full(q.shape[0], EMPTY_DESC, dtype=np.int32)
        if inside.any():
            o, c = sample_coarse(self._flat_snapshot(), q[inside], B)
            occ[inside] = o
            col[inside] = c
        col16 = _color16(occ, col).reshape(len(regions), nb, nb, nb)
        occ = occ.reshape(len(regions), nb, nb, nb)
        for i, r in enumerate(regions):
            sl = self._region_slice(r)
            o_exp = occ[i].repeat(B, 0).repeat(B, 1).repeat(B, 2)
            c_exp = col16[i].repeat(B, 0).repeat(B, 1).repeat(B, 2)
            self._occ[sl] = o_exp
            self._col[sl] = np.where(o_exp, c_exp, COLOR_EMPTY)
            self._placeholder.add(r)

    def _rasterize_region(self, region):
        """Fill one region's mirrors from the host tree, one voxel at a time
        (the NumPy route of ``native=False``)."""
        x0, y0, z0 = (int(c) * REGION + o for c, o in zip(region, self.origin))
        occ = np.zeros((REGION, REGION, REGION), dtype=bool)
        col = np.full((REGION, REGION, REGION), COLOR_EMPTY, dtype=np.uint16)
        tree = self.tree
        if x0 < tree.size and y0 < tree.size and z0 < tree.size:
            for dx in range(min(REGION, tree.size - x0)):
                for dy in range(min(REGION, tree.size - y0)):
                    for dz in range(min(REGION, tree.size - z0)):
                        packed = tree.get_packed((x0 + dx, y0 + dy, z0 + dz))
                        if packed != 0xFFFFFFFF and not tree.pix_points_to_empty(packed):
                            occ[dx, dy, dz] = True
                            ci = packed & 0xFFFF
                            col[dx, dy, dz] = 0xFFFE if ci == 0xFFFF else ci
        sl = self._region_slice(region)
        self._occ[sl] = occ
        self._col[sl] = col

    def _update_device_partial(self, regions, packed=None):
        """Page the changed regions into the device grids: their corners and
        wire rows (colors u8, or u16 past 254 palette colors, and level-0
        word pairs) go to the region scatter (the update's coarse rebuild
        then re-derives the upper levels); the host pyramid follows.  ``packed``
        holds the host library's wire rows of freshly rasterized regions;
        the others (placeholders, the NumPy route) are packed from the
        mirrors here."""
        S = self.view_size
        bg = self.renderer.bitgrid
        tree_dev = self.renderer.tree
        nb = S // 4
        n = REGION // 4
        K = len(regions)
        corners = np.asarray(regions, dtype=np.int32) * REGION
        check_corners(corners, S)  # the kernel does not: it would read them back
        x0s, y0s, z0s = corners[:, 0], corners[:, 1], corners[:, 2]
        r = np.arange(REGION)
        xi = x0s[:, None, None, None] + r[None, :, None, None]
        yi = y0s[:, None, None, None] + r[None, None, :, None]
        zi = z0s[:, None, None, None] + r[None, None, None, :]
        if packed and all(rg in packed for rg in regions):
            col_rows = np.stack([packed[rg][0] for rg in regions])
            lo = np.stack([packed[rg][1] for rg in regions])
            hi = np.stack([packed[rg][2] for rg in regions])
        else:
            col_rows = self._col[xi, yi, zi].reshape(K, REGION**3)
            lo, hi = _pack_bits_batch(self._occ[xi, yi, zi])
        # the host pyramid: level-0 words of the regions, then the levels above
        b = np.arange(n)
        bxa = x0s[:, None, None, None] // 4 + b[None, :, None, None]
        bya = y0s[:, None, None, None] // 4 + b[None, None, :, None]
        bza = z0s[:, None, None, None] // 4 + b[None, None, None, :]
        abf = (bxa + bya * nb + bza * nb * nb).transpose(0, 3, 2, 1).reshape(-1)
        bg.occ_lo[abf] = lo.ravel()
        bg.occ_hi[abf] = hi.ravel()
        bg.colors[(xi + yi * S + zi * S * S).reshape(-1)] = col_rows.ravel()
        bg.occ_lo, bg.occ_hi = _upper_levels(bg.occ_lo[: nb**3], bg.occ_hi[: nb**3], nb)

        # the palette: edits may have added colors; past the padded rows the
        # view rebuilds in full
        n_colors = len(self.tree.color_palette)
        if n_colors > bg.palette.shape[0]:
            self._rebuild_device()
            return
        if n_colors != self._dev_palette_count:
            for i, c in enumerate(self.tree.color_palette):
                bg.palette[i] = [c.r / 255.0, c.g / 255.0, c.b / 255.0, c.a / 255.0]
            tree_dev["palette"] = torch.from_numpy(bg.palette.copy()).to(self.device)
            self._dev_palette_count = n_colors

        if n_colors <= 254:
            # u8 wire: the sentinels 0xFFFF and 0xFFFE travel as 255 and 254
            wire = np.where(col_rows == 0xFFFF, 255,
                            np.where(col_rows == 0xFFFE, 254, col_rows)).astype(np.uint8)
        else:
            wire = np.ascontiguousarray(col_rows, dtype=np.uint16).view(np.int16)
        blk = np.stack([lo, hi], axis=-1).astype(np.uint32).view(np.int32)
        dev = self.device
        region_scatter(tree_dev, torch.from_numpy(corners).to(dev),
                       torch.from_numpy(np.ascontiguousarray(wire)).to(dev),
                       torch.from_numpy(np.ascontiguousarray(blk)).to(dev))
        self._levels_stale = True
        self.renderer.invalidate_beam()

    def _rebuild_device(self):
        """Pack the whole pyramid on the host and upload the window."""
        self._levels_stale = False
        levels_lo, levels_hi, bases = _pack_pyramid(self._occ)
        self._dev_palette_count = len(self.tree.color_palette)
        bg = BitGrid(size=self.view_size, n_levels=len(levels_lo), level_bases=bases,
                     occ_lo=np.concatenate(levels_lo), occ_hi=np.concatenate(levels_hi),
                     colors=self._col.transpose(2, 1, 0).ravel(),
                     palette=_padded_palette(self.tree))
        if self.renderer is None:
            self.renderer = BitGridRenderer(bg, device=self.device)
        else:
            self.renderer.bitgrid = bg
            self.renderer.tree = device_bitgrid(bg, self.device)
            self.renderer.invalidate_beam()

    # ------------------------------------------------------------------

    def settled(self) -> bool:
        """True when no frame-affecting work remains: no region to page, no
        worker chunk in flight and, with rings, no edited box and no ring
        build in flight.  A frame rendered settled repeats until the next
        edit or move of the window."""
        if self._dirty or self._inflight:
            return False
        f = self.far
        if f is not None and (f._job is not None or any(t._dirty_boxes for t in f.tiers)):
            return False
        return True

    def content_version(self):
        """``(edit generation, regions paged, window origin, view size, ring
        swaps)``: two settled frames of equal versions and cameras are the
        same frame."""
        f = self.far
        return (self._gen, self.uploads, tuple(int(v) for v in self.origin),
                int(self.view_size), 0 if f is None else f.swaps)

    def layers(self, camera):
        """The far-frame kernel's layers for ``camera`` (world frame): the
        window's ``(tree, camera in the window, 1)``, then each ring's
        ``(tree, camera in the ring, factor)``; the cameras' origin and
        target are f32, a ring's divided by its factor in f32, as the
        reference's."""
        o32 = np.asarray(camera.origin, dtype=np.float32)
        t32 = np.asarray(camera.target, dtype=np.float32)
        w32 = self.origin.astype(np.float32)
        out = [(self.renderer.tree, replace(camera, origin=o32 - w32, target=t32 - w32), 1)]
        for tier in self.far.tiers if self.far is not None else ():
            F = float(tier.factor)
            torig = tier.origin.astype(np.float32)
            cam_t = replace(camera, origin=(o32 - torig) / F, target=(t32 - torig) / F)
            out.append((tier.renderer.tree, cam_t, tier.factor))
        return out

    def camera_inside(self, camera) -> bool:
        """The camera lies strictly inside the window's box."""
        co = np.asarray(camera.origin, dtype=np.float64)
        return bool(np.all((co > self.origin) & (co < self.origin + self.view_size)))

    def render(self, camera, bg=(0.0, 0.0, 0.0), out_u8: bool = False,
               out_device: bool = False):
        """Update the window for ``camera`` and render its frame: ``[h, w,
        3]`` f32, or u8 with ``out_u8``; a NumPy array, or the tensor on the
        view's device with ``out_device``.  With the far field (a world
        larger than the window) the frame is one launch of the far-frame
        kernel, rays that miss in the window running on through the rings;
        without it, one launch of the frame kernel."""
        self.update(np.asarray(camera.target, dtype=np.float64), camera=camera)
        if not self._want_far:
            cam_local = self.layers(camera)[0][1]
            return self.renderer.render(cam_local, bg=bg, out_u8=out_u8, out_device=out_device)
        if self.far is None:
            self.far = FarField(self)
        if self.async_far:
            self.far.refresh_async(self._far_pool)
        else:
            self.far.refresh()
        frame = render_far(self.layers(camera), self.camera_inside(camera), bg, out_u8,
                           self.renderer.max_iters)
        return frame if out_device else frame.cpu().numpy()
