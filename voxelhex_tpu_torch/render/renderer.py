"""Whole-frame renderer over the BitGrid (the reference's
``BitGridRenderer`` in ``render/bitgrid.py``, without compaction: one
thread per ray already stops each ray on its own, and the frame is the
same).  A frame is one launch of the frame kernel
(:func:`voxelhex_tpu_torch.ops.frame.render_frame`); a batch of up to
``KMAX`` frames is one launch of the batched kernel
(:func:`voxelhex_tpu_torch.ops.frames.render_frames`).

The reference's three start prepasses run before the frame, each its own
kernel, and give the frame a start map: the beam prepass
(``beam_prepass=True``, :mod:`~voxelhex_tpu_torch.ops.beam`; a batch runs
one beam launch, then one batched-kernel launch), the splat prepass
(``splat_prepass=True``, :mod:`~voxelhex_tpu_torch.ops.splat`) and the
depth prepass (``prepass=True``, :mod:`~voxelhex_tpu_torch.ops.prepass`).
Which one runs follows the reference's ``_render_impl``
(:meth:`BitGridRenderer.render`).

``tracer="skip"`` marches the reference's other tracer, the skip tracer
(:mod:`~voxelhex_tpu_torch.ops.skip`), over the grid's skip rows at every
entry point: ``trace``, ``render`` with or without a prepass (the depth
prepass's levels march it too, as the reference's do; the beam prepass
marches the stack automaton on its dilated grid whatever the tracer),
``render_many`` and ``render_delta_many``; each kernel has a skip
instance.

The stack automaton's options (``lateral_step``, ``parent_skip``,
``advance_substeps``) reach every route that marches the renderer's tracer,
as the reference's do: ``trace``, ``render`` and the frame after any start
prepass, the depth prepass's levels, ``render_many`` and
``render_delta_many``.  Other than the defaults they run the kernels'
optioned instances.  The beam prepass keeps its own tracer, ``render_lod``
and the skip tracer the reference's defaults.  ``color_u8`` stores the
color grid as u8 where the palette fits a byte (the reference's rule,
``device_bitgrid(..., color_u8=True)``); every kernel that reads colors has
u8 instances."""

from __future__ import annotations

import operator
import threading

import numpy as np
import torch

from voxelhex_tpu_torch.ops.beam import beam_tiles
from voxelhex_tpu_torch.ops.frame import expand_start, render_frame, render_lod
from voxelhex_tpu_torch.ops.frames import ROW_GROUP, render_frames, render_frames_digest
from voxelhex_tpu_torch.ops.prepass import prepass_start
from voxelhex_tpu_torch.ops.skip import trace_skip
from voxelhex_tpu_torch.ops.splat import splat_tiles
from voxelhex_tpu_torch.ops.stream import refresh_skip_rows
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, automaton_options, traverse
from voxelhex_tpu_torch.render.bitgrid import (
    BitGrid,
    bitgrid_from_occupancy,
    build_bitgrid,
    build_mip_colors,
    device_bitgrid,
)
from voxelhex_tpu_torch.render.camera import Camera
from voxelhex_tpu_torch.render.starts import BEAM_TILE, beam_level, beam_occupancy, splat_points
from voxelhex_tpu_torch.tree.boxtree import BoxTree
from voxelhex_tpu_torch.tree.flat import FlatTree

# The reference renderer's options, each with the values the kernels accept;
# None accepts any value the reference takes.  The frame is the same
# whatever plan or fusion the reference would pick; `prepass` runs the depth
# prepass of `prepass_levels` levels; `tracer="skip"` runs the skip tracer
# (csrc/skip.cuh), with `skip_substeps` >= 1 substeps a body iteration,
# which is read only with it; `lateral_step`, `parent_skip` and
# `advance_substeps` are the stack automaton's options (csrc/traverse.cuh
# TraceOptions), read only with the stack tracer; `color_u8` the color
# grid's storage.
RESULT_NEUTRAL = {
    "fuse_plan": None,
    "auto_plan": None,
    "prepass_levels": None,
    "skip_substeps": None,
    "prepass": None,
    "lateral_step": None,
    "advance_substeps": None,
    "tracer": ("stack", "skip"),
    "parent_skip": None,
    "color_u8": None,
}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_source(source) -> BitGrid:
    """The BitGrid to render from ``source``: a BitGrid as it is, a BoxTree
    or FlatTree through :func:`~voxelhex_tpu_torch.render.bitgrid.
    build_bitgrid` (the host library); anything else raises ``TypeError``."""
    if isinstance(source, BitGrid):
        return source
    if isinstance(source, (BoxTree, FlatTree)):
        return build_bitgrid(source)
    raise TypeError(f"the port renders a BitGrid, BoxTree or FlatTree, not "
                    f"{type(source).__name__} (convert.from_jax_bitgrid and "
                    "convert.from_jax_flat_tree take a reference BitGrid's or FlatTree's "
                    "fields)")


def check_options(options: dict) -> None:
    """Raise for a reference renderer option the kernels do not implement."""
    for name, value in options.items():
        allowed = RESULT_NEUTRAL[name]
        if allowed is not None and value not in allowed:
            raise NotImplementedError(
                f"{name}={value!r}: the kernels take {name} in {allowed!r}"
            )


def beam_spec_of(bitgrid: BitGrid, grids: dict, device, camera: Camera, tile: int):
    """``(grid, cell)`` of ``camera``'s beam level over ``bitgrid``, or
    None where the reference has no beam spec: the tile does not divide the
    resolution, or no level keeps the bound (``beam_level``).  The dilated
    grid of each level (:func:`~voxelhex_tpu_torch.render.starts.
    beam_occupancy`) is uploaded to ``device`` at first use and kept in
    ``grids``, one a level, until the caller clears it."""
    w, h = camera.resolution
    if w % tile or h % tile:
        return None
    L = beam_level(bitgrid.size, camera, tile)
    if L is None:
        return None
    grid = grids.get(L)
    if grid is None:
        occ = beam_occupancy(bitgrid, L)
        grid = grids[L] = device_bitgrid(bitgrid_from_occupancy(occ), device)
    return grid, float(4**L)


class BitGridRenderer:
    """Renders frames of one BitGrid on one device; ``source`` is a BitGrid,
    a BoxTree or a FlatTree (:func:`check_source`).

    Takes the reference ``BitGridRenderer``'s parameters in its order:
    ``max_iters`` is the kernels' step limit per ray; ``prepass`` runs the
    depth prepass of ``prepass_levels`` levels before each frame; the
    options of ``RESULT_NEUTRAL`` are accepted at the values the kernels
    take; any other value raises.  ``tracer="skip"`` uploads the grid's
    skip rows and marches the skip tracer, ``skip_substeps`` substeps a
    body iteration.  ``lateral_step``, ``parent_skip`` and
    ``advance_substeps`` (an int; 0 or less: an ADVANCE moves nothing) are
    the stack automaton's options (``self.options``, None at the
    defaults); ``color_u8`` stores the colors as u8 where the palette fits
    a byte (``self.tree["colors"].dtype``).  ``device`` is keyword-only."""

    def __init__(self, source, max_iters: int = MAX_ITERS, prepass: bool = False,
                 prepass_levels: int = 2, lateral_step: bool = True, parent_skip: bool = False,
                 advance_substeps: int = 4, auto_plan: bool = False, fuse_plan: bool = False,
                 color_u8: bool = False, tracer: str = "stack", skip_substeps: int = 3, *,
                 device="cuda"):
        check_options({"prepass": prepass, "prepass_levels": prepass_levels,
                       "lateral_step": lateral_step, "parent_skip": parent_skip,
                       "advance_substeps": advance_substeps, "auto_plan": auto_plan,
                       "fuse_plan": fuse_plan, "color_u8": color_u8, "tracer": tracer,
                       "skip_substeps": skip_substeps})
        self.device = resolve_device(device)
        self.bitgrid = check_source(source)
        self.max_iters = int(max_iters)
        self.prepass = bool(prepass)
        self.prepass_levels = int(prepass_levels)
        if self.prepass_levels < 0:
            raise ValueError(f"prepass_levels {prepass_levels}")
        self.tracer = tracer
        # the skip tracer's substeps, None for the stack automaton: what the
        # kernels' wrappers take
        self.skip_substeps = int(skip_substeps) if tracer == "skip" else None
        if self.skip_substeps is not None and self.skip_substeps < 1:
            raise ValueError(f"skip_substeps {skip_substeps}: the skip tracer takes 1 or more")
        # the stack automaton's options as the wrappers take them, None at
        # the defaults (the default instances) and under the skip tracer,
        # which has none; advance_substeps is an int, as the reference's
        # range() takes it
        self.options = None if tracer == "skip" else automaton_options(
            lateral_step, parent_skip, operator.index(advance_substeps))
        self.color_u8 = bool(color_u8)
        self.tree = device_bitgrid(self.bitgrid, self.device, skip_rows=tracer == "skip",
                                   color_u8=self.color_u8)
        # the beam prepass's tile, and what the prepasses derive from the
        # content until invalidate_beam: the dilated grid of each beam level
        # on the device, and the splat prepass's surface centers
        self.beam_tile = BEAM_TILE
        self._beam_grids: dict = {}
        self._splat_pts = None
        # render, render_many and render_delta_many hold it, as the
        # reference's do: the delta baseline and last_stats are shared by
        # every thread that renders with this renderer
        self._render_lock = threading.RLock()
        # render_delta_many's baseline: (key, last frame on the device, the
        # same frame on the host), and the key whose reconstruction was
        # checked against a full fetch
        self._delta_state = None
        self._delta_validated = None
        # render_delta_many's pose token of the batch before (pose_validated),
        # and the content version that invalidate_beam moves on
        self._pose_token = None
        self._content_version = 0
        self.last_stats: dict = {}

    @staticmethod
    def resolve_entries(host_tree, hit, hvox):
        """The host tree's entry (color and user data) of each ray's hit
        voxel, None for a miss: the card carries only what renders, and a
        query of user data goes through the host tree.  ``hit`` [R] and
        ``hvox`` [R, 3] as ``trace`` returns them, on any device."""
        hit = np.asarray(hit.cpu() if isinstance(hit, torch.Tensor) else hit)
        hvox = np.asarray(hvox.cpu() if isinstance(hvox, torch.Tensor) else hvox)
        return [host_tree.get(tuple(int(c) for c in v)) if h else None
                for h, v in zip(hit, hvox)]

    def trace(self, origins, dirs):
        """``(hit, voxel, hvox, point, hnormal)`` for f32 [R, 3] rays on the
        renderer's device, with the reference renderer's tracer settings."""
        if self.skip_substeps is not None:
            return trace_skip(self.tree, origins, dirs, self.max_iters, self.skip_substeps)
        return traverse(self.tree, origins, dirs, self.max_iters, self.options)

    # ---- the start prepasses

    def _beam_spec(self, camera: Camera, tile: int | None = None):
        """``(grid, cell)`` of ``camera``'s beam level, or None where the
        reference has no beam spec (:func:`beam_spec_of`); the dilated grids
        are kept until the content changes."""
        return beam_spec_of(self.bitgrid, self._beam_grids, self.device, camera,
                            tile or self.beam_tile)

    def beam_map(self, camera: Camera, tile: int | None = None):
        """The beam prepass's start map of ``camera``, f32 ``[h / tile, w /
        tile]`` on the renderer's device (one beam launch), or None where
        the camera has no beam level."""
        tile = tile or self.beam_tile
        spec = self._beam_spec(camera, tile)
        if spec is None:
            return None
        return beam_tiles([(*spec, camera)], tile, self.device)[0]

    def beam_start(self, camera: Camera, tile: int | None = None):
        """Each ray's conservative start from the beam prepass, f32 ``[h *
        w]`` on the renderer's device, or None where the camera has no beam
        level (the reference's ``beam_start``)."""
        tile = tile or self.beam_tile
        w, h = camera.resolution
        with self._render_lock:
            starts = self.beam_map(camera, tile)
            return None if starts is None else expand_start(starts, tile, w, h)

    def _splat_points(self) -> torch.Tensor:
        """The surface voxels' centers on the device, f32 [N, 3]
        (:func:`~voxelhex_tpu_torch.render.starts.splat_points`), kept
        until the content changes (:meth:`invalidate_beam`)."""
        if self._splat_pts is None:
            self._splat_pts = torch.from_numpy(splat_points(self.bitgrid)).to(self.device)
        return self._splat_pts

    def splat_start(self, camera: Camera, margin: float = 3.0):
        """Each ray's conservative start from the splat prepass, f32 ``[h *
        w]`` on the renderer's device (the reference's ``splat_start``); the
        resolution must be even."""
        w, h = camera.resolution
        with self._render_lock:
            return expand_start(splat_tiles(self._splat_points(), camera, margin), 2, w, h)

    def _frame_start(self, camera: Camera, compact: bool, splat_prepass: bool,
                     beam_prepass: bool):
        """``(start map, tile, prepass)`` of a frame as the reference's
        ``_render_impl`` picks its prepass, or ``(None, 1, None)`` for the
        plain frame: the depth prepass when ``prepass`` leaves levels
        (``prepass_levels``, less while 2^levels does not divide the
        resolution); else, with ``compact`` only, the beam prepass when the
        camera has a beam level, else the splat prepass at an even
        resolution."""
        w, h = camera.resolution
        levels = self.prepass_levels if self.prepass else 0
        while levels and (h % (2**levels) or w % (2**levels)):
            levels -= 1
        if levels:
            return prepass_start(self.tree, camera, levels, self.max_iters, self.skip_substeps,
                                 options=self.options), 2, "depth"
        if not compact:
            return None, 1, None
        if beam_prepass:
            starts = self.beam_map(camera)
            if starts is not None:
                return starts, self.beam_tile, "beam"
        if splat_prepass and h % 2 == 0 and w % 2 == 0:
            return splat_tiles(self._splat_points(), camera), 2, "splat"
        return None, 1, None

    def render(self, camera: Camera, bg=(0.0, 0.0, 0.0), compact: bool = True,
               out_u8: bool = False, out_device: bool = False,
               splat_prepass: bool = False, beam_prepass: bool = False,
               defer_validation: bool = False):
        """A ``[h, w, 3]`` frame, with the reference's keywords and defaults:
        f32, or u8 when ``out_u8``; a NumPy array, or the tensor on the
        renderer's device when ``out_device``.  On the card it is one launch
        of the frame kernel, from the camera params to the pixels, after
        the launches of the prepass that :meth:`_frame_start` picks: the
        frame starts its rays from the prepass's start map, with no host
        read between them.  ``last_stats["prepass"]`` names the prepass
        that ran (``"beam"``, ``"splat"``, ``"depth"`` or None) and
        ``last_stats["beam_fused"]`` whether the beam ran.

        ``compact=False`` renders as the reference's does without
        compaction: the depth prepass, never the beam or splat prepass.
        ``defer_validation`` changes no result here: a frame has no plan to
        validate."""
        del defer_validation
        w, h = camera.resolution
        with self._render_lock:
            start, tile, kind = self._frame_start(camera, compact, splat_prepass, beam_prepass)
            out = render_frame(self.tree, camera, bg, out_u8, self.max_iters, start, tile,
                               self.skip_substeps, self.options)
            self.last_stats = {"rays": w * h, "prepass": kind, "beam_fused": kind == "beam"}
        return out if out_device else out.cpu().numpy()

    def render_lod(self, camera: Camera, lod_scale: float, bg=(0.0, 0.0, 0.0)):
        """A ``[h, w, 3]`` f32 NumPy frame with distance LOD (the reference's
        ``render_lod``): rays stop descending once a cell subtends about
        ``1 / lod_scale`` of its distance and shade from that level's MIP
        colors.  The MIP grids are built on the host at the first call
        (:func:`~voxelhex_tpu_torch.render.bitgrid.build_mip_colors`) and
        added to the device tree, whose other arrays (the skip rows) stay,
        until the content changes (:meth:`invalidate_beam`).  On the card it
        is one launch of ``frame_lod_kernel``
        (:func:`~voxelhex_tpu_torch.ops.frame.render_lod`); the march is the
        stack automaton with the reference's tracer defaults, whatever the
        renderer's ``tracer`` and automaton options; the colors are read
        from the tree's grid, u16 or u8."""
        with self._render_lock:
            if self.bitgrid.mip_rgb is None:
                build_mip_colors(self.bitgrid)
            if "mip_rgb_0" not in self.tree:
                for l, grid in enumerate(self.bitgrid.mip_rgb):
                    self.tree[f"mip_rgb_{l}"] = torch.from_numpy(grid).to(self.device)
            out = render_lod(self.tree, camera, lod_scale, bg, self.max_iters)
            w, h = camera.resolution
            self.last_stats = {"rays": w * h, "lod_scale": float(lod_scale)}
        return out.cpu().numpy()

    def invalidate_beam(self):
        """The content-change hook of the reference's edit pattern: swap
        ``renderer.bitgrid`` and ``renderer.tree`` (``device_bitgrid`` of
        the new BitGrid on the renderer's device, with
        ``color_u8=renderer.color_u8`` to keep the color storage; a tree of
        either storage renders), then call this.  It drops
        what the prepasses derived from the old content: the beam grids and
        the splat prepass's surface centers (the reference keeps its splat
        centers, so that its splat starts go on from the old surface:
        ROADMAP.md queue 3).  It checks that the new tree is on the
        renderer's device and matches the BitGrid.  The delta baseline
        survives, as in the reference: it is only a diff base, so the next
        :meth:`render_delta_many` fetches just the rows that the change
        moved; the content version moves on, so the next batch is not
        ``pose_validated``.  Under ``tracer="skip"`` it derives the new
        tree's skip rows from its word pairs, on the device
        (:func:`~voxelhex_tpu_torch.ops.stream.refresh_skip_rows`).  It
        drops the MIP colors of :meth:`render_lod`."""
        self._content_version += 1
        self._beam_grids.clear()
        self._splat_pts = None
        t, bg = self.tree, self.bitgrid
        if t["occ_pairs"].device.type != self.device.type:
            raise ValueError(f"renderer.tree is on {t['occ_pairs'].device}, the renderer on "
                             f"{self.device}")
        if int(t["size"]) != bg.size or len(t["bases"]) != bg.n_levels:
            raise ValueError("renderer.tree does not match renderer.bitgrid")
        if self.skip_substeps is not None:
            refresh_skip_rows(t)
        # the MIP colors follow the content: render_lod builds them anew
        # (the reference keeps a BitGrid's MIP colors through an edit made
        # in place: ROADMAP.md queue 3)
        bg.mip_rgb = None
        for key in [k for k in t if k.startswith("mip_rgb_")]:
            del t[key]

    @staticmethod
    def _batch_resolution(cameras):
        """The batch's one resolution, or None for an empty list or mixed
        resolutions (the reference's gates)."""
        if not cameras:
            return None
        res = tuple(cameras[0].resolution)
        return res if all(tuple(c.resolution) == res for c in cameras) else None

    def _batch_beams(self, cameras):
        """The batch's beam start maps ``(maps, tile, use)``
        (:mod:`~voxelhex_tpu_torch.ops.frames`), one beam launch a ``KMAX``
        cameras, or None when ``cameras[0]`` has no beam spec (the
        reference's gate).  Each camera marches its own beam level; a
        camera with none takes the plain march, so each frame is
        :meth:`render`'s of its camera with ``beam_prepass=True`` (the
        reference takes ``cameras[0]``'s level for the whole batch:
        ROADMAP.md queue 3)."""
        first = self._beam_spec(cameras[0])
        if first is None:
            return None
        # a pose repeated in the batch is looked up once
        by_id = {id(cameras[0]): first}
        for c in cameras[1:]:
            if id(c) not in by_id:
                by_id[id(c)] = self._beam_spec(c)
        specs = [by_id[id(c)] for c in cameras]
        beams = [(None, 1.0, c) if s is None else (*s, c) for s, c in zip(specs, cameras)]
        maps = beam_tiles(beams, self.beam_tile, self.device)
        return maps, self.beam_tile, [s is not None for s in specs]

    def render_many(self, cameras, bg=(0.0, 0.0, 0.0), out_u8: bool = False,
                    beam_prepass: bool = False, out_device: bool = False):
        """K frames of one resolution: ``[K, h, w, 3]``, f32 or u8, a NumPy
        array or the device tensor with ``out_device``; each equals
        :meth:`render`'s frame of its camera.  On the card it is one launch
        of the batched kernel for each ``KMAX`` cameras, after one launch of
        the beam kernel with ``beam_prepass`` (:meth:`_batch_beams`).
        ``None`` for an empty list, mixed resolutions, or ``beam_prepass``
        where ``cameras[0]`` has no beam spec, as the reference returns; the
        port has no plan to wait for."""
        cameras = list(cameras)
        res = self._batch_resolution(cameras)
        if res is None:
            return None
        with self._render_lock:
            starts = self._batch_beams(cameras) if beam_prepass else None
            if beam_prepass and starts is None:
                return None
            frames, _n, _f = render_frames(self.tree, cameras, bg, out_u8, self.max_iters,
                                           starts=starts, skip_substeps=self.skip_substeps,
                                           options=self.options)
            self.last_stats = {"rays": res[0] * res[1] * len(cameras),
                               "batched_frames": len(cameras), "beam_fused": bool(beam_prepass)}
        return frames if out_device else frames.cpu().numpy()

    def render_delta_many(self, cameras, bg=(0.0, 0.0, 0.0), beam_prepass: bool = False):
        """K u8 frames of one resolution, fetching only what changed: a list
        of K ``[h, w, 3]`` u8 arrays, where consecutive unchanged frames are
        the same ndarray object (treat them as read-only), or ``None`` for
        an empty list or mixed resolutions.

        The frames and their row digests (:mod:`~voxelhex_tpu_torch.ops.
        frames`) come from one launch of the batched kernel for each
        ``KMAX`` cameras; frame 0 is compared with the baseline, the last
        frame of the batch before.  One blocking read takes the digests to
        the host.  A frame whose rows did not change is the frame before it;
        a change inside one contiguous band of flagged row groups covering
        less than half the rows fetches that band and patches it into a copy
        of the frame before; any other change fetches the frame.  With
        ``beam_prepass`` the batch's beams run first, one launch
        (:meth:`_batch_beams`), and the call returns None where
        ``cameras[0]`` has no beam spec.

        The baseline is keyed on (w, h, bg, max_iters), not on the content,
        so it survives an edit (:meth:`invalidate_beam`).  It starts as an
        all-zero frame, and frame 0 of the first batch is fetched in full.
        The first batch of each key also fetches its last frame in full and
        checks the reconstruction against it; a mismatch raises
        ``AssertionError``.  ``last_stats`` holds the reference's keys and
        ``host_reads``, the blocking reads of the batch.

        ``last_stats["pose_validated"]`` is the reference's rule: the batch's
        token equals the batch before's.  The token is the key (with
        ``bg``), the device tree (its tensors' identity and the content
        version that :meth:`invalidate_beam` moves on), whether the beam
        prepass runs, and each camera's origin, target and up as f32 and
        its fov."""
        cameras = list(cameras)
        res = self._batch_resolution(cameras)
        if res is None:
            return None
        w, h = res
        K = len(cameras)
        key = (w, h, tuple(float(v) for v in np.asarray(bg, dtype=np.float32).reshape(3)),
               self.max_iters)
        t = self.tree
        token = (key, id(t["occ_pairs"]), id(t["colors"]), id(t["palette"]),
                 self._content_version, bool(beam_prepass),
                 tuple((tuple(np.asarray(c.origin, dtype=np.float32)),
                        tuple(np.asarray(c.target, dtype=np.float32)),
                        tuple(np.asarray(c.up, dtype=np.float32)), float(c.fov_y_deg))
                       for c in cameras))
        with self._render_lock:
            starts = self._batch_beams(cameras) if beam_prepass else None
            if beam_prepass and starts is None:
                return None
            pose_validated = token == self._pose_token
            self._pose_token = None  # until this batch has delivered its frames
            state = self._delta_state
            if state is None or state[0] != key:
                prev_dev = torch.zeros((h, w, 3), dtype=torch.uint8, device=self.device)
                prev_host = None
            else:
                _key, prev_dev, prev_host = state
            frames_dev, digest = render_frames_digest(self.tree, cameras, bg, self.max_iters,
                                                      prev=prev_dev, starts=starts,
                                                      skip_substeps=self.skip_substeps,
                                                      options=self.options)
            digest = _read(digest)  # the batch's one blocking read of the digests
            nrows, flags = digest[:, 0], digest[:, 1:]
            frames, cur, fetched, rows_fetched, reads = [], prev_host, 0, 0, 1
            for k in range(K):
                if nrows[k] != 0 or cur is None:
                    fetched += 1
                    reads += 1
                    groups = np.flatnonzero(flags[k])
                    lo = int(groups[0]) * ROW_GROUP if groups.size else 0
                    hi = min(int(groups[-1] + 1) * ROW_GROUP, h) if groups.size else h
                    if cur is not None and (hi - lo) * 2 < h:
                        cur = cur.copy()
                        cur[lo:hi] = _read(frames_dev[k, lo:hi])
                        rows_fetched += hi - lo
                    else:
                        cur = _read(frames_dev[k])
                        rows_fetched += h
                frames.append(cur)
            if self._delta_validated != key:
                reads += 1
                if not np.array_equal(frames[-1], _read(frames_dev[-1])):
                    self._delta_state = None
                    raise AssertionError("render_delta_many: reconstruction mismatch")
                self._delta_validated = key
            # a copy: a view of the last frame would keep the whole batch alive
            self._delta_state = (key, frames_dev[-1].clone(), frames[-1])
            self._pose_token = token
            self.last_stats = {"rays": w * h * K, "batched_frames": K, "delta": True,
                               "delta_fetched": fetched, "delta_rows_fetched": rows_fetched,
                               "pose_validated": pose_validated, "host_reads": reads,
                               "beam_fused": bool(beam_prepass)}
        return frames


def _read(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as an array of its own: a CUDA tensor through
    pinned memory, one blocking copy."""
    if t.device.type == "cpu":
        return t.numpy().copy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()
