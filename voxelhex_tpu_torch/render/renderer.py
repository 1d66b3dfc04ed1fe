"""Whole-frame renderer over the BitGrid (the reference's
``BitGridRenderer`` in ``render/bitgrid.py``, without compaction or beam
prepass: one thread per ray already stops each ray on its own, and the
frame is the same).  A frame is one launch of the frame kernel
(:func:`voxelhex_tpu_torch.ops.frame.render_frame`); a batch of up to
``KMAX`` frames is one launch of the batched kernel
(:func:`voxelhex_tpu_torch.ops.frames.render_frames`)."""

from __future__ import annotations

import threading

import numpy as np
import torch

from voxelhex_tpu_torch.ops.frame import render_frame
from voxelhex_tpu_torch.ops.frames import ROW_GROUP, render_frames, render_frames_digest
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, traverse
from voxelhex_tpu_torch.render.bitgrid import BitGrid, build_bitgrid, device_bitgrid
from voxelhex_tpu_torch.render.camera import Camera
from voxelhex_tpu_torch.tree.boxtree import BoxTree
from voxelhex_tpu_torch.tree.flat import FlatTree

# The reference renderer's options that change no result here, each with the
# values the kernels accept (csrc/traverse.cuh fixes the tracer settings);
# None accepts any value.  The frame is the same whatever plan, fusion or
# color storage the reference would pick; `prepass_levels` and
# `skip_substeps` are read only with `prepass=True` and `tracer="skip"`.
RESULT_NEUTRAL = {
    "fuse_plan": None,
    "auto_plan": None,
    "prepass_levels": None,
    "skip_substeps": None,
    "prepass": (False,),
    "lateral_step": (True,),
    "advance_substeps": (4,),
    "tracer": ("stack",),
    "parent_skip": (False,),
    "color_u8": (False,),
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
        if name not in RESULT_NEUTRAL:
            raise TypeError(f"unexpected keyword argument {name!r}")
        allowed = RESULT_NEUTRAL[name]
        if allowed is not None and value not in allowed:
            raise NotImplementedError(
                f"{name}={value!r}: the kernels fix {name}={allowed[0]!r}; other renderer "
                "options are ROADMAP.md queue 1 item 11"
            )


class BitGridRenderer:
    """Renders frames of one BitGrid on one device; ``source`` is a BitGrid,
    a BoxTree or a FlatTree (:func:`check_source`).

    Takes the reference ``BitGridRenderer``'s keywords: ``max_iters`` is the
    kernels' step limit per ray; the options of ``RESULT_NEUTRAL`` are
    accepted at the values the kernels fix; any other value raises."""

    def __init__(self, source, device="cuda", max_iters: int = MAX_ITERS, **options):
        check_options(options)
        self.device = resolve_device(device)
        self.bitgrid = check_source(source)
        self.max_iters = int(max_iters)
        self.tree = device_bitgrid(self.bitgrid, self.device)
        # render, render_many and render_delta_many hold it, as the
        # reference's do: the delta baseline and last_stats are shared by
        # every thread that renders with this renderer
        self._render_lock = threading.RLock()
        # render_delta_many's baseline: (key, last frame on the device, the
        # same frame on the host), and the key whose reconstruction was
        # checked against a full fetch
        self._delta_state = None
        self._delta_validated = None
        self.last_stats: dict = {}

    def trace(self, origins, dirs):
        """``(hit, voxel, hvox, point, hnormal)`` for f32 [R, 3] rays on the
        renderer's device, with the reference renderer's tracer settings."""
        return traverse(self.tree, origins, dirs, self.max_iters)

    def render(self, camera: Camera, bg=(0.0, 0.0, 0.0), compact: bool = True,
               out_u8: bool = False, out_device: bool = False,
               splat_prepass: bool = False, beam_prepass: bool = False,
               defer_validation: bool = False):
        """A ``[h, w, 3]`` frame, with the reference's keywords and defaults:
        f32, or u8 when ``out_u8``; a NumPy array, or the tensor on the
        renderer's device when ``out_device``.  On the card it is one launch
        of the frame kernel, from the camera params to the pixels.

        ``compact`` and ``defer_validation`` change no result here: one
        thread per ray stops each ray on its own, and a frame has no plan to
        validate.  The beam and splat prepasses are not ported (ROADMAP.md
        queue 1 items 3 and 11)."""
        del compact, defer_validation
        if beam_prepass or splat_prepass:
            raise NotImplementedError(
                "beam_prepass and splat_prepass are not ported (ROADMAP.md queue 1 items 3 "
                "and 11)"
            )
        with self._render_lock:
            out = render_frame(self.tree, camera, bg, out_u8, self.max_iters)
        return out if out_device else out.cpu().numpy()

    def invalidate_beam(self):
        """The content-change hook of the reference's edit pattern: swap
        ``renderer.bitgrid`` and ``renderer.tree`` (``device_bitgrid`` of
        the new BitGrid on the renderer's device), then call this.  The port
        keeps nothing derived from the content between calls (no beam grids,
        no validated pose: every launch reads ``self.tree``), so the hook
        checks that the new tree is on the renderer's device and matches the
        BitGrid.  The delta baseline survives, as in the reference: it is
        only a diff base, so the next :meth:`render_delta_many` fetches just
        the rows that the change moved."""
        t, bg = self.tree, self.bitgrid
        if t["occ_pairs"].device.type != self.device.type:
            raise ValueError(f"renderer.tree is on {t['occ_pairs'].device}, the renderer on "
                             f"{self.device}")
        if int(t["size"]) != bg.size or len(t["bases"]) != bg.n_levels:
            raise ValueError("renderer.tree does not match renderer.bitgrid")

    @staticmethod
    def _batch_resolution(cameras, beam_prepass):
        """The batch's one resolution, or None for an empty list or mixed
        resolutions (the reference's gates)."""
        if beam_prepass:
            raise NotImplementedError("beam_prepass is not ported (ROADMAP.md queue 1 item 3)")
        if not cameras:
            return None
        res = tuple(cameras[0].resolution)
        return res if all(tuple(c.resolution) == res for c in cameras) else None

    def render_many(self, cameras, bg=(0.0, 0.0, 0.0), out_u8: bool = False,
                    beam_prepass: bool = False, out_device: bool = False):
        """K frames of one resolution: ``[K, h, w, 3]``, f32 or u8, a NumPy
        array or the device tensor with ``out_device``; each equals
        :meth:`render`'s frame of its camera.  On the card it is one launch
        of the batched kernel for each ``KMAX`` cameras.  ``None`` for an
        empty list or mixed resolutions, as the reference returns; the port
        has no plan to wait for.  The beam prepass raises (ROADMAP.md queue
        1 item 3)."""
        cameras = list(cameras)
        res = self._batch_resolution(cameras, beam_prepass)
        if res is None:
            return None
        with self._render_lock:
            frames, _n, _f = render_frames(self.tree, cameras, bg, out_u8, self.max_iters)
            self.last_stats = {"rays": res[0] * res[1] * len(cameras),
                               "batched_frames": len(cameras)}
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
        of the frame before; any other change fetches the frame.

        The baseline is keyed on (w, h, bg, max_iters), not on the content,
        so it survives an edit (:meth:`invalidate_beam`).  It starts as an
        all-zero frame, and frame 0 of the first batch is fetched in full.
        The first batch of each key also fetches its last frame in full and
        checks the reconstruction against it; a mismatch raises
        ``AssertionError``.  ``last_stats`` holds the reference's keys and
        ``host_reads``, the blocking reads of the batch."""
        cameras = list(cameras)
        res = self._batch_resolution(cameras, beam_prepass)
        if res is None:
            return None
        w, h = res
        K = len(cameras)
        key = (w, h, tuple(float(v) for v in np.asarray(bg, dtype=np.float32).reshape(3)),
               self.max_iters)
        with self._render_lock:
            state = self._delta_state
            if state is None or state[0] != key:
                prev_dev = torch.zeros((h, w, 3), dtype=torch.uint8, device=self.device)
                prev_host = None
            else:
                _key, prev_dev, prev_host = state
            frames_dev, digest = render_frames_digest(self.tree, cameras, bg, self.max_iters,
                                                      prev=prev_dev)
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
            self._delta_state = (key, frames_dev[-1], frames[-1])
            self.last_stats = {"rays": w * h * K, "batched_frames": K, "delta": True,
                               "delta_fetched": fetched, "delta_rows_fetched": rows_fetched,
                               "host_reads": reads}
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
