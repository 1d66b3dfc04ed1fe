"""The depth prepass: the CUDA kernels of ``csrc/prepass.cu`` and their
wrappers.

``BitGridRenderer(prepass=True, prepass_levels=k)`` traces the frame at
1 / 2^k of its resolution, then at each finer level up to 1 / 2: each
pixel's ray starts at the least depth of the 2 x 2 (edge-clamped)
neighbourhood of its coarse pixel, less 2, and its own depth is its hit
distance, 1e8 on a miss.  The full-resolution frame is the frame kernel
with the last level's start map (``ops/frame.py``, a tile of 2).  Replaces
the reference's ``_depth_start`` and the level loop of ``_render_impl``
(``voxelhex_tpu/render/bitgrid.py:1198``, ``:2857-2885``).  Unlike the beam
and splat starts these are not conservative: the frame may differ from the
plain one, by design, as the reference's does.

:func:`prepass_start` is the whole prepass, one launch of
``prepass_frame_kernel`` on the card; :func:`level_depth_plain` and
:func:`depth_start_plain`, one level and the start map, are its plain
PyTorch version.  Under ``tracer="skip"`` the levels march the skip
tracer, as the reference's do (its ``self._trace``): ``skip_substeps``,
the kernels' skip instances.  Under the renderer's automaton options
(``options``: ``ops.traverse.AutomatonOptions``) the stack levels march
them, the optioned instance of ``prepass_frame_kernel``.
"""

from __future__ import annotations

import ctypes
from dataclasses import replace

import torch

from voxelhex_tpu_torch.fp import maximum, minimum, sqrt32
from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import _pixel_steps, expand_start, frame_cam
from voxelhex_tpu_torch.ops.skip import check_skip, plain_tracer
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, kernel_options, trace_params
from voxelhex_tpu_torch.render.camera import device_rays

MISS_DEPTH = 1e8
DEPTH_MARGIN = 2.0


def level_camera(camera, level):
    """``camera`` at 1 / 2^level of its resolution (the reference's
    ``cam_i``)."""
    w, h = camera.resolution
    return replace(camera, resolution=(w // 2**level, h // 2**level))


def depth_start_plain(depth):
    """The start map of the next finer level from a level's depth [h, w]:
    ``max(min(d[y, x], d[y + 1, x], d[y, x + 1], d[y + 1, x + 1]) - 2, 0)``
    with the last row and column repeated, one value a 2 x 2 tile of the
    finer level."""
    dpad = torch.nn.functional.pad(depth[None, None], (0, 1, 0, 1), mode="replicate")[0, 0]
    dmin = minimum(minimum(dpad[:-1, :-1], dpad[1:, :-1]), minimum(dpad[:-1, 1:], dpad[1:, 1:]))
    return maximum(dmin - DEPTH_MARGIN, torch.zeros_like(dmin))


def ray_depth(hit, point, o):
    """``|point - o|`` where a ray hit, ``MISS_DEPTH`` elsewhere; the norm's
    squares summed in order and unfused, as XLA:CPU computes the
    reference's."""
    x = point - o
    d = sqrt32((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])
    return torch.where(hit, d, torch.full_like(d, MISS_DEPTH))


def level_depth_plain(tree, camera, coarser=None, max_iters=MAX_ITERS, stats=None,
                      skip_substeps=None, options=None):
    """One level of the depth prepass at ``camera``'s resolution: f32 [h,
    w] depths, each ray started from the start map of ``coarser`` (the
    level before, [h / 2, w / 2]; None for the coarsest level, which
    starts at the world's entry).  With ``skip_substeps``, the rays march
    the skip tracer over ``tree["skip_rows"]``; with ``options``, the stack
    automaton follows them.  With a dict ``stats``,
    the level's march goes into it (``"iters"``, and ``"reads"``: the word
    pairs it fetches, bool over ``occ_pairs``)."""
    w, h = camera.resolution
    dev = tree["occ_pairs"].device
    o, d = device_rays(camera, dev)
    start = None if coarser is None else expand_start(depth_start_plain(coarser), 2, w, h)
    trace = plain_tracer(tree, max_iters, skip_substeps, options)
    if skip_substeps is not None:
        st = trace.run(tree, trace.init(tree, o, d, start), max_iters)
        if stats is not None:
            stats.update(iters=st["iters"])
        return ray_depth(st["hit"], st["point"], o).reshape(h, w)
    reads = None
    if stats is not None:
        reads = torch.zeros(tree["occ_pairs"].shape[0], dtype=torch.bool, device=dev)
    st = trace.run(tree, trace.init(tree, o, d, start), max_iters, reads=reads)
    if stats is not None:
        stats.update(iters=st["iters"], reads=reads)
    return ray_depth(st["hit"], st["point"], o).reshape(h, w)


def prepass_params(tree, camera, max_iters=MAX_ITERS) -> _build.PrepassParams:
    w, h = camera.resolution
    p = _build.PrepassParams()
    p.trace = trace_params(tree, max_iters)
    p.cam = frame_cam(camera)
    p.cw, p.ch = _pixel_steps(w, h)
    p.w, p.h = int(w), int(h)
    return p


def _check(tree, dev):
    if dev.type != "cuda":
        raise ValueError(f"the depth prepass runs on cuda or cpu tensors, not {dev}")
    _build.check_inputs(dev, (("occ_pairs", tree["occ_pairs"], torch.int32,
                               (tree["occ_pairs"].shape[0], 2)),))


def prepass_start(tree, camera, levels, max_iters=MAX_ITERS, skip_substeps=None, depths=None,
                  options=None):
    """The start map of ``camera``'s full-resolution frame after ``levels``
    levels of the depth prepass (``levels`` >= 1, each level's resolution
    twice the next coarser one's): f32 [h / 2, w / 2], one value a 2 x 2
    tile.  With a list ``depths``, each level's depths are appended to it,
    the coarsest first.  With ``options``, the stack automaton follows them.

    A CPU tree runs the plain versions level by level; a CUDA tree makes
    one launch of ``prepass_frame_kernel`` for every level and the start
    map, and for more than ``PREPASS_MAX_LEVELS`` levels a chain of
    launches of at most that many levels each, the coarsest first, each
    started from the start map of the one before (:func:`prepass_chunks`;
    ``prepass_start.launches`` counts the stack launches,
    ``prepass_start.skip_launches`` the skip ones,
    ``prepass_start.option_launches`` the stack launches of the optioned
    instance)."""
    cams = [level_camera(camera, i) for i in range(1, levels + 1)]  # level 1 first
    if levels < 1 or any(fine.resolution != (2 * coarse.resolution[0], 2 * coarse.resolution[1])
                         for fine, coarse in zip(cams, cams[1:])):
        raise ValueError(f"{levels} prepass levels of a {camera.resolution} frame: each level's "
                         "resolution must be twice the next coarser one's")
    dev = tree["occ_pairs"].device
    if dev.type == "cpu":
        depth = None
        for cam in reversed(cams):
            depth = level_depth_plain(tree, cam, depth, max_iters, skip_substeps=skip_substeps,
                                      options=options)
            if depths is not None:
                depths.append(depth)
        return depth_start_plain(depth)
    _check(tree, dev)
    words = tree["occ_pairs"]
    opts = kernel_options(options)
    if skip_substeps is not None:
        check_skip(tree, skip_substeps)
        if opts is not None:
            raise ValueError("the skip tracer takes no automaton options")
        words = tree["skip_rows"]
    outs = [torch.empty((c.resolution[1], c.resolution[0]), dtype=torch.float32, device=dev)
            for c in cams]
    start = torch.empty_like(outs[0])
    lib = _build.library()
    coarse = None
    for lo, n in prepass_chunks(levels):
        chunk = cams[lo - 1: lo - 1 + n]  # its finest level first
        # the chunk's start map: the frame's for the last, else the next
        # chunk's coarsest level's
        out = start if lo == 1 else torch.empty_like(outs[lo - 1])
        params = (_build.PrepassParams * n)(*(prepass_params(tree, c, max_iters) for c in chunk))
        ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs[lo - 1: lo - 1 + n]))
        w1, h1 = chunk[0].resolution
        with _SYNC.take(dev, lib.vhx_prepass_sync_words(w1, h1, n)) as (sync, epoch):
            err = lib.vhx_prepass_ex(words.data_ptr(), params, n, int(skip_substeps or 0), opts,
                                     ptrs, out.data_ptr(),
                                     None if coarse is None else coarse.data_ptr(),
                                     sync.data_ptr(), epoch, dev.index or 0,
                                     torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "prepass kernel launch")
        if skip_substeps is None:
            prepass_start.launches += 1
            prepass_start.option_launches += opts is not None
        else:
            prepass_start.skip_launches += 1
        coarse = out
    if depths is not None:
        depths.extend(reversed(outs))
    return start


def prepass_chunks(levels, most=_build.PREPASS_MAX_LEVELS):
    """The launches of a depth prepass of ``levels`` levels on the card, the
    coarsest first: ``(finest level, levels)`` of each, at most ``most``
    levels a launch and every launch but the first full (one launch for up
    to ``most`` levels)."""
    first = levels - most * ((levels - 1) // most)
    chunks, top = [], levels
    for n in [first] + [most] * ((levels - 1) // most):
        chunks.append((top - n + 1, n))
        top -= n
    return chunks


_SYNC = _build.StreamScratch()
prepass_start.launches = 0
prepass_start.skip_launches = 0
prepass_start.option_launches = 0
