"""The depth prepass: the CUDA kernels of ``csrc/prepass.cu`` and their
wrapper.

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

:func:`level_depth_plain` and :func:`depth_start_plain` are the plain
PyTorch versions of the two kernels.  Under ``tracer="skip"`` the levels
march the skip tracer, as the reference's do (its ``self._trace``):
``skip_substeps``, the skip instance of ``prepass_kernel``.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from voxelhex_tpu_torch.fp import maximum, minimum, sqrt32
from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import _pixel_steps, expand_start, frame_cam
from voxelhex_tpu_torch.ops.skip import check_skip, plain_tracer
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params
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
                      skip_substeps=None):
    """The plain version of :func:`level_depth`.  With a dict ``stats``,
    the level's march goes into it (``"iters"``, and ``"reads"``: the word
    pairs it fetches, bool over ``occ_pairs``)."""
    w, h = camera.resolution
    dev = tree["occ_pairs"].device
    o, d = device_rays(camera, dev)
    start = None if coarser is None else expand_start(depth_start_plain(coarser), 2, w, h)
    trace = plain_tracer(tree, max_iters, skip_substeps)
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


def level_depth(tree, camera, coarser=None, max_iters=MAX_ITERS, skip_substeps=None):
    """One level of the depth prepass at ``camera``'s resolution: f32 [h,
    w] depths, each ray started from the start map of ``coarser`` (the
    level before, [h / 2, w / 2]; None for the coarsest level, which
    starts at the world's entry).  With ``skip_substeps``, the rays march
    the skip tracer over ``tree["skip_rows"]``.

    A CPU tree runs the plain version; a CUDA tree launches the kernel
    (``level_depth.launches`` counts the stack levels,
    ``level_depth.skip_launches`` the skip levels)."""
    dev = tree["occ_pairs"].device
    w, h = camera.resolution
    if coarser is not None and tuple(coarser.shape) != (h // 2, w // 2):
        raise ValueError(f"coarser depth {tuple(coarser.shape)}, want {(h // 2, w // 2)}")
    if dev.type == "cpu":
        return level_depth_plain(tree, camera, coarser, max_iters, skip_substeps=skip_substeps)
    _check(tree, dev)
    if coarser is not None:
        _build.check_inputs(dev, (("coarser", coarser, torch.float32, (h // 2, w // 2)),))
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    params = prepass_params(tree, camera, max_iters)
    coarser_ptr = None if coarser is None else coarser.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if skip_substeps is None:
        err = _build.library().vhx_prepass_level(
            tree["occ_pairs"].data_ptr(), params, coarser_ptr, out.data_ptr(), dev.index or 0,
            stream)
        _build.check(err, "prepass kernel launch")
        level_depth.launches += 1
    else:
        check_skip(tree, skip_substeps)
        err = _build.library().vhx_prepass_level_skip(
            tree["skip_rows"].data_ptr(), params, int(skip_substeps), coarser_ptr,
            out.data_ptr(), dev.index or 0, stream)
        _build.check(err, "skip prepass kernel launch")
        level_depth.skip_launches += 1
    return out


def depth_start(depth):
    """The start map of the next finer level from ``depth`` [h, w]
    (:func:`depth_start_plain`): f32 [h, w], one value a 2 x 2 tile of the
    finer level.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    dev = depth.device
    if dev.type == "cpu":
        return depth_start_plain(depth)
    if dev.type != "cuda":
        raise ValueError(f"depth_start runs on cuda or cpu tensors, not {dev}")
    h, w = depth.shape
    _build.check_inputs(dev, (("depth", depth, torch.float32, (h, w)),))
    out = torch.empty_like(depth)
    err = _build.library().vhx_depth_start(depth.data_ptr(), w, h, out.data_ptr(),
                                           dev.index or 0,
                                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "depth start kernel launch")
    depth_start.launches += 1
    return out


level_depth.launches = 0
level_depth.skip_launches = 0
depth_start.launches = 0


def prepass_start(tree, camera, levels, max_iters=MAX_ITERS, skip_substeps=None):
    """The start map of ``camera``'s full-resolution frame after ``levels``
    levels of the depth prepass (``levels`` >= 1, 2^levels dividing the
    resolution): f32 [h / 2, w / 2], one value a 2 x 2 tile."""
    depth = None
    for i in range(levels, 0, -1):
        depth = level_depth(tree, level_camera(camera, i), depth, max_iters, skip_substeps)
    return depth_start(depth)
