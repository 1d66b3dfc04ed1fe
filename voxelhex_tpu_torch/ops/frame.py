"""The whole frame in one launch: the CUDA kernel ``csrc/frame.cu`` and its
wrapper.

The kernel generates each pixel's ray, traces it and shades it, from the
camera params passed by value: it fuses ray generation, the traversal kernel
(``ops/traverse.py``, replacing ``make_kernel`` / ``traverse_tiles`` of
``voxelhex_tpu/ops/traverse_pallas.py``) and the shading kernel
(``ops/shade.py``, replacing ``_shade_kernel`` / ``pallas_shade`` of
``voxelhex_tpu/ops/shade_pallas.py``).  :func:`render_frame_plain` is the
plain PyTorch version: the plain ray generation, tracer and shading in turn.

With a start map (the beam, splat or depth prepass: ``ops/beam.py``,
``ops/splat.py``, ``ops/prepass.py``), each ray starts at least its pixel
tile's value along, the reference's ``start_t``: ``frame_start_kernel``,
its own instance of the same code.  With ``skip_substeps`` the rays march
the skip tracer (``ops/skip.py``) over the grid's skip rows:
``frame_skip_kernel``, with or without a start map.  Under the renderer's
automaton options (``options``: ``ops.traverse.AutomatonOptions``) or over a
u8 color grid the stack frame is ``frame_form_kernel``'s instance for them;
the skip and LOD frames have u8 instances too.

:func:`render_lod` is the reference renderer's ``render_lod``
(``voxelhex_tpu/render/bitgrid.py:1627``), distance LOD over the MIP color
grids: ``frame_lod_kernel``, beside its plain version
:func:`render_lod_plain`.  The kernel takes the stop rule as a table of
squared distances (:func:`~voxelhex_tpu_torch.render.bitgrid.lod_stop_sq`,
cached per f32 scale), and has a stopless instance for the frames in which
no ray can stop above level 0.
"""

from __future__ import annotations

import collections
import functools
import math
import threading

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.shade import shade_plain
from voxelhex_tpu_torch.ops.skip import check_skip, plain_tracer
from voxelhex_tpu_torch.ops.traverse import (
    MAX_ITERS,
    color_bytes,
    color_spec,
    count_launch,
    kernel_options,
    trace_params,
)
from voxelhex_tpu_torch.render.bitgrid import lod_stop_sq, make_bitgrid_tracer
from voxelhex_tpu_torch.render.camera import Camera, camera_params, device_rays, pixel_steps


def expand_start(start, tile, w, h):
    """A start map of one value a ``tile`` x ``tile`` pixel tile, ``[ceil(h
    / tile), ceil(w / tile)]``, as one value a pixel of a ``w`` x ``h``
    frame, flattened: the reference's ``start_t``."""
    full = start.repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    return full[:h, :w].reshape(-1)


def render_frame_plain(tree, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8=True,
                       max_iters=MAX_ITERS, start=None, start_tile=1, skip_substeps=None,
                       options=None):
    """The plain PyTorch frame (see :func:`render_frame`)."""
    w, h = camera.resolution
    o, d = device_rays(camera, tree["occ_pairs"].device)
    trace = plain_tracer(tree, max_iters, skip_substeps, options)
    st0 = None if start is None else expand_start(start, start_tile, w, h)
    st = trace.run(tree, trace.init(tree, o, d, st0), max_iters)
    voxel = trace.resolve_color(tree, st["hit"], st["hvox"])
    return shade_plain(st["hit"], voxel, st["hnormal"], tree["palette"], bg,
                       out_u8).reshape(h, w, 3)


def lod_tracer(tree, lod_scale, max_iters=MAX_ITERS):
    """The plain LOD tracer of :func:`render_lod`: the reference's
    ``make_bitgrid_tracer`` with its defaults (2 DDA substeps an ADVANCE,
    lateral steps, 4 restarts) and ``lod_scale``."""
    return make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=max_iters,
                               lod_scale=lod_scale)


def render_lod_plain(tree, camera: Camera, lod_scale, bg=(0.0, 0.0, 0.0), max_iters=MAX_ITERS):
    """The plain LOD frame (see :func:`render_lod`)."""
    w, h = camera.resolution
    o, d = device_rays(camera, tree["occ_pairs"].device)
    hit, rgb, _hv, _pt, hnormal = lod_tracer(tree, lod_scale, max_iters).trace_lod(tree, o, d)
    # sum(n * (-0.5, 0.5, -0.5)) / 2 + 0.5, the sum in order
    s = (hnormal[:, 0] * -0.5 + hnormal[:, 1] * 0.5) + hnormal[:, 2] * -0.5
    lit = rgb * (s / 2.0 + 0.5)[:, None]
    bgt = torch.tensor(np.asarray(bg, dtype=np.float32).reshape(3), device=lit.device)
    return torch.where(hit[:, None], lit, bgt.expand_as(lit)).reshape(h, w, 3)


# the camera params of recent poses, as bytes: frame_cam's cache
CAM_CACHE_SIZE = 256
_cams: collections.OrderedDict = collections.OrderedDict()
_cams_lock = threading.Lock()
_pixel_steps = functools.lru_cache(maxsize=64)(pixel_steps)


def _camera_key(camera: Camera):
    """Every field that the camera params depend on, exactly: the bytes,
    dtype and shape of origin, target, up and the field of view, and the
    resolution."""
    fields = [np.asarray(f) for f in (camera.origin, camera.target, camera.up, camera.fov_y_deg)]
    return tuple((a.dtype.str, a.shape, a.tobytes()) for a in fields) + (
        tuple(camera.resolution),)


def frame_cam(camera: Camera) -> _build.FrameCam:
    """The camera params of :func:`camera_params` as the kernels read them
    (``FrameCam``).  A repeated pose takes them from a cache of the last
    ``CAM_CACHE_SIZE`` poses, keyed on the camera's exact fields and its
    resolution, so a cached value is the bytes that a fresh computation
    gives."""
    key = _camera_key(camera)
    with _cams_lock:
        cached = _cams.get(key)
        if cached is not None:
            _cams.move_to_end(key)
    if cached is None:
        cam = _build.FrameCam()
        origin, right, up, forward, scale = camera_params(camera)
        cam.origin[:], cam.right[:], cam.up[:], cam.forward[:] = (
            [float(v) for v in a] for a in (origin, right, up, forward))
        cam.scale[:] = [float(v) for v in scale]
        cached = bytes(cam)
        with _cams_lock:
            _cams[key] = cached
            while len(_cams) > CAM_CACHE_SIZE:
                _cams.popitem(last=False)
    return _build.FrameCam.from_buffer_copy(cached)


def frame_params(tree, camera: Camera, bg=(0.0, 0.0, 0.0),
                 max_iters=MAX_ITERS) -> _build.FrameParams:
    """The launch parameters of one frame: the tree's level table, the
    camera params of :func:`frame_cam`, the folded pixel constants of the
    plain ray generation, the background and the resolution."""
    w, h = camera.resolution
    p = _build.FrameParams()
    p.trace = trace_params(tree, max_iters)
    cam = frame_cam(camera)
    p.origin, p.right, p.up, p.forward, p.scale = (
        cam.origin, cam.right, cam.up, cam.forward, cam.scale)
    p.cw, p.ch = _pixel_steps(w, h)
    p.bg[:] = [float(v) for v in np.asarray(bg, dtype=np.float32).reshape(3)]
    p.w, p.h = int(w), int(h)
    return p


def check_start(start, start_tile, w, h, dev):
    """Raise unless ``start`` is a contiguous f32 start map of one value a
    ``start_tile`` x ``start_tile`` tile of a ``w`` x ``h`` frame on
    ``dev``."""
    if start_tile < 1:
        raise ValueError(f"start_tile {start_tile}")
    shape = (-(-h // start_tile), -(-w // start_tile))
    _build.check_inputs(dev, (("start", start, torch.float32, shape),))


def render_frame(tree, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8=True, max_iters=MAX_ITERS,
                 start=None, start_tile=1, skip_substeps=None, options=None):
    """The frame of ``camera`` over the BitGrid ``tree``
    (:func:`device_bitgrid`) with the reference renderer's tracer settings,
    each ray for at most ``max_iters`` steps: ``[h, w, 3]`` u8, or f32 when
    ``out_u8`` is false, ``bg`` on a miss.  With ``start`` (f32 [ceil(h /
    start_tile), ceil(w / start_tile)] on the tree's device), each ray
    starts at least its tile's value along.  With ``skip_substeps``, the
    rays march the skip tracer over ``tree["skip_rows"]``, at most
    ``max_iters`` body iterations a ray; with ``options``
    (``ops.traverse.AutomatonOptions``), the stack automaton follows them.
    ``tree["colors"]`` is u16 (int16) or u8.

    A CPU tree runs the plain version; a CUDA tree launches the kernel
    (``render_frame.launches`` counts the stack frames,
    ``render_frame.skip_launches`` the skip frames; of the stack frames,
    ``render_frame.option_launches`` ran an optioned instance, and
    ``render_frame.u8_launches`` counts the frames of either tracer over u8
    colors)."""
    dev = tree["occ_pairs"].device
    w, h = camera.resolution
    if start is not None:
        check_start(start, start_tile, w, h, dev)
    if dev.type == "cpu":
        return render_frame_plain(tree, camera, bg, out_u8, max_iters, start, start_tile,
                                  skip_substeps, options)
    if dev.type != "cuda":
        raise ValueError(f"render_frame runs on cuda or cpu tensors, not {dev}")
    _build.check_inputs(dev, (
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        color_spec(tree),
        ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
    ))
    if skip_substeps is not None:
        check_skip(tree, skip_substeps)
        if options is not None:
            raise ValueError("the skip tracer takes no automaton options")
    n_colors = tree["palette"].shape[0]
    if n_colors < 1:
        raise ValueError("empty palette")
    if w < 1 or h < 1:
        raise ValueError(f"resolution {camera.resolution}")
    params = frame_params(tree, camera, bg, max_iters)
    lib = _build.library()
    out = torch.empty((h, w, 3), dtype=torch.uint8 if out_u8 else torch.float32, device=dev)
    rgb_ptr, u8_ptr = (None, out.data_ptr()) if out_u8 else (out.data_ptr(), None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    start_ptr = None if start is None else start.data_ptr()
    colors, palette = tree["colors"].data_ptr(), tree["palette"].data_ptr()
    opts, n_bytes = kernel_options(options), color_bytes(tree)
    skip = skip_substeps is not None
    words = tree["skip_rows"] if skip else tree["occ_pairs"]
    err = lib.vhx_render_frame_ex(
        words.data_ptr(), colors, palette, n_colors, params, opts, n_bytes,
        int(skip_substeps) if skip else 0, start_ptr, int(start_tile), rgb_ptr, u8_ptr,
        dev.index or 0, stream)
    _build.check(err, f"{'skip ' if skip else ''}frame kernel launch")
    if skip:
        render_frame.skip_launches += 1
        render_frame.u8_launches += n_bytes == 1
    else:
        count_launch(render_frame, opts, n_bytes)
    return out


render_frame.launches = 0
render_frame.skip_launches = 0
render_frame.option_launches = 0
render_frame.u8_launches = 0


@functools.lru_cache(maxsize=256)
def _stop_sq(scale_bits: int) -> tuple[float, ...]:
    """:func:`lod_stop_sq` of every level for the f32 scale of these bits:
    its bisection costs the host more than the kernel's frame."""
    scale = np.array([scale_bits], dtype=np.uint32).view(np.float32)[0]
    return lod_stop_sq(scale, _build.MAX_LEVELS - 1)


def lod_params(tree, lod_scale) -> _build.LodParams:
    """The LOD frame's parameters: ``tree``'s MIP grids ``mip_rgb_{l}`` in
    order while they last, and the stop table of ``lod_scale``
    (:func:`~voxelhex_tpu_torch.render.bitgrid.lod_stop_sq`) for the tree's
    top level, NaN past it."""
    p = _build.LodParams()
    n = 0
    while f"mip_rgb_{n}" in tree and n < _build.MAX_LEVELS:
        grid = tree[f"mip_rgb_{n}"]
        p.mip[n] = grid.data_ptr()
        p.mip_cells[n] = grid.shape[0]
        n += 1
    p.n_mip = n
    top = len(tree["bases"]) - 1
    stop = _stop_sq(int(np.array([lod_scale], dtype=np.float32).view(np.uint32)[0]))
    p.stop_sq[:] = [v if k < top else float("nan") for k, v in enumerate(stop)] + [float("nan")]
    return p


def lod_stopless(params: _build.FrameParams, lod: _build.LodParams) -> bool:
    """Whether no step of the LOD frame of ``params`` and ``lod`` can stop
    above level 0, so that ``frame_lod_kernel``'s stopless instance gives
    its frame: every entry of the stop table below the top level is NaN
    (``lod_scale`` <= 0, NaN or subnormal), or +inf, which only a squared
    distance of +inf reaches.  The stop rule decides on an occupied cell,
    which lies in the world (its edge an int), so with the camera's
    coordinates under 2^62 every such distance is finite."""
    stop = lod.stop_sq[: params.trace.n_levels - 1]
    if all(math.isnan(v) for v in stop):
        return True
    return (all(not math.isfinite(v) for v in stop)
            and all(abs(c) < 2.0**62 for c in params.origin))


def render_lod(tree, camera: Camera, lod_scale, bg=(0.0, 0.0, 0.0), max_iters=MAX_ITERS):
    """The frame of ``camera`` with distance LOD, f32 ``[h, w, 3]``: each ray
    marches the reference's ``make_bitgrid_tracer(..., lod_scale)`` (its
    default settings, at most ``max_iters`` steps) and stops on an occupied
    cell at or below the level that its distance selects; the albedo comes
    from the palette at level 0 and from the tree's MIP grid
    ``mip_rgb_{l - 1}`` at level l (:func:`~voxelhex_tpu_torch.render.
    bitgrid.build_mip_colors`), shaded by Lambert, ``bg`` on a miss.
    ``lod_scale`` 0 stops every ray at level 0.

    A CPU tree runs the plain version; a CUDA tree launches
    ``frame_lod_kernel`` (``render_lod.launches``), its stopless instance
    where no step can stop above level 0 (:func:`lod_stopless`;
    ``render_lod.stopless_launches`` counts these), its u8 instances over a
    u8 color grid (``render_lod.u8_launches``)."""
    dev = tree["occ_pairs"].device
    if dev.type == "cpu":
        return render_lod_plain(tree, camera, lod_scale, bg, max_iters)
    if dev.type != "cuda":
        raise ValueError(f"render_lod runs on cuda or cpu tensors, not {dev}")
    w, h = camera.resolution
    _build.check_inputs(dev, (
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        color_spec(tree),
        ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
    ) + tuple((f"mip_rgb_{l}", tree[f"mip_rgb_{l}"], torch.float32,
               (tree[f"mip_rgb_{l}"].shape[0], 3))
              for l in range(_build.MAX_LEVELS) if f"mip_rgb_{l}" in tree))
    n_colors = tree["palette"].shape[0]
    if n_colors < 1:
        raise ValueError("empty palette")
    if w < 1 or h < 1:
        raise ValueError(f"resolution {camera.resolution}")
    params = frame_params(tree, camera, bg, max_iters)
    lod = lod_params(tree, lod_scale)
    stopless = lod_stopless(params, lod)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    lib = _build.library()
    n_bytes = color_bytes(tree)
    err = lib.vhx_render_frame_lod_ex(
        tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
        n_colors, params, lod, n_bytes, int(not stopless), out.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "LOD frame kernel launch")
    render_lod.launches += 1
    render_lod.stopless_launches += stopless
    render_lod.u8_launches += n_bytes == 1
    return out


render_lod.launches = 0
render_lod.stopless_launches = 0
render_lod.u8_launches = 0
