"""The whole frame in one launch: the CUDA kernel ``csrc/frame.cu`` and its
wrapper.

The kernel generates each pixel's ray, traces it and shades it, from the
camera params passed by value: it fuses ray generation, the traversal kernel
(``ops/traverse.py``, replacing ``make_kernel`` / ``traverse_tiles`` of
``voxelhex_tpu/ops/traverse_pallas.py``) and the shading kernel
(``ops/shade.py``, replacing ``_shade_kernel`` / ``pallas_shade`` of
``voxelhex_tpu/ops/shade_pallas.py``).  :func:`render_frame_plain` is the
plain PyTorch version: the plain ray generation, tracer and shading in turn.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.shade import shade_plain
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params, traverse_plain
from voxelhex_tpu_torch.render.camera import Camera, camera_params, device_rays, pixel_steps


def render_frame_plain(tree, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8=True,
                       max_iters=MAX_ITERS):
    """The plain PyTorch frame (see :func:`render_frame`)."""
    w, h = camera.resolution
    o, d = device_rays(camera, tree["occ_pairs"].device)
    hit, voxel, _hvox, _point, hnormal = traverse_plain(tree, o, d, max_iters)
    return shade_plain(hit, voxel, hnormal, tree["palette"], bg, out_u8).reshape(h, w, 3)


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


def render_frame(tree, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8=True, max_iters=MAX_ITERS):
    """The frame of ``camera`` over the BitGrid ``tree``
    (:func:`device_bitgrid`) with the reference renderer's tracer settings,
    each ray for at most ``max_iters`` steps: ``[h, w, 3]`` u8, or f32 when
    ``out_u8`` is false, ``bg`` on a miss.

    A CPU tree runs the plain version; a CUDA tree launches the kernel."""
    dev = tree["occ_pairs"].device
    if dev.type == "cpu":
        return render_frame_plain(tree, camera, bg, out_u8, max_iters)
    if dev.type != "cuda":
        raise ValueError(f"render_frame runs on cuda or cpu tensors, not {dev}")
    _build.check_inputs(dev, (
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        ("colors", tree["colors"], torch.int16, (int(tree["size"]) ** 3,)),
        ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
    ))
    n_colors = tree["palette"].shape[0]
    if n_colors < 1:
        raise ValueError("empty palette")
    w, h = camera.resolution
    if w < 1 or h < 1:
        raise ValueError(f"resolution {camera.resolution}")
    params = frame_params(tree, camera, bg, max_iters)
    lib = _build.library()
    out = torch.empty((h, w, 3), dtype=torch.uint8 if out_u8 else torch.float32, device=dev)
    rgb_ptr, u8_ptr = (None, out.data_ptr()) if out_u8 else (out.data_ptr(), None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vhx_render_frame(
        tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
        n_colors, params, rgb_ptr, u8_ptr, dev.index or 0, stream,
    )
    _build.check(err, "frame kernel launch")
    render_frame.launches += 1
    return out


render_frame.launches = 0
