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

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.shade import shade_plain
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params, traverse_plain
from voxelhex_tpu_torch.render.camera import Camera, camera_params, device_rays, pixel_steps


def render_frame_plain(tree, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8=True):
    """The plain PyTorch frame (see :func:`render_frame`)."""
    w, h = camera.resolution
    o, d = device_rays(camera, tree["occ_pairs"].device)
    hit, voxel, _hvox, _point, hnormal = traverse_plain(tree, o, d)
    return shade_plain(hit, voxel, hnormal, tree["palette"], bg, out_u8).reshape(h, w, 3)


def frame_params(tree, camera: Camera, bg=(0.0, 0.0, 0.0)) -> _build.FrameParams:
    """The launch parameters of one frame: the tree's level table, the
    camera params of :func:`camera_params`, the folded pixel constants of
    the plain ray generation, the background and the resolution."""
    w, h = camera.resolution
    p = _build.FrameParams()
    p.trace = trace_params(tree, MAX_ITERS)
    origin, right, up, forward, scale = camera_params(camera)
    p.origin[:], p.right[:], p.up[:], p.forward[:] = (
        [float(v) for v in a] for a in (origin, right, up, forward))
    p.scale[:] = [float(v) for v in scale]
    p.cw, p.ch = pixel_steps(w, h)
    p.bg[:] = [float(v) for v in np.asarray(bg, dtype=np.float32).reshape(3)]
    p.w, p.h = int(w), int(h)
    return p


def render_frame(tree, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8=True):
    """The frame of ``camera`` over the BitGrid ``tree``
    (:func:`device_bitgrid`) with the reference renderer's tracer settings:
    ``[h, w, 3]`` u8, or f32 when ``out_u8`` is false, ``bg`` on a miss.

    A CPU tree runs the plain version; a CUDA tree launches the kernel."""
    dev = tree["occ_pairs"].device
    if dev.type == "cpu":
        return render_frame_plain(tree, camera, bg, out_u8)
    if dev.type != "cuda":
        raise ValueError(f"render_frame runs on cuda or cpu tensors, not {dev}")
    for name, t, dtype, shape in (
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        ("colors", tree["colors"], torch.int16, (int(tree["size"]) ** 3,)),
        ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    n_colors = tree["palette"].shape[0]
    if n_colors < 1:
        raise ValueError("empty palette")
    w, h = camera.resolution
    if w < 1 or h < 1:
        raise ValueError(f"resolution {camera.resolution}")
    params = frame_params(tree, camera, bg)
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
