"""Shading to u8: the CUDA kernel ``csrc/shade.cu`` and its wrapper.

Replaces the TPU kernel ``_shade_kernel`` / ``pallas_shade``
(``voxelhex_tpu/ops/shade_pallas.py``) and computes the frame's ``_shade``
plus the u8 step.  :func:`shade_plain` is the plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.render.shade import shade as _shade_rgb
from voxelhex_tpu_torch.render.shade import to_u8


def shade_plain(hit, voxel, normal, palette, bg=(0.0, 0.0, 0.0), out_u8=True):
    """The plain PyTorch shading (see :func:`shade`)."""
    bgt = torch.tensor(np.asarray(bg, dtype=np.float32), device=normal.device)
    rgb = _shade_rgb(palette, hit, voxel, normal, bgt)
    return to_u8(rgb) if out_u8 else rgb


def shade(hit, voxel, normal, palette, bg=(0.0, 0.0, 0.0), out_u8=True):
    """Shade traced rays: hit bool [R], voxel int32 [R], normal f32 [R,3],
    palette f32 [P,4], bg three floats -> u8 [R,3] (or f32 [R,3] when
    ``out_u8`` is false).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if normal.device.type == "cpu":
        return shade_plain(hit, voxel, normal, palette, bg, out_u8)
    if normal.device.type != "cuda":
        raise ValueError(f"shade runs on cuda or cpu tensors, not {normal.device}")
    R = normal.shape[0]
    dev = normal.device
    for name, t, dtype, shape in (
        ("hit", hit, torch.bool, (R,)),
        ("voxel", voxel, torch.int32, (R,)),
        ("normal", normal, torch.float32, (R, 3)),
        ("palette", palette, torch.float32, (palette.shape[0], 4)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if palette.shape[0] < 1:
        raise ValueError("empty palette")
    bg0, bg1, bg2 = (float(v) for v in np.asarray(bg, dtype=np.float32))
    lib = _build.library()
    if out_u8:
        out = torch.empty((R, 3), dtype=torch.uint8, device=dev)
        rgb_ptr, u8_ptr = None, out.data_ptr()
    else:
        out = torch.empty((R, 3), dtype=torch.float32, device=dev)
        rgb_ptr, u8_ptr = out.data_ptr(), None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vhx_shade(
        hit.data_ptr(), voxel.data_ptr(), normal.data_ptr(), palette.data_ptr(),
        palette.shape[0], bg0, bg1, bg2, R, rgb_ptr, u8_ptr, dev.index or 0, stream,
    )
    _build.check(err, "shade kernel launch")
    shade.launches += 1
    return out


shade.launches = 0
