"""Whole-frame renderer over the BitGrid (the reference's
``BitGridRenderer`` in ``render/bitgrid.py``, without compaction, beam
prepass or batched frames: one thread per ray already stops each ray on
its own, and the frame is the same).  A frame is one launch of the frame
kernel (:func:`voxelhex_tpu_torch.ops.frame.render_frame`)."""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.ops.frame import render_frame
from voxelhex_tpu_torch.ops.traverse import traverse
from voxelhex_tpu_torch.render.bitgrid import BitGrid, device_bitgrid
from voxelhex_tpu_torch.render.camera import Camera


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


class BitGridRenderer:
    """Renders frames of one BitGrid on one device."""

    def __init__(self, bitgrid: BitGrid, device="cuda"):
        self.device = resolve_device(device)
        self.bitgrid = bitgrid
        self.tree = device_bitgrid(bitgrid, self.device)

    def trace(self, origins, dirs):
        """``(hit, voxel, hvox, point, hnormal)`` for f32 [R, 3] rays on the
        renderer's device, with the reference renderer's tracer settings."""
        return traverse(self.tree, origins, dirs)

    def render(self, camera: Camera, bg=(0.0, 0.0, 0.0), out_u8: bool = True):
        """A ``[h, w, 3]`` frame on the renderer's device: u8, or f32 when
        ``out_u8`` is false.  On the card it is one launch of the frame
        kernel, from the camera params to the pixels."""
        return render_frame(self.tree, camera, bg, out_u8)
