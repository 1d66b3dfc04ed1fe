"""Whole-frame renderer over the BitGrid (the reference's
``BitGridRenderer`` in ``render/bitgrid.py``, without compaction, beam
prepass or batched frames: one thread per ray already stops each ray on
its own, and the frame is the same).  A frame is one launch of the frame
kernel (:func:`voxelhex_tpu_torch.ops.frame.render_frame`)."""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.ops.frame import render_frame
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, traverse
from voxelhex_tpu_torch.render.bitgrid import BitGrid, device_bitgrid
from voxelhex_tpu_torch.render.camera import Camera

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
    """``source`` if it is the port's BitGrid; the reference's other scene
    types are not ported yet."""
    if not isinstance(source, BitGrid):
        raise TypeError(
            f"the port renders a BitGrid, not {type(source).__name__}: BoxTree and FlatTree "
            "sources are ROADMAP.md queue 1 item 4 (convert.from_jax_bitgrid takes a "
            "reference BitGrid's fields)"
        )
    return source


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
    """Renders frames of one BitGrid on one device.

    Takes the reference ``BitGridRenderer``'s keywords: ``max_iters`` is the
    kernels' step limit per ray; the options of ``RESULT_NEUTRAL`` are
    accepted at the values the kernels fix; any other value raises."""

    def __init__(self, bitgrid: BitGrid, device="cuda", max_iters: int = MAX_ITERS, **options):
        check_options(options)
        self.device = resolve_device(device)
        self.bitgrid = check_source(bitgrid)
        self.max_iters = int(max_iters)
        self.tree = device_bitgrid(bitgrid, self.device)

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
        out = render_frame(self.tree, camera, bg, out_u8, self.max_iters)
        return out if out_device else out.cpu().numpy()
