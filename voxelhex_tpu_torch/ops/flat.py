"""The flat-tree tracers on the card: ``csrc/flat.cu`` and its wrappers.

The reference's flat-tree renderers trace with XLA programs, not Pallas
kernels: the vmapped per-ray automaton of ``render/jax_renderer.py``
(``_make_trace_ray``), the lock-step wavefront of ``render/wavefront.py``
(``make_wavefront_tracer``) and the gather-minimal form of
``render/fast.py`` (``make_fast_tracer``).  Each becomes a kernel of one
thread a ray with its state in registers, since a ray's automaton run as
PyTorch ops would be an op launch per step per state field:

* :func:`trace_vmap` -> ``flat_vmap_kernel``;
* :func:`trace_wavefront` -> ``flat_wavefront_kernel``;
* :func:`trace_fast` -> ``flat_fast_kernel`` in its bitmap-brick form
  (``brick_dim <= 4``) or its voxel-read form, from the entry point, from
  a start a ray or from a half-res depth map (the prepassed frame), or
  writing a depth a ray (the prepass).

The batched kernels' warps take 32 rays of a row, or with the private
keyword ``_width`` (the renderers' frames: the rays are a frame that wide,
in row order) each a 4 x 8 pixel tile of the frame.  Where the world's
edge and ``brick_dim`` are powers of two (:func:`flat_params`' ``pow2``)
they divide by edges as products by exact inverses: the same values.

A wrapper runs the plain PyTorch version (:mod:`voxelhex_tpu_torch.render.
jax_renderer`, :mod:`~voxelhex_tpu_torch.render.wavefront`,
:mod:`~voxelhex_tpu_torch.render.fast`) for CPU tensors and launches the
kernel for CUDA tensors, or raises; each counts its launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.render.fast import (
    ENTRY_FMA,
    PREPASS_ENTRY_FMA,
    make_fast_tracer,
    prepass_depth,
    start_from_depth,
)
from voxelhex_tpu_torch.render.jax_renderer import make_trace_ray
from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer

# the scalar tracer's passes from the root (max_outer), the batched
# tracers' restarts (max_restarts): the reference renderers' 8 each
MAX_RESTARTS = 8
BRICK_SUBSTEPS = 4  # the fast tracer's bitmap cells a body
ADVANCE_SUBSTEPS = 2  # the fast tracer's ADVANCE substeps


def is_pow2(x) -> bool:
    """Whether ``x`` (as f32) is a power of two from 1 to 2^30: the inverse
    of each edge of a world that size (its quarters, 63 levels down) is a
    normal f32, which the kernels take from its exponent bits."""
    m, e = math.frexp(float(np.float32(x)))
    return m == 0.5 and 1 <= e <= 31


def flat_params(tree, brick_dim, limit, start=None, start_w=0, half=(0, 0), frame=(0, 0)):
    """The kernels' ``FlatParams`` for ``tree`` (:func:`~voxelhex_tpu_torch.
    render.jax_renderer.device_tree` or :func:`~voxelhex_tpu_torch.render.
    fast.pack_device_tree`) at ``brick_dim``: ``limit`` is ``max_inner``
    or ``max_iters``; ``start`` a start a ray [R] or, with ``half``, the
    half-res depth map [h2 * w2] of a frame ``start_w`` wide; ``frame``
    the ``(width, height)`` of the rays' frame, whose 4 x 8 tiles the
    batched kernels' warps take, or ``(0, 0)`` for row order."""
    p = _build.FlatParams()
    t = p.tree
    empty = tree["node_children"]  # any valid pointer for arrays a tree lacks
    t.node_meta = tree.get("node_meta", empty).data_ptr()
    t.node_children = tree["node_children"].data_ptr()
    t.node_ocbits = tree["node_ocbits"].data_ptr()
    t.bricks = tree["bricks"].data_ptr()
    t.brick_ocbits = tree.get("brick_ocbits", empty).data_ptr()
    t.start = start.data_ptr() if start is not None else None
    t.n_bricks = tree["bricks"].shape[0]
    t.brick_dim = int(brick_dim)
    t.size = float(tree["size"])
    t.root_meta = int(tree.get("root_meta", 0))
    t.limit = int(limit)
    t.max_restarts = MAX_RESTARTS
    t.start_w, t.half_h, t.half_w = int(start_w), int(half[0]), int(half[1])
    p.pow2 = int(is_pow2(t.size) and is_pow2(brick_dim))
    p.tile_w, p.tile_h = int(frame[0]), int(frame[1])
    return p


def _check_tree(tree, dev, brick_dim, packed):
    n = tree["node_children"].shape[0]
    b = tree["bricks"].shape[0]
    specs = [("node_children", tree["node_children"], torch.int32, (n, 64)),
             ("node_ocbits", tree["node_ocbits"], torch.int32, (n, 2)),
             ("bricks", tree["bricks"], torch.int32, (b, brick_dim ** 3))]
    if packed:
        specs.append(("brick_ocbits", tree["brick_ocbits"], torch.int32, (b, 2)))
    else:
        specs.append(("node_meta", tree["node_meta"], torch.int32, (n,)))
    _build.check_inputs(dev, specs)
    if b < 1:
        raise ValueError("a flat tree on the card needs a brick row (pad it)")


def _outputs(R, dev):
    return (torch.empty(R, dtype=torch.bool, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty((R, 3), dtype=torch.float32, device=dev),
            torch.empty((R, 3), dtype=torch.float32, device=dev))


def _rays(o, d):
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the flat tracers run on cuda or cpu tensors, not {o.device}")
    R = o.shape[0]
    _build.check_inputs(o.device, (("origins", o, torch.float32, (R, 3)),
                                   ("directions", d, torch.float32, (R, 3))))
    return R


def _frame(R, width):
    """``(width, height)`` of a frame of ``R`` rays ``width`` wide, or (0,
    0) for rays in row order (``width`` None)."""
    if width is None:
        return 0, 0
    width = int(width)
    if width < 1 or R % width:
        raise ValueError(f"_width={width}: {R} rays are no frame that wide")
    return width, R // width


def _launch(name, params, o, d, outs, extra=()):
    R = o.shape[0]
    dev = o.device
    err = getattr(_build.library(), name)(
        ctypes.byref(params), o.data_ptr(), d.data_ptr(), R,
        *(t.data_ptr() for t in outs), *extra, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"{name} launch")


def trace_vmap(tree, brick_dim, o, d, max_inner=2048):
    """The scalar tracer's ``(hit, voxel, brick, cell, point, normal)`` of
    rays ``o``, ``d`` (f32 [R, 3]) over ``tree`` (``device_tree``);
    ``point`` is the hit point."""
    R = _rays(o, d)
    if o.device.type == "cpu":
        return make_trace_ray(brick_dim, MAX_RESTARTS, max_inner)(tree, o, d)
    _check_tree(tree, o.device, brick_dim, packed=False)
    outs = _outputs(R, o.device)
    if R:
        _launch("vhx_flat_vmap", flat_params(tree, brick_dim, max_inner), o, d, outs)
        trace_vmap.launches += 1
    return outs


trace_vmap.launches = 0


def trace_wavefront(tree, brick_dim, o, d, max_iters=4096, *, _width=None):
    """The wavefront tracer's ``(hit, voxel, brick, cell, point, normal)``
    of rays ``o``, ``d`` over ``tree`` (``device_tree``); ``point`` is
    where each ray's march ended.  ``_width``: the rays are a frame that
    wide in row order (the module's note)."""
    R = _rays(o, d)
    frame = _frame(R, _width)
    if o.device.type == "cpu":
        return make_wavefront_tracer(brick_dim, max_iters, MAX_RESTARTS)(tree, o, d)
    _check_tree(tree, o.device, brick_dim, packed=False)
    outs = _outputs(R, o.device)
    if R:
        _launch("vhx_flat_wavefront", flat_params(tree, brick_dim, max_iters, frame=frame), o,
                d, outs)
        trace_wavefront.launches += 1
    return outs


trace_wavefront.launches = 0


def trace_fast(tree, brick_dim, o, d, max_iters=4096, start_t=None, depth=False,
               start_depth=None, *, _width=None):
    """The fast tracer over ``tree`` (``pack_device_tree``): ``(hit,
    voxel, brick, cell, point, normal)`` of rays ``o``, ``d``, each from
    ``start_t`` [R] or from the start of its pixel in ``start_depth =
    (depth [h2 * w2], h2, w2)``, the half-res depths of a frame of 2 * h2
    rows of 2 * w2 rays (not both); or with ``depth`` only each ray's
    depth [R] (the prepass: ``norm(point - o)`` on a hit, else 0).
    ``_width``: the rays are a frame that wide in row order (the module's
    note)."""
    R = _rays(o, d)
    dev = o.device
    frame = _frame(R, _width)
    if start_t is not None and start_depth is not None:
        raise ValueError("trace_fast takes start_t or start_depth, not both")
    if start_depth is not None:
        dmap, h2, w2 = start_depth
        if R != 4 * h2 * w2 or tuple(dmap.shape) != (h2 * w2,):
            raise ValueError(f"start_depth: a {h2} x {w2} map for {R} rays")
    if dev.type == "cpu":
        trace = make_fast_tracer(brick_dim, max_iters, MAX_RESTARTS, BRICK_SUBSTEPS,
                                 ADVANCE_SUBSTEPS,
                                 PREPASS_ENTRY_FMA if start_depth is not None else ENTRY_FMA)
        if start_depth is not None:
            start_t = start_from_depth(*start_depth)
        out = trace(tree, o, d, start_t)
        return prepass_depth(out[0], out[4], o) if depth else out
    _check_tree(tree, dev, brick_dim, packed=True)
    start, start_w, half = None, 0, (0, 0)
    if start_t is not None:
        _build.check_inputs(dev, (("start_t", start_t, torch.float32, (R,)),))
        start = start_t
    elif start_depth is not None:
        _build.check_inputs(dev, (("start_depth", dmap, torch.float32, (h2 * w2,)),))
        start, start_w, half = dmap, 2 * w2, (h2, w2)
    params = flat_params(tree, brick_dim, max_iters, start, start_w, half, frame)
    if depth:
        out = torch.empty(R, dtype=torch.float32, device=dev)
        outs = (out,)
        name = "vhx_flat_fast_depth"
    else:
        outs = _outputs(R, dev)
        name = "vhx_flat_fast"
    if R:
        _launch(name, params, o, d, outs)
        trace_fast.launches += 1
    return outs[0] if depth else outs


trace_fast.launches = 0


__all__ = ["trace_vmap", "trace_wavefront", "trace_fast"]
