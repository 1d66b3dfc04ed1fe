"""BitGrid traversal: the CUDA kernel ``csrc/traverse.cu`` and its wrapper.

Replaces the TPU kernel ``make_kernel`` / ``traverse_tiles``
(``voxelhex_tpu/ops/traverse_pallas.py``) and computes the production
tracer's ``trace``.  :func:`traverse_plain` is the plain PyTorch version.

The reference renderer's automaton options (``lateral_step``,
``parent_skip``, ``advance_substeps``: :class:`AutomatonOptions`) other than
the defaults run the kernels' optioned instances, which read them at run
time; a u8 color grid (the reference's ``color_u8``) runs the u8 instances.
:func:`kernel_options` and :func:`color_bytes` pick them for every wrapper
of the frame paths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.render.bitgrid import make_bitgrid_tracer


# the tracer settings of the reference renderer (BitGridRenderer.__init__),
# fixed in the kernel as MAX_RESTARTS, ADVANCE_SUBSTEPS and lateral steps
KERNEL_CONFIG = dict(max_restarts=4, lateral_step=True, advance_substeps=4)
MAX_ITERS = 2048


class AutomatonOptions(NamedTuple):
    """The stack automaton's options of the reference renderer
    (``BitGridRenderer(lateral_step=, parent_skip=, advance_substeps=)``),
    the defaults its own."""

    lateral_step: bool = True
    parent_skip: bool = False
    advance_substeps: int = 4


def automaton_options(lateral_step=True, parent_skip=False, advance_substeps=4):
    """The options as the reference takes them (any truthy flag, any int
    count), or None for the defaults, which the default instances run."""
    opts = AutomatonOptions(bool(lateral_step), bool(parent_skip), int(advance_substeps))
    return None if opts == AutomatonOptions() else opts


def kernel_options(options):
    """The C struct of ``options`` (:class:`AutomatonOptions`) for the
    optioned instances, or None (a null pointer: the default instances)."""
    if options is None:
        return None
    return _build.TraceOptions(int(options.lateral_step), int(options.parent_skip),
                               int(options.advance_substeps))


def plain_options(options) -> dict:
    """``make_bitgrid_tracer``'s settings of the kernels under ``options``
    (None: the defaults, ``KERNEL_CONFIG``)."""
    return dict(max_restarts=KERNEL_CONFIG["max_restarts"],
                **(options or AutomatonOptions())._asdict())


def color_bytes(tree) -> int:
    """2 for a u16 color grid (int16 bit patterns), 1 for a u8 one
    (``device_bitgrid(..., color_u8=True)``); any other raises."""
    dtype = tree["colors"].dtype
    if dtype == torch.int16:
        return 2
    if dtype == torch.uint8:
        return 1
    raise ValueError(f"colors: want int16 (u16 indices) or uint8, got {dtype}")


def color_spec(tree):
    """``check_inputs``' entry of the tree's color grid, u16 or u8."""
    color_bytes(tree)
    return ("colors", tree["colors"], tree["colors"].dtype, (int(tree["size"]) ** 3,))


def traverse_plain(tree, origins, dirs, max_iters=MAX_ITERS, options=None):
    """The plain PyTorch tracer over ``tree`` (see :func:`traverse`)."""
    trace = make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=max_iters,
                                **plain_options(options))
    return trace(tree, origins, dirs)


def trace_params(tree, max_iters=MAX_ITERS) -> _build.TraceParams:
    """The traversal's launch parameters for ``tree``: its level table,
    world extent and block count, and ``max_iters``."""
    n_levels = len(tree["bases"])
    if not 1 <= n_levels <= _build.MAX_LEVELS:
        raise ValueError(f"{n_levels} pyramid levels; the kernel takes 1..{_build.MAX_LEVELS}")
    p = _build.TraceParams()
    p.n_levels = n_levels
    for i, (b, d) in enumerate(zip(tree["bases"], tree["dims"])):
        p.bases[i], p.dims[i] = b, d
    p.size = int(tree["size"])
    p.n_blocks = int(tree["occ_pairs"].shape[0])
    p.max_iters = int(max_iters)
    return p


def count_launch(wrapper, opts, n_bytes, n=1) -> None:
    """Add ``n`` launches to ``wrapper``'s counts: ``launches``, and
    ``option_launches`` for an optioned instance, ``u8_launches`` for one
    over u8 colors."""
    wrapper.launches += n
    wrapper.option_launches += n if opts is not None else 0
    wrapper.u8_launches += n if n_bytes == 1 else 0


def traverse(tree, origins, dirs, max_iters=MAX_ITERS, options=None):
    """Trace rays through the BitGrid ``tree`` (:func:`device_bitgrid`) with
    the reference renderer's settings (``KERNEL_CONFIG``), or under
    ``options`` (:class:`AutomatonOptions`), each ray for at most
    ``max_iters`` steps: ``(hit bool [R], voxel int32 [R], hvox int32
    [R,3], point f32 [R,3], hnormal f32 [R,3])``.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (``traverse.launches``; of those, ``traverse.option_launches`` ran an
    optioned instance and ``traverse.u8_launches`` read u8 colors)."""
    if origins.device.type == "cpu":
        return traverse_plain(tree, origins, dirs, max_iters, options)
    if origins.device.type != "cuda":
        raise ValueError(f"traverse runs on cuda or cpu tensors, not {origins.device}")
    R = origins.shape[0]
    dev = origins.device
    _build.check_inputs(dev, (
        ("origins", origins, torch.float32, (R, 3)),
        ("dirs", dirs, torch.float32, (R, 3)),
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        color_spec(tree),
    ))
    params = trace_params(tree, max_iters)
    opts, n_bytes = kernel_options(options), color_bytes(tree)
    lib = _build.library()
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    voxel = torch.empty(R, dtype=torch.int32, device=dev)
    hvox = torch.empty((R, 3), dtype=torch.int32, device=dev)
    point = torch.empty((R, 3), dtype=torch.float32, device=dev)
    hnormal = torch.empty((R, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vhx_traverse_ex(
        origins.data_ptr(), dirs.data_ptr(), tree["occ_pairs"].data_ptr(),
        tree["colors"].data_ptr(), params, opts, n_bytes, 0, R, hit.data_ptr(),
        voxel.data_ptr(), hvox.data_ptr(), point.data_ptr(), hnormal.data_ptr(), dev.index or 0,
        stream,
    )
    _build.check(err, "traverse kernel launch")
    count_launch(traverse, opts, n_bytes)
    return hit, voxel, hvox, point, hnormal


traverse.launches = 0
traverse.option_launches = 0
traverse.u8_launches = 0
