"""The skip tracer: the skip instance of ``csrc/traverse.cu`` and its
wrapper, and the choice of tracer for the frame paths.

The skip tracer (``csrc/skip.cuh``) replaces the reference's
``make_skip_tracer`` (``voxelhex_tpu/render/bitgrid.py:859``), an XLA
program with no Pallas source that runs on the device for every frame or
step that asks for it: the fused-hierarchy march over the grid's skip rows
(:func:`~voxelhex_tpu_torch.render.bitgrid.build_skip_rows`), one row fetch
a body iteration, ``substeps`` substeps between fetches.  Its plain version
is :func:`~voxelhex_tpu_torch.render.bitgrid.make_skip_tracer`.  The frame
kernels (``csrc/frame.cu``, ``csrc/frames.cu``), the depth prepass
(``csrc/prepass.cu``) and the multi-hit march (``csrc/multihit.cu``) each
have a skip instance; their wrappers take ``skip_substeps`` (None for the
stack automaton).
"""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.traverse import (
    MAX_ITERS,
    color_bytes,
    color_spec,
    plain_options,
    trace_params,
)
from voxelhex_tpu_torch.render.bitgrid import make_bitgrid_tracer, make_skip_tracer

SKIP_MAX_LEVELS = 8  # the deepest pyramid of the plain skip tracer
SKIP_KERNEL_MAX_LEVELS = 6  # VHX_SKIP_MAX_LEVELS in skip.cuh: the deepest with an instance


def plain_tracer(tree, max_iters=MAX_ITERS, skip_substeps=None, options=None):
    """The plain tracer of the frame paths over ``tree``: the stack
    automaton with the reference renderer's settings, or under ``options``
    (``ops.traverse.AutomatonOptions``), or with ``skip_substeps`` the skip
    tracer (``tree`` then holds ``skip_rows``), which has no such options."""
    if skip_substeps is None:
        return make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=max_iters,
                                   **plain_options(options))
    check_skip(tree, skip_substeps)
    return make_skip_tracer(len(tree["bases"]), tree["size"], max_iters, int(skip_substeps))


def check_skip(tree, skip_substeps) -> None:
    """Raise unless ``tree`` holds skip rows of its pyramid's shape, of at
    most ``SKIP_MAX_LEVELS`` levels (``SKIP_KERNEL_MAX_LEVELS`` for rows on
    the card, which the kernels march), and ``skip_substeps`` is at least 1."""
    if int(skip_substeps) < 1:
        raise ValueError(f"skip_substeps {skip_substeps}: the skip tracer takes 1 or more")
    rows = tree.get("skip_rows")
    if rows is None:
        raise ValueError("the skip tracer needs the grid's skip rows: "
                         "device_bitgrid(..., skip_rows=True)")
    L = len(tree["bases"])
    most = SKIP_KERNEL_MAX_LEVELS if rows.device.type == "cuda" else SKIP_MAX_LEVELS
    if L > most:
        raise ValueError(f"{L} pyramid levels; the skip tracer takes 1..{most} on {rows.device}")
    n0 = max((int(tree["size"]) + 3) // 4, 1)
    _build.check_inputs(rows.device, (("skip_rows", rows, torch.int32, (n0**3, 2 * L)),))


def trace_skip_plain(tree, origins, dirs, max_iters=MAX_ITERS, substeps=3):
    """The plain PyTorch skip tracer over ``tree`` (see :func:`trace_skip`)."""
    return plain_tracer(tree, max_iters, substeps)(tree, origins, dirs)


def trace_skip(tree, origins, dirs, max_iters=MAX_ITERS, substeps=3):
    """Trace rays through ``tree`` (:func:`device_bitgrid` with
    ``skip_rows``) with the skip tracer, ``substeps`` substeps and at most
    ``max_iters`` body iterations a ray: ``(hit bool [R], voxel int32 [R],
    hvox int32 [R,3], point f32 [R,3], hnormal f32 [R,3])``, as the
    reference renderer's ``trace`` under ``tracer="skip"``.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (``trace_skip.launches``; ``trace_skip.u8_launches`` those over u8
    colors)."""
    if origins.device.type == "cpu":
        return trace_skip_plain(tree, origins, dirs, max_iters, substeps)
    if origins.device.type != "cuda":
        raise ValueError(f"trace_skip runs on cuda or cpu tensors, not {origins.device}")
    check_skip(tree, substeps)
    R = origins.shape[0]
    dev = origins.device
    _build.check_inputs(dev, (
        ("origins", origins, torch.float32, (R, 3)),
        ("dirs", dirs, torch.float32, (R, 3)),
        ("skip_rows", tree["skip_rows"], torch.int32, tuple(tree["skip_rows"].shape)),
        color_spec(tree),
    ))
    n_bytes = color_bytes(tree)
    lib = _build.library()
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    voxel = torch.empty(R, dtype=torch.int32, device=dev)
    hvox = torch.empty((R, 3), dtype=torch.int32, device=dev)
    point = torch.empty((R, 3), dtype=torch.float32, device=dev)
    hnormal = torch.empty((R, 3), dtype=torch.float32, device=dev)
    err = lib.vhx_traverse_ex(
        origins.data_ptr(), dirs.data_ptr(), tree["skip_rows"].data_ptr(),
        tree["colors"].data_ptr(), trace_params(tree, max_iters), None, n_bytes, int(substeps),
        R, hit.data_ptr(), voxel.data_ptr(), hvox.data_ptr(), point.data_ptr(),
        hnormal.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "skip traverse kernel launch")
    trace_skip.launches += 1
    trace_skip.u8_launches += n_bytes == 1
    return hit, voxel, hvox, point, hnormal


trace_skip.launches = 0
trace_skip.u8_launches = 0
