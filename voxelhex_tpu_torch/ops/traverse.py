"""BitGrid traversal: the CUDA kernel ``csrc/traverse.cu`` and its wrapper.

Replaces the TPU kernel ``make_kernel`` / ``traverse_tiles``
(``voxelhex_tpu/ops/traverse_pallas.py``) and computes the production
tracer's ``trace``.  :func:`traverse_plain` is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.render.bitgrid import make_bitgrid_tracer


# the tracer settings of the reference renderer (BitGridRenderer.__init__),
# fixed in the kernel as MAX_RESTARTS, ADVANCE_SUBSTEPS and lateral steps
KERNEL_CONFIG = dict(max_restarts=4, lateral_step=True, advance_substeps=4)
MAX_ITERS = 2048


def traverse_plain(tree, origins, dirs, max_iters=MAX_ITERS):
    """The plain PyTorch tracer over ``tree`` (see :func:`traverse`)."""
    trace = make_bitgrid_tracer(len(tree["bases"]), tree["size"], max_iters=max_iters,
                                **KERNEL_CONFIG)
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


def traverse(tree, origins, dirs, max_iters=MAX_ITERS):
    """Trace rays through the BitGrid ``tree`` (:func:`device_bitgrid`) with
    the reference renderer's settings (``KERNEL_CONFIG``), each ray for at
    most ``max_iters`` steps: ``(hit bool [R], voxel int32 [R], hvox int32
    [R,3], point f32 [R,3], hnormal f32 [R,3])``.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if origins.device.type == "cpu":
        return traverse_plain(tree, origins, dirs, max_iters)
    if origins.device.type != "cuda":
        raise ValueError(f"traverse runs on cuda or cpu tensors, not {origins.device}")
    R = origins.shape[0]
    dev = origins.device
    _build.check_inputs(dev, (
        ("origins", origins, torch.float32, (R, 3)),
        ("dirs", dirs, torch.float32, (R, 3)),
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        ("colors", tree["colors"], torch.int16, (int(tree["size"]) ** 3,)),
    ))
    params = trace_params(tree, max_iters)
    lib = _build.library()
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    voxel = torch.empty(R, dtype=torch.int32, device=dev)
    hvox = torch.empty((R, 3), dtype=torch.int32, device=dev)
    point = torch.empty((R, 3), dtype=torch.float32, device=dev)
    hnormal = torch.empty((R, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vhx_traverse(
        origins.data_ptr(), dirs.data_ptr(), tree["occ_pairs"].data_ptr(),
        tree["colors"].data_ptr(), params, R, hit.data_ptr(), voxel.data_ptr(),
        hvox.data_ptr(), point.data_ptr(), hnormal.data_ptr(), dev.index or 0, stream,
    )
    _build.check(err, "traverse kernel launch")
    traverse.launches += 1
    return hit, voxel, hvox, point, hnormal


traverse.launches = 0
