"""The multi-hit march: the CUDA kernel ``csrc/multihit.cu`` and its wrapper.

Replaces the soft renderer's march (``make_multihit_tracer`` /
``trace_hits_compacted``, ``voxelhex_tpu/diff/soft.py``), an XLA program
with no Pallas source.  :func:`multihit_plain` is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, trace_params
from voxelhex_tpu_torch.render.bitgrid import make_multihit_tracer


def multihit_plain(tree, origins, dirs, max_hits, max_iters=MAX_ITERS):
    """The plain PyTorch multi-hit march over ``tree`` (see :func:`multihit`)."""
    trace = make_multihit_tracer(len(tree["bases"]), tree["size"], max_hits, max_iters,
                                 **KERNEL_CONFIG)
    return trace(tree, origins, dirs)


def multihit(tree, origins, dirs, max_hits, max_iters=MAX_ITERS):
    """The first ``max_hits`` = K occupied voxels along each ray through the
    BitGrid ``tree`` (:func:`device_bitgrid`), with the reference renderer's
    tracer settings and ``K * max_iters`` steps a ray: ``(count int32 [R],
    voxels int32 [R, K, 3], dists f32 [R, K])``, -1 and inf in empty slots.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if origins.device.type == "cpu":
        return multihit_plain(tree, origins, dirs, max_hits, max_iters)
    if origins.device.type != "cuda":
        raise ValueError(f"multihit runs on cuda or cpu tensors, not {origins.device}")
    R, K = origins.shape[0], int(max_hits)
    if K < 1:
        raise ValueError(f"max_hits {max_hits}")
    dev = origins.device
    _build.check_inputs(dev, (
        ("origins", origins, torch.float32, (R, 3)),
        ("dirs", dirs, torch.float32, (R, 3)),
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
    ))
    params = trace_params(tree, max_iters)
    lib = _build.library()
    count = torch.empty(R, dtype=torch.int32, device=dev)
    voxels = torch.empty((R, K, 3), dtype=torch.int32, device=dev)
    dists = torch.empty((R, K), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vhx_multihit(origins.data_ptr(), dirs.data_ptr(), tree["occ_pairs"].data_ptr(),
                           params, R, K, count.data_ptr(), voxels.data_ptr(), dists.data_ptr(),
                           dev.index or 0, stream)
    _build.check(err, "multihit kernel launch")
    multihit.launches += 1
    return count, voxels, dists


multihit.launches = 0
