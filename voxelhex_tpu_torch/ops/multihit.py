"""The multi-hit march: the CUDA kernel ``csrc/multihit.cu`` and its wrapper.

Replaces the soft renderer's march (``make_multihit_tracer`` /
``trace_hits_compacted``, ``voxelhex_tpu/diff/soft.py``), an XLA program
with no Pallas source.  :func:`multihit_plain` is the plain PyTorch version.

Two more forms, each its own instance of the kernel: the start form
(``start=``: each ray starts from its beam start, the reference's
``trace_hits_compacted(..., beam=)``), and the skip form (``skip_substeps``:
the skip tracer over the grid's skip rows, with or without a start).
"""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import expand_start
from voxelhex_tpu_torch.ops.skip import check_skip
from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS, trace_params
from voxelhex_tpu_torch.render.bitgrid import make_multihit_tracer


def _start_parts(start, R):
    """``(map, tile, w)`` of a start: an f32 [R] tensor is a map of one
    value a ray (tile 1, width R); a tuple is ``(map f32 [ceil(h / tile),
    ceil(w / tile)], tile, w)`` over R = w * h rays in row order."""
    if torch.is_tensor(start):
        return start.reshape(1, -1), 1, R
    smap, tile, w = start
    tile, w = int(tile), int(w)
    if tile < 1 or w < 1 or R % w:
        raise ValueError(f"a start map of tile {tile} and width {w} for {R} rays")
    h = R // w
    shape = (-(-h // tile), -(-w // tile))
    if tuple(smap.shape) != shape:
        raise ValueError(f"start map {tuple(smap.shape)}, want {shape} for {w}x{h} rays")
    return smap, tile, w


def multihit_plain(tree, origins, dirs, max_hits, max_iters=MAX_ITERS, start=None,
                   skip_substeps=None):
    """The plain PyTorch multi-hit march over ``tree`` (see :func:`multihit`)."""
    R = origins.shape[0]
    start_t = None
    if start is not None:
        smap, tile, w = _start_parts(start, R)
        start_t = expand_start(smap, tile, w, R // w)
    if skip_substeps is not None:
        check_skip(tree, skip_substeps)
    trace = make_multihit_tracer(len(tree["bases"]), tree["size"], max_hits, max_iters,
                                 skip_substeps=skip_substeps, **KERNEL_CONFIG)
    return trace(tree, origins, dirs, start_t)


def multihit(tree, origins, dirs, max_hits, max_iters=MAX_ITERS, start=None,
             skip_substeps=None):
    """The first ``max_hits`` = K occupied voxels along each ray through the
    BitGrid ``tree`` (:func:`device_bitgrid`), with the reference renderer's
    tracer settings and ``K * max_iters`` steps a ray: ``(count int32 [R],
    voxels int32 [R, K, 3], dists f32 [R, K])``, -1 and inf in empty slots.

    ``start``: each ray starts at least its start along, and a ray whose
    start is at or past its box exit has no hits; an f32 [R] tensor, or
    ``(map, tile, w)``, a start map of one value a ``tile`` x ``tile`` tile
    of a frame of width ``w`` whose rays are the R rays in row order (the
    beam prepass's).  With ``skip_substeps`` (None: the stack automaton)
    the rays march the skip tracer over ``tree["skip_rows"]``,
    ``skip_substeps`` substeps and ``K * max_iters`` body iterations a ray.

    CPU tensors run the plain version; CUDA tensors launch the kernel:
    ``multihit.launches`` counts the stack march without a start,
    ``multihit.start_launches`` with one, ``multihit.skip_launches`` the
    skip march."""
    if origins.device.type == "cpu":
        return multihit_plain(tree, origins, dirs, max_hits, max_iters, start, skip_substeps)
    if origins.device.type != "cuda":
        raise ValueError(f"multihit runs on cuda or cpu tensors, not {origins.device}")
    R, K = origins.shape[0], int(max_hits)
    if K < 1:
        raise ValueError(f"max_hits {max_hits}")
    dev = origins.device
    specs = [("origins", origins, torch.float32, (R, 3)),
             ("dirs", dirs, torch.float32, (R, 3)),
             ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2))]
    start_ptr, tile, w = None, 1, 1
    if start is not None:
        smap, tile, w = _start_parts(start, R)
        specs.append(("start", smap, torch.float32, tuple(smap.shape)))
        start_ptr = smap.data_ptr()
    _build.check_inputs(dev, specs)
    if skip_substeps is not None:
        check_skip(tree, skip_substeps)
    params = trace_params(tree, max_iters)
    lib = _build.library()
    count = torch.empty(R, dtype=torch.int32, device=dev)
    voxels = torch.empty((R, K, 3), dtype=torch.int32, device=dev)
    dists = torch.empty((R, K), dtype=torch.float32, device=dev)
    outs = (count.data_ptr(), voxels.data_ptr(), dists.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if skip_substeps is None:
        err = lib.vhx_multihit_start(origins.data_ptr(), dirs.data_ptr(),
                                     tree["occ_pairs"].data_ptr(), params, R, K, start_ptr, tile,
                                     w, *outs)
    else:
        err = lib.vhx_multihit_skip(origins.data_ptr(), dirs.data_ptr(),
                                    tree["skip_rows"].data_ptr(), params, R, K,
                                    int(skip_substeps), start_ptr, tile, w, *outs)
    _build.check(err, "multihit kernel launch")
    if skip_substeps is not None:
        multihit.skip_launches += 1
    elif start is not None:
        multihit.start_launches += 1
    else:
        multihit.launches += 1
    return count, voxels, dists


multihit.launches = 0
multihit.start_launches = 0
multihit.skip_launches = 0
