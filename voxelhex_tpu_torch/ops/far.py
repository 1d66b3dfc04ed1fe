"""A streaming view's frame with its far field in one launch: the CUDA
kernel ``csrc/far.cu`` and its wrapper.

Replaces the reference's ``_render_far``
(``voxelhex_tpu/render/streaming.py:1479``): the window's trace, one trace
a LOD ring (from ``start_t`` ``_far_kill_hits``, ``:144``, when the camera
is inside the window), each ring's world distance (``_hit_dist``,
``:183``) and the nearest-hit composite (``_far_accum``, ``:160``).
:func:`far_frame_plain` is the plain version: the plain ray generation,
tracer and shading of each layer, and the same fold.

A layer is ``(tree, camera, factor)``: a BitGrid on the device
(:func:`~voxelhex_tpu_torch.render.bitgrid.device_bitgrid`), the camera in
the layer's frame (voxels of the layer, origin at its min corner) and the
world voxels a voxel of the layer spans (1 for the window).

The window's rays may start from a start map (the window renderer's beam
prepass, ``ops/beam.py``), one value a ``start_tile`` x ``start_tile``
pixel tile, as the reference's ``trace_compacted(..., beam=...)`` of the
window; the rings keep their own starts.

With ``skip_substeps`` every layer marches the skip tracer over its skip
rows (the reference view's ``tracer="skip"``): ``far_skip_kernel``, whose
instance takes the window's pyramid depth L and rings of L or L - 1
levels (the depths a ``FarField`` gives).
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.fp import sqrt32
from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import _pixel_steps, check_start, expand_start, frame_cam
from voxelhex_tpu_torch.ops.skip import check_skip, plain_tracer
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params
from voxelhex_tpu_torch.render.camera import device_rays
from voxelhex_tpu_torch.render.shade import shade, to_u8

# the reference's start for a ray that hit in a finer layer: past every
# ring's exit, so the ring's init deactivates it
KILL_T = 1e9


def hit_dist(hit, point, o, factor):
    """World distance of each hit, ``|point - o| * factor`` (+inf for a
    miss); the norm's sum of squares in order, unfused, as XLA:CPU computes
    the reference's."""
    x = point - o
    sq = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    d = sqrt32(sq) * torch.tensor(float(factor), dtype=torch.float32, device=o.device)
    return torch.where(hit, d, torch.full_like(d, float("inf")))


def far_frame_plain(layers, inside: bool, bg=(0.0, 0.0, 0.0), out_u8=True,
                    max_iters=MAX_ITERS, stats=None, start=None, start_tile=1,
                    skip_substeps=None):
    """The plain frame (see :func:`render_far`).  With a list ``stats``,
    each layer's march is appended to it: ``{"rays"``: the rays that start
    it, ``"iters"``: each ray's automaton steps or body iterations (int32
    [h * w]), ``"hit"``, ``"hvox"``, ``"reads"``: the word pairs the march
    fetches (bool over ``occ_pairs``), or the skip rows``}``."""
    _tree, cam0, _f = layers[0]
    w, h = cam0.resolution
    dev = layers[0][0]["occ_pairs"].device
    bgt = torch.tensor(np.asarray(bg, dtype=np.float32).reshape(3), device=dev)
    acc = None
    for i, (tree, cam, factor) in enumerate(layers):
        o, d = device_rays(cam, dev)
        trace = plain_tracer(tree, max_iters, skip_substeps)
        start_t = None
        if i == 0 and start is not None:
            start_t = expand_start(start, start_tile, w, h)
        if i > 0 and inside:
            start_t = torch.where(acc[0], torch.full_like(acc[1], KILL_T),
                                  torch.zeros_like(acc[1]))
        reads = None
        if stats is not None:
            words = tree["occ_pairs" if skip_substeps is None else "skip_rows"]
            reads = torch.zeros(words.shape[0], dtype=torch.bool, device=dev)
        st = trace.run(tree, trace.init(tree, o, d, start_t), max_iters, reads=reads)
        hit = st["hit"]
        if stats is not None:
            stats.append({"rays": o.shape[0] if i == 0 or not inside
                          else int((start_t == 0).sum()),
                          "iters": st["iters"], "hit": hit, "hvox": st["hvox"], "reads": reads})
        voxel = trace.resolve_color(tree, hit, st["hvox"])
        rgb = shade(tree["palette"], hit, voxel, st["hnormal"], bgt)
        dist = hit_dist(hit, st["point"], o, factor)
        if acc is None:
            acc = (hit, dist, rgb)
            continue
        a_hit, a_dist, a_rgb = acc
        use = hit & (~a_hit | (dist < a_dist))
        acc = (a_hit | hit, torch.where(use, dist, a_dist),
               torch.where(use[:, None], rgb, a_rgb))
    rgb = acc[2]
    return (to_u8(rgb) if out_u8 else rgb).reshape(h, w, 3)


def far_params(layers, inside: bool, bg=(0.0, 0.0, 0.0), max_iters=MAX_ITERS, skip=False):
    """The launch parameters of one frame: each layer's level table, arrays
    (with ``skip``, its skip rows as ``occ``), palette size, factor and
    camera params, and the frame's constants."""
    n = len(layers)
    if not 1 <= n <= _build.FAR_MAX_LAYERS:
        raise ValueError(f"{n} layers; the kernel takes 1..{_build.FAR_MAX_LAYERS}")
    w, h = layers[0][1].resolution
    p = _build.FarParams()
    p.cw, p.ch = _pixel_steps(w, h)
    p.bg[:] = [float(v) for v in np.asarray(bg, dtype=np.float32).reshape(3)]
    p.w, p.h = int(w), int(h)
    p.inside = int(bool(inside))
    p.n_layers = n
    for i, (tree, cam, factor) in enumerate(layers):
        if tuple(cam.resolution) != (w, h):
            raise ValueError("the layers' cameras differ in resolution")
        L = p.layers[i]
        L.trace = trace_params(tree, max_iters)
        L.occ = tree["skip_rows" if skip else "occ_pairs"].data_ptr()
        L.colors = tree["colors"].data_ptr()
        L.palette = tree["palette"].data_ptr()
        L.n_colors = int(tree["palette"].shape[0])
        L.factor = float(np.float32(factor))
        c = frame_cam(cam)
        L.origin, L.right, L.up, L.forward, L.scale = c.origin, c.right, c.up, c.forward, c.scale
    return p


def render_far(layers, inside: bool, bg=(0.0, 0.0, 0.0), out_u8=True, max_iters=MAX_ITERS,
               start=None, start_tile=1, skip_substeps=None):
    """The frame of the window and its rings: ``layers`` is the window's
    ``(tree, camera, 1)``, then each ring's ``(tree, camera, factor)``
    inside-out, cameras of one resolution; each pixel's ray runs through
    each layer (at most ``max_iters`` steps a layer) and keeps the nearest
    hit in world voxels, ``bg`` where every layer misses.  With ``inside``
    (the camera inside the window), a ring's rays start at the camera
    (``start_t`` 0) and a ray that hit already skips it.  With ``start``
    (f32 [ceil(h / start_tile), ceil(w / start_tile)]), the window's rays
    start at least their tile's value along.  ``[h, w, 3]`` u8, or f32 when
    ``out_u8`` is false.  With ``skip_substeps``, every layer marches the
    skip tracer over its ``skip_rows`` (at most ``max_iters`` body
    iterations a layer); a ring then has the window's pyramid depth or one
    level less, else the kernel refuses it (``ValueError``).

    CPU trees run the plain version; CUDA trees launch the kernel
    (``render_far.launches`` counts the stack frames,
    ``render_far.skip_launches`` the skip frames)."""
    dev = layers[0][0]["occ_pairs"].device
    if start is not None:
        w, h = layers[0][1].resolution
        check_start(start, start_tile, w, h, dev)
    if dev.type == "cpu":
        return far_frame_plain(layers, inside, bg, out_u8, max_iters, start=start,
                               start_tile=start_tile, skip_substeps=skip_substeps)
    if dev.type != "cuda":
        raise ValueError(f"render_far runs on cuda or cpu tensors, not {dev}")
    for tree, _cam, _f in layers:
        _build.check_inputs(dev, (
            ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
            ("colors", tree["colors"], torch.int16, (int(tree["size"]) ** 3,)),
            ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
        ))
        if tree["palette"].shape[0] < 1:
            raise ValueError("empty palette")
    skip = skip_substeps is not None
    if skip:
        depth = len(layers[0][0]["bases"])
        for tree, _cam, _f in layers:
            check_skip(tree, skip_substeps)
            if len(tree["bases"]) not in (depth, depth - 1):
                raise ValueError(f"a layer of {len(tree['bases'])} levels beside a window of "
                                 f"{depth}: the skip far frame takes {depth} or {depth - 1}")
    params = far_params(layers, inside, bg, max_iters, skip)
    w, h = params.w, params.h
    lib = _build.library()
    out = torch.empty((h, w, 3), dtype=torch.uint8 if out_u8 else torch.float32, device=dev)
    rgb_ptr, u8_ptr = (None, out.data_ptr()) if out_u8 else (out.data_ptr(), None)
    start_ptr = None if start is None else start.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if skip:
        err = lib.vhx_render_far_skip(params, int(skip_substeps), start_ptr, int(start_tile),
                                      rgb_ptr, u8_ptr, dev.index or 0, stream)
        _build.check(err, "skip far frame kernel launch")
        render_far.skip_launches += 1
    else:
        err = lib.vhx_render_far_start(params, start_ptr, int(start_tile), rgb_ptr, u8_ptr,
                                       dev.index or 0, stream)
        _build.check(err, "far frame kernel launch")
        render_far.launches += 1
    return out


render_far.launches = 0
render_far.skip_launches = 0
