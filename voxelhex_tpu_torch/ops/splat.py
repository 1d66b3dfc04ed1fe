"""The splat prepass: the CUDA kernels of ``csrc/splat.cu`` and their
wrapper.

The surface voxels' centers (:func:`~voxelhex_tpu_torch.render.starts.
splat_points`) are projected into a half-resolution buffer, which keeps
the nearest center's distance a texel; each texel's start is the least of
its 5 x 5 neighbourhood, 0 where no center fell near it or where a voxel
near enough to span more than two texels may cover it (three blocker grids
of 4, 16 and 64 texels a cell, dilated by a cell, and a global block), less
a margin.  Replaces the reference's ``_splat_depth_fn``
(``voxelhex_tpu/render/bitgrid.py:1262``, with ``splat_start`` ``:1367``).
:func:`splat_tiles_plain` is the plain PyTorch version.

The starts come out one value a texel, ``[h / 2, w / 2]``: the start map
that the frame kernel reads with a tile of 2 (``ops/frame.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.fp import fma32, maximum, minimum, sqrt32
from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.render.camera import camera_params

# (texels a blocker cell, and the footprint in texels whose voxels it takes)
BLOCKERS = ((4, 2.0, 3.0), (16, 3.0, 16.0), (64, 16.0, 64.0))
NO_SPLAT = 1e8  # a texel that no center reached


def _dot3(m, v):
    """``m[:, 0] * v[0] + m[:, 1] * v[1] + m[:, 2] * v[2]`` as XLA:CPU
    compiles the reference's explicit sum."""
    return fma32(m[:, 2], v[2], fma32(m[:, 1], v[1], m[:, 0] * v[0]))


def project(pts, camera, w2, h2):
    """What the point pass computes of each center: ``(z, u, v, d, f_tex,
    sref)`` in f32, the reference's order of operations."""
    origin, right, up, forward, scale = (torch.from_numpy(a).to(pts.device)
                                         for a in camera_params(camera))
    rel = pts - origin[None, :]
    z = _dot3(rel, forward)
    x = _dot3(rel, right)
    y = _dot3(rel, up)
    eps = torch.full_like(z, 1e-6)
    zs = maximum(z, eps)
    u = (x / (zs * scale[0]) + 1.0) * 0.5 * float(w2)
    v = (1.0 - y / (zs * scale[1])) * 0.5 * float(h2)
    d = sqrt32(fma32(rel[:, 2], rel[:, 2], fma32(rel[:, 1], rel[:, 1], rel[:, 0] * rel[:, 0])))
    sx = torch.tensor(w2 / 2.0, dtype=torch.float32, device=pts.device)
    sy = torch.tensor(h2 / 2.0, dtype=torch.float32, device=pts.device)
    sref = maximum(sx / scale[0], sy / scale[1])
    f_tex = sref / zs
    return z, u, v, d, f_tex, sref


def splat_tiles_plain(pts, camera, margin=3.0):
    """The plain version of :func:`splat_tiles`."""
    w, h = camera.resolution
    w2, h2 = w // 2, h // 2
    dev = pts.device
    z, u, v, d, f_tex, sref = project(pts, camera, w2, h2)
    ui = u.clamp(0.0, w2 - 1.0).to(torch.int64)
    vi = v.clamp(0.0, h2 - 1.0).to(torch.int64)
    reliable = ((z > 0.0) & (f_tex <= 2.0) & (u >= -3.0) & (u < w2 + 3.0) & (v >= -3.0)
                & (v < h2 + 3.0))
    depth = torch.full((h2 * w2,), NO_SPLAT, dtype=torch.float32, device=dev)
    idx = (vi * w2 + ui)[reliable]
    depth.scatter_reduce_(0, idx, d[reliable], "amin")
    depth = depth.reshape(h2, w2)
    dpad = torch.nn.functional.pad(depth[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
    dmin = depth
    for dy in range(5):
        for dx in range(5):
            dmin = minimum(dmin, dpad[dy:dy + h2, dx:dx + w2])
    dmin = torch.where(dmin < 1e7, dmin, torch.zeros_like(dmin))
    for c, f_lo, f_hi in BLOCKERS:
        gw, gh = (w2 + c - 1) // c + 4, (h2 + c - 1) // c + 4
        gu = torch.floor(u / c) + 2
        gv = torch.floor(v / c) + 2
        ok = ((z > 0.0) & (f_tex > f_lo) & (f_tex <= f_hi) & (gu >= 0) & (gu < gw) & (gv >= 0)
              & (gv < gh))
        g = torch.zeros(gh * gw, dtype=torch.bool, device=dev)
        g[(gv[ok] * gw + gu[ok]).long()] = True
        gpad = torch.nn.functional.pad(g.reshape(gh, gw)[None, None].float(), (1, 1, 1, 1))[0, 0]
        gmax = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
        for dy in range(3):
            for dx in range(3):
                gmax |= gpad[dy:dy + gh, dx:dx + gw] > 0
        up_g = gmax[2:, 2:].repeat_interleave(c, 0).repeat_interleave(c, 1)[:h2, :w2]
        dmin = torch.where(up_g, torch.zeros_like(dmin), dmin)
    limit = maximum(sref / 64.0, torch.tensor(3.0, device=dev))
    if bool((((z > 0.0) & (f_tex > 64.0)) | (d < limit)).any()):
        dmin = torch.zeros_like(dmin)
    return maximum(dmin - float(np.float32(margin)), torch.zeros_like(dmin))


def splat_params(camera, n_points, margin=3.0) -> _build.SplatParams:
    w, h = camera.resolution
    p = _build.SplatParams()
    origin, right, up, forward, scale = camera_params(camera)
    p.origin[:], p.right[:], p.up[:], p.forward[:] = (
        [float(x) for x in a] for a in (origin, right, up, forward))
    p.scale[:] = [float(x) for x in scale]
    p.margin = float(np.float32(margin))
    p.w2, p.h2 = w // 2, h // 2
    p.n_points = int(n_points)
    return p


def splat_tiles(pts, camera, margin=3.0):
    """The splat starts of ``camera`` from the centers ``pts`` (f32 [N, 3]
    on the device), one value a 2 x 2 pixel tile: f32 ``[h / 2, w / 2]``
    (the reference's ``splat_start`` is this map repeated to each pixel,
    :func:`~voxelhex_tpu_torch.ops.frame.expand_start`).  The resolution
    must be even.

    On the CPU it runs the plain version; on the card two launches of
    ``splat.cu`` and nothing else: the point pass (scatter-min of each
    reliable center's distance, exact whatever the order; the blocker flags
    and the global flag), then the texel pass, over scratch that stays
    from call to call on the stream, each call's words tagged with its
    epoch."""
    w, h = camera.resolution
    if w % 2 or h % 2:
        raise ValueError(f"the splat prepass needs an even resolution, not {w}x{h}")
    dev = pts.device
    if dev.type == "cpu":
        return splat_tiles_plain(pts, camera, margin)
    if dev.type != "cuda":
        raise ValueError(f"splat_tiles runs on cuda or cpu tensors, not {dev}")
    n = pts.shape[0]
    _build.check_inputs(dev, (("pts", pts, torch.float32, (n, 3)),))
    w2, h2 = w // 2, h // 2
    lib = _build.library()
    out = torch.empty((h2, w2), dtype=torch.float32, device=dev)
    with _SCRATCH.take(dev, lib.vhx_splat_scratch_words(w2, h2)) as (scratch, epoch):
        err = lib.vhx_splat(pts.data_ptr(), splat_params(camera, n, margin), scratch.data_ptr(),
                            epoch, out.data_ptr(), dev.index or 0,
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "splat kernel launch")
    splat_tiles.launches += 1
    return out


_SCRATCH = _build.StreamScratch()
splat_tiles.launches = 0
