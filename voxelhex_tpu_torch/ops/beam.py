"""The beam prepass: the CUDA kernel ``csrc/beam.cu`` and its wrapper.

One conservative ray a pixel tile over a dilated coarse occupancy grid
(:func:`~voxelhex_tpu_torch.render.starts.beam_occupancy`) gives every ray
of the tile a start: the beam's hit distance less 1.5 cells, 0 where the
beam proved nothing, 1e8 where it left the world (a dead tile).  Replaces
the reference's ``_beam_body`` (``voxelhex_tpu/render/bitgrid.py:1491``).
:func:`beam_tiles_plain` is the plain PyTorch version: the plain ray
generation at the beam resolution and the plain tracer with the beam's
settings.

A beam is ``(grid, cell, camera)``: the dilated grid on the device
(:func:`~voxelhex_tpu_torch.render.bitgrid.device_bitgrid`), or None for a
camera with no beam level; its cell edge 4^L; the frame's camera.  The
starts come out one value a tile, ``[K, h / tile, w / tile]``, which is
the start map that the frame kernels read (``ops/frame.py``,
``ops/frames.py``, ``ops/far.py``).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from voxelhex_tpu_torch.fp import fma32, maximum, sqrt32
from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import _pixel_steps, frame_cam
from voxelhex_tpu_torch.ops.traverse import trace_params
from voxelhex_tpu_torch.render.bitgrid import make_bitgrid_tracer
from voxelhex_tpu_torch.render.camera import device_rays

# the reference's make_bitgrid_tracer(bgb, max_iters=128, max_restarts=4):
# its default advance_substeps is 2, not the renderer's 4
BEAM_ITERS = 128
BEAM_CONFIG = dict(max_restarts=4, lateral_step=True, advance_substeps=2)
# XLA:CPU compiles the reference's beam program with the entry point's
# multiply-add fused on z alone (the renderer's frame: on x and y)
BEAM_ENTRY_FMA = (False, False, True)
DEAD = 1e8  # the start of a tile whose beam left the world


def beam_camera(camera, tile):
    """The camera at the beam resolution, one ray a ``tile`` x ``tile``
    pixel tile (the reference's ``cam_b``)."""
    w, h = camera.resolution
    return replace(camera, resolution=(w // tile, h // tile))


def ray_length(p, o):
    """``|p - o|`` a row as XLA:CPU computes the reference's
    ``jnp.linalg.norm`` in the beam program: the squares summed in order,
    each added by a fused multiply-add."""
    x = p - o
    return sqrt32(fma32(x[:, 2], x[:, 2], fma32(x[:, 1], x[:, 1], x[:, 0] * x[:, 0])))


def beam_tiles_plain(grid, cell, camera, tile, stats=None):
    """The plain version of one camera's beams: f32 ``[h / tile, w /
    tile]``.  With a dict ``stats``, the beams' march goes into it
    (``"iters"``, ``"hit"``, ``"active"``, ``"restarts"``, and ``"reads"``:
    the word pairs it fetches, bool over ``occ_pairs``)."""
    cam_b = beam_camera(camera, tile)
    w, h = cam_b.resolution
    dev = grid["occ_pairs"].device
    o, d = device_rays(cam_b, dev)
    c = torch.tensor(float(cell), dtype=torch.float32, device=dev)
    ob = o * (1.0 / c) + 1.0  # o / cell + 1: 1 / cell is exact
    trace = make_bitgrid_tracer(len(grid["bases"]), grid["size"], max_iters=BEAM_ITERS,
                                entry_fma=BEAM_ENTRY_FMA, **BEAM_CONFIG)
    reads = None
    if stats is not None:
        reads = torch.zeros(grid["occ_pairs"].shape[0], dtype=torch.bool, device=dev)
    st = trace.run(grid, trace.init(grid, ob, d), BEAM_ITERS, reads=reads)
    if stats is not None:
        stats.update({k: st[k] for k in ("iters", "hit", "active", "restarts")}, reads=reads)
    t = ray_length(st["point"], ob) * c
    zero = torch.zeros_like(t)
    unknown = st["active"] | (st["restarts"] > BEAM_CONFIG["max_restarts"])
    s = torch.where(st["hit"], maximum(t - c * 1.5, zero),
                    torch.where(unknown, zero, torch.full_like(t, DEAD)))
    return s.reshape(h, w)


def beam_params(beams, tile) -> _build.BeamParams:
    """The launch parameters of up to ``KMAX`` beams: each distinct grid
    once, each camera's params and grid."""
    w, h = beams[0][2].resolution
    tw, th = w // tile, h // tile
    p = _build.BeamParams()
    p.cw, p.ch = _pixel_steps(tw, th)
    p.tw, p.th = tw, th
    p.n_frames = len(beams)
    slots, cams = {}, {}
    for k, (grid, cell, camera) in enumerate(beams):
        if tuple(camera.resolution) != (w, h):
            raise ValueError("the beams' cameras differ in resolution")
        if id(camera) not in cams:  # a pose repeated in the batch is looked up once
            cams[id(camera)] = frame_cam(beam_camera(camera, tile))
        p.cams[k] = cams[id(camera)]
        if grid is None:
            p.grid_of[k] = -1
            continue
        key = id(grid["occ_pairs"])
        if key not in slots:
            if len(slots) == _build.BEAM_MAX_GRIDS:
                raise ValueError(f"more than {_build.BEAM_MAX_GRIDS} beam grids in a launch")
            g = p.grids[len(slots)]
            g.trace = trace_params(grid, BEAM_ITERS)
            g.occ = grid["occ_pairs"].data_ptr()
            g.cell = float(cell)
            g.inv_cell = 1.0 / float(cell)
            slots[key] = len(slots)
        p.grid_of[k] = slots[key]
    p.n_grids = len(slots)
    return p


def beam_tiles(beams, tile, device):
    """Each camera's beam starts, f32 ``[K, h / tile, w / tile]`` on
    ``device``: ``beams`` is a list of ``(grid, cell, camera)`` (module
    docstring), the cameras of one resolution that ``tile`` divides; a
    camera whose grid is None gets 0s.

    On the CPU it runs the plain version; on the card one launch of the
    kernel a ``KMAX`` cameras."""
    dev = next((g["occ_pairs"].device for g, _c, _cam in beams if g is not None),
               torch.device(device))
    w, h = beams[0][2].resolution
    if w % tile or h % tile:
        raise ValueError(f"tile {tile} does not divide {w}x{h}")
    if dev.type == "cpu":
        return torch.stack([
            torch.zeros((h // tile, w // tile), dtype=torch.float32) if g is None
            else beam_tiles_plain(g, cell, cam, tile) for g, cell, cam in beams])
    if dev.type != "cuda":
        raise ValueError(f"beam_tiles runs on cuda or cpu tensors, not {dev}")
    for grid, _cell, _cam in beams:
        if grid is not None:
            _build.check_inputs(dev, (("occ_pairs", grid["occ_pairs"], torch.int32,
                                       (grid["occ_pairs"].shape[0], 2)),))
    out = torch.empty((len(beams), h // tile, w // tile), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k0 in range(0, len(beams), _build.KMAX):
        part = beams[k0:k0 + _build.KMAX]
        err = lib.vhx_beam(beam_params(part, tile), out[k0:k0 + len(part)].data_ptr(),
                           dev.index or 0, stream)
        _build.check(err, "beam kernel launch")
        beam_tiles.launches += 1
    return out


beam_tiles.launches = 0
