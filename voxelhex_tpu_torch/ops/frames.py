"""K frames in one launch, with each u8 frame's row digest: the CUDA kernel
``csrc/frames.cu`` and its wrapper.

The kernel runs the frame kernel's prologue, automaton and epilogue
(``csrc/frame.cuh``) for K cameras of one resolution in one launch, as the
reference's batched program does (``_fused_batch_fn``,
``voxelhex_tpu/render/bitgrid.py:2013``), and on the u8 delta path also the
reference's row digest (``_digest``, ``bitgrid.py:2215``): which rows of
each frame differ from the frame before it.  :func:`render_frames_plain` is
the plain PyTorch version: :func:`render_frame_plain` for each camera, then
:func:`digest_plain`.

A digest is ``(nrows_changed int32 [K], rowflags int32 [K, G])`` with
G = ceil(h / 8): the number of rows of frame k with a byte that differs
from frame k - 1 (frame 0: from the baseline ``prev``), and for each group
of 8 rows a word whose bit r is set when row 8 g + r changed; a group is
flagged when its word is non-zero.  The reference's ``ndiff`` counts the
same rows, and its ``rowflags`` are these words' ``!= 0``.

A batch may start its rays from start maps, one a camera (the beam prepass
of ``ops/beam.py``): ``starts = (maps f32 [K, ceil(h / tile), ceil(w /
tile)], tile, use)``, where frame k reads map k if ``use[k]`` and marches
from its entry otherwise.  It runs ``frames_start_kernel``, its own
instance of the same code.  With ``skip_substeps`` the rays march the skip
tracer (``ops/skip.py``) over the grid's skip rows: ``frames_skip_kernel``,
with or without start maps.  Under the renderer's automaton options
(``options``: ``ops.traverse.AutomatonOptions``) or over a u8 color grid the
stack batch is ``frames_form_kernel``'s instance for them; the skip batch
has u8 instances too.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import _pixel_steps, check_start, frame_cam, render_frame_plain
from voxelhex_tpu_torch.ops.skip import check_skip
from voxelhex_tpu_torch.ops.traverse import (
    MAX_ITERS,
    color_bytes,
    color_spec,
    count_launch,
    kernel_options,
    trace_params,
)

ROW_GROUP = 8  # rows a digest flag covers


def digest_plain(frames, prev):
    """The row digest of u8 ``frames`` [K, h, w, 3] against the frame
    before each, frame 0 against ``prev`` [h, w, 3]: ``(nrows_changed int32
    [K], rowflags int32 [K, G])``, as the module docstring defines them."""
    K, h = frames.shape[0], frames.shape[1]
    before = torch.cat([prev[None], frames[:-1]])
    rows = (frames != before).reshape(K, h, -1).any(dim=2)  # [K, h]
    G = -(-h // ROW_GROUP)
    padded = torch.zeros((K, G * ROW_GROUP), dtype=torch.int32, device=frames.device)
    padded[:, :h] = rows.int()
    weights = torch.tensor([1 << r for r in range(ROW_GROUP)], dtype=torch.int32,
                           device=frames.device)
    flags = (padded.reshape(K, G, ROW_GROUP) * weights).sum(dim=2, dtype=torch.int32)
    return rows.sum(dim=1, dtype=torch.int32), flags


def render_frames_plain(tree, cameras, bg=(0.0, 0.0, 0.0), out_u8=True, max_iters=MAX_ITERS,
                        prev=None, starts=None, skip_substeps=None, options=None):
    """The plain PyTorch version of :func:`render_frames`."""
    cameras = _check_cameras(cameras)
    maps, tile, use = starts if starts is not None else (None, 1, [False] * len(cameras))
    frames = torch.stack([
        render_frame_plain(tree, c, bg, out_u8, max_iters, maps[k] if use[k] else None, tile,
                           skip_substeps, options)
        for k, c in enumerate(cameras)])
    if prev is None:
        return frames, None, None
    _check_prev(prev, frames.shape[1:], out_u8)
    return (frames, *digest_plain(frames, prev))


def _check_cameras(cameras):
    cameras = list(cameras)
    if not cameras:
        raise ValueError("no cameras")
    res = tuple(cameras[0].resolution)
    if any(tuple(c.resolution) != res for c in cameras):
        raise ValueError("the cameras of a batch share one resolution")
    w, h = res
    if w < 1 or h < 1:
        raise ValueError(f"resolution {res}")
    return cameras


def _check_prev(prev, shape, out_u8):
    if not out_u8:
        raise ValueError("the digest compares u8 frames: pass out_u8=True with prev")
    if prev.dtype != torch.uint8 or tuple(prev.shape) != tuple(shape):
        raise ValueError(f"prev: want uint8 {tuple(shape)}, got {prev.dtype} "
                         f"{tuple(prev.shape)}")


def frames_params(tree, cameras, bg=(0.0, 0.0, 0.0), max_iters=MAX_ITERS):
    """The launch parameters of ``cameras``, one ``FramesParams`` for each
    chunk of up to ``KMAX`` frames."""
    w, h = cameras[0].resolution
    base = _build.FramesParams()
    base.trace = trace_params(tree, max_iters)
    base.cw, base.ch = _pixel_steps(w, h)
    base.bg[:] = [float(v) for v in np.asarray(bg, dtype=np.float32).reshape(3)]
    base.w, base.h = int(w), int(h)
    cams = {id(c): c for c in cameras}  # a pose repeated in the batch is looked up once
    params = {i: frame_cam(c) for i, c in cams.items()}
    chunks = []
    for k0 in range(0, len(cameras), _build.KMAX):
        p = _build.FramesParams.from_buffer_copy(base)
        part = cameras[k0:k0 + _build.KMAX]
        p.n_frames = len(part)
        for k, c in enumerate(part):
            p.cams[k] = params[id(c)]
        chunks.append(p)
    return chunks


def _check_starts(starts, cameras, dev):
    maps, tile, use = starts
    w, h = cameras[0].resolution
    if len(use) != len(cameras) or maps.shape[0] != len(cameras):
        raise ValueError(f"{maps.shape[0]} start maps and {len(use)} flags for "
                         f"{len(cameras)} cameras")
    for k in range(len(cameras)):
        check_start(maps[k], tile, w, h, dev)


def launch_frames(entry, tree, cameras, bg, out_u8, max_iters, prev, *, device_index=0,
                  stream=None, starts=None, words=None):
    """Allocate the outputs on the tree's device and call ``entry`` (the
    signature of ``vhx_render_frames_start``: no start map without
    ``starts``) once for each chunk of up to ``KMAX`` frames: ``(frames,
    digest int32 [K, 1 + G] or None, launches)``.  Chunk c > 0 compares its
    frame 0 with chunk c - 1's last frame, which the launch before it wrote
    on the same stream.  ``words``: what the march reads (the skip rows),
    if not the tree's word pairs."""
    dev = tree["occ_pairs"].device
    w, h = cameras[0].resolution
    K = len(cameras)
    frames = torch.empty((K, h, w, 3), dtype=torch.uint8 if out_u8 else torch.float32,
                         device=dev)
    G = -(-h // ROW_GROUP)
    digest = None if prev is None else torch.empty((K, 1 + G), dtype=torch.int32, device=dev)
    n_colors = tree["palette"].shape[0]
    launches = 0
    for i, p in enumerate(frames_params(tree, cameras, bg, max_iters)):
        k0 = i * _build.KMAX
        out = frames[k0:k0 + p.n_frames].data_ptr()
        base = None if prev is None else (prev if k0 == 0 else frames[k0 - 1]).data_ptr()
        start, tile, mask = None, 1, 0
        if starts is not None:
            maps, tile, use = starts
            start, tile = maps[k0].data_ptr(), int(tile)
            mask = sum(1 << k for k in range(p.n_frames) if use[k0 + k])
        err = entry((tree["occ_pairs"] if words is None else words).data_ptr(),
                    tree["colors"].data_ptr(),
                    tree["palette"].data_ptr(), n_colors, p, start, tile, mask,
                    None if out_u8 else out, out if out_u8 else None, base,
                    None if digest is None else digest[k0].data_ptr(), device_index, stream)
        _build.check(err, "frames kernel launch")
        launches += 1
    return frames, digest, launches


def render_frames_digest(tree, cameras, bg=(0.0, 0.0, 0.0), max_iters=MAX_ITERS, prev=None,
                         starts=None, skip_substeps=None, options=None):
    """:func:`render_frames` of u8 frames with the digest packed in one
    int32 tensor ``[K, 1 + G]`` (column 0 ``nrows_changed``, then
    ``rowflags``), or ``None`` without ``prev``: ``(frames, digest)``.  One
    copy reads the packed digest."""
    cameras = _check_cameras(cameras)
    dev = tree["occ_pairs"].device
    if starts is not None:
        _check_starts(starts, cameras, dev)
    if dev.type == "cpu":
        frames, nrows, flags = render_frames_plain(tree, cameras, bg, True, max_iters, prev,
                                                   starts, skip_substeps, options)
        return frames, None if prev is None else torch.cat([nrows[:, None], flags], dim=1)
    return _launch(tree, cameras, bg, True, max_iters, prev, starts, skip_substeps, options)


def _launch(tree, cameras, bg, out_u8, max_iters, prev, starts, skip_substeps, options):
    dev = tree["occ_pairs"].device
    if dev.type != "cuda":
        raise ValueError(f"render_frames runs on cuda or cpu tensors, not {dev}")
    w, h = cameras[0].resolution
    specs = [
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        color_spec(tree),
        ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
    ]
    if prev is not None:
        _check_prev(prev, (h, w, 3), out_u8)
        specs.append(("prev", prev, torch.uint8, (h, w, 3)))
    _build.check_inputs(dev, specs)
    if tree["palette"].shape[0] < 1:
        raise ValueError("empty palette")
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    opts, n_bytes = kernel_options(options), color_bytes(tree)
    skip = skip_substeps is not None
    if skip:
        check_skip(tree, skip_substeps)
        if opts is not None:
            raise ValueError("the skip tracer takes no automaton options")
    substeps = int(skip_substeps) if skip else 0

    def entry(words, colors, palette, n_colors, p, *rest):
        return lib.vhx_render_frames_ex(words, colors, palette, n_colors, p, opts, n_bytes,
                                        substeps, *rest)

    frames, digest, n = launch_frames(
        entry, tree, cameras, bg, out_u8, max_iters, prev, device_index=dev.index or 0,
        stream=stream, starts=starts, words=tree["skip_rows"] if skip else None)
    if skip:
        render_frames.skip_launches += n
        render_frames.u8_launches += n if n_bytes == 1 else 0
    else:
        count_launch(render_frames, opts, n_bytes, n)
    return frames, digest


def render_frames(tree, cameras, bg=(0.0, 0.0, 0.0), out_u8=True, max_iters=MAX_ITERS,
                  prev=None, starts=None, skip_substeps=None, options=None):
    """The frames of ``cameras`` (one resolution) over the BitGrid ``tree``
    (:func:`device_bitgrid`), as :func:`render_frame` draws each:
    ``(frames [K, h, w, 3], nrows_changed, rowflags)``, u8 or f32.  With
    ``prev`` (u8 [h, w, 3], and ``out_u8``), the digests of the u8 frames
    (module docstring), frame 0's against ``prev``; without it, ``None``
    and ``None``.  With ``starts``, each frame's rays start from its start
    map (module docstring).  With ``skip_substeps``, the rays march the skip
    tracer; with ``options``, the stack automaton follows them.

    A CPU tree runs the plain version; a CUDA tree launches the kernel,
    once for each ``KMAX`` cameras (``render_frames.launches`` counts the
    stack launches, ``render_frames.skip_launches`` the skip launches;
    ``render_frames.option_launches`` the stack launches of an optioned
    instance, ``render_frames.u8_launches`` those of either tracer over u8
    colors)."""
    cameras = _check_cameras(cameras)
    dev = tree["occ_pairs"].device
    if starts is not None:
        _check_starts(starts, cameras, dev)
    if dev.type == "cpu":
        return render_frames_plain(tree, cameras, bg, out_u8, max_iters, prev, starts,
                                   skip_substeps, options)
    frames, digest = _launch(tree, cameras, bg, out_u8, max_iters, prev, starts, skip_substeps,
                             options)
    if digest is None:
        return frames, None, None
    return frames, digest[:, 0], digest[:, 1:]


render_frames.launches = 0
render_frames.skip_launches = 0
render_frames.option_launches = 0
render_frames.u8_launches = 0
