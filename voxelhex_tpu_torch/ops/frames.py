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
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build
from voxelhex_tpu_torch.ops.frame import _pixel_steps, frame_cam, render_frame_plain
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params

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
                        prev=None):
    """The plain PyTorch version of :func:`render_frames`."""
    cameras = _check_cameras(cameras)
    frames = torch.stack([render_frame_plain(tree, c, bg, out_u8, max_iters) for c in cameras])
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


def launch_frames(entry, tree, cameras, bg, out_u8, max_iters, prev, *, device_index=0,
                  stream=None):
    """Allocate the outputs on the tree's device and call ``entry`` (the
    signature of ``vhx_render_frames``) once for each chunk of up to
    ``KMAX`` frames: ``(frames, digest int32 [K, 1 + G] or None,
    launches)``.  Chunk c > 0 compares its frame 0 with chunk c - 1's last
    frame, which the launch before it wrote on the same stream."""
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
        err = entry(
            tree["occ_pairs"].data_ptr(), tree["colors"].data_ptr(), tree["palette"].data_ptr(),
            n_colors, p, None if out_u8 else out, out if out_u8 else None, base,
            None if digest is None else digest[k0].data_ptr(), device_index, stream,
        )
        _build.check(err, "frames kernel launch")
        launches += 1
    return frames, digest, launches


def render_frames_digest(tree, cameras, bg=(0.0, 0.0, 0.0), max_iters=MAX_ITERS, prev=None):
    """:func:`render_frames` of u8 frames with the digest packed in one
    int32 tensor ``[K, 1 + G]`` (column 0 ``nrows_changed``, then
    ``rowflags``), or ``None`` without ``prev``: ``(frames, digest)``.  One
    copy reads the packed digest."""
    cameras = _check_cameras(cameras)
    dev = tree["occ_pairs"].device
    if dev.type == "cpu":
        frames, nrows, flags = render_frames_plain(tree, cameras, bg, True, max_iters, prev)
        return frames, None if prev is None else torch.cat([nrows[:, None], flags], dim=1)
    return _launch(tree, cameras, bg, True, max_iters, prev)


def _launch(tree, cameras, bg, out_u8, max_iters, prev):
    dev = tree["occ_pairs"].device
    if dev.type != "cuda":
        raise ValueError(f"render_frames runs on cuda or cpu tensors, not {dev}")
    w, h = cameras[0].resolution
    specs = [
        ("occ_pairs", tree["occ_pairs"], torch.int32, (tree["occ_pairs"].shape[0], 2)),
        ("colors", tree["colors"], torch.int16, (int(tree["size"]) ** 3,)),
        ("palette", tree["palette"], torch.float32, (tree["palette"].shape[0], 4)),
    ]
    if prev is not None:
        _check_prev(prev, (h, w, 3), out_u8)
        specs.append(("prev", prev, torch.uint8, (h, w, 3)))
    _build.check_inputs(dev, specs)
    if tree["palette"].shape[0] < 1:
        raise ValueError("empty palette")
    frames, digest, n = launch_frames(
        _build.library().vhx_render_frames, tree, cameras, bg, out_u8, max_iters, prev,
        device_index=dev.index or 0, stream=torch.cuda.current_stream(dev).cuda_stream)
    render_frames.launches += n
    return frames, digest


def render_frames(tree, cameras, bg=(0.0, 0.0, 0.0), out_u8=True, max_iters=MAX_ITERS,
                  prev=None):
    """The frames of ``cameras`` (one resolution) over the BitGrid ``tree``
    (:func:`device_bitgrid`), as :func:`render_frame` draws each:
    ``(frames [K, h, w, 3], nrows_changed, rowflags)``, u8 or f32.  With
    ``prev`` (u8 [h, w, 3], and ``out_u8``), the digests of the u8 frames
    (module docstring), frame 0's against ``prev``; without it, ``None``
    and ``None``.

    A CPU tree runs the plain version; a CUDA tree launches the kernel,
    once for each ``KMAX`` cameras."""
    cameras = _check_cameras(cameras)
    if tree["occ_pairs"].device.type == "cpu":
        return render_frames_plain(tree, cameras, bg, out_u8, max_iters, prev)
    frames, digest = _launch(tree, cameras, bg, out_u8, max_iters, prev)
    if digest is None:
        return frames, None, None
    return frames, digest[:, 0], digest[:, 1:]


render_frames.launches = 0
