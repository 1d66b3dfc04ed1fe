"""The differentiable renderer's albedo gather and shading, forward and
backward: the CUDA kernels of ``csrc/albedo.cu``, their wrappers and the
autograd function over them.

Replaces ``_gather_bc_flatbwd`` with ``shade_diff``
(``voxelhex_tpu/diff/render.py``), XLA programs with no Pallas source.
:func:`albedo_forward_plain` and :func:`albedo_backward_plain` are the plain
PyTorch versions.  The params are the per-voxel albedo f32 [B, d^3, 3] of
:class:`~voxelhex_tpu_torch.diff.render.DiffRenderer`; each ray comes with
its hit (bool [R]), the (brick, cell) of its hit voxel (int32 [R] each, -1
where there is none) and its hit normal (f32 [R, 3]).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build

LIGHT = (-0.5, 0.5, -0.5)  # the reference's light direction (diff/render.py)
CHUNK = 4  # the backward kernel's rays a thread (CHUNK in csrc/albedo.cu)


def lambert(normal):
    """``sum(normal * LIGHT) / 2 + 0.5`` a ray, summed in the reference's order;
    the products by +-0.5 are exact, so no fused multiply-add can change it."""
    p = normal * torch.tensor(LIGHT, dtype=torch.float32, device=normal.device)
    return ((p[:, 0] + p[:, 1]) + p[:, 2]) / 2.0 + 0.5


def _rows(brick, cell, shape):
    """The clipped flat row index ``brick * d^3 + cell`` (int64)."""
    n_bricks, d3 = shape
    return brick.clamp(0, n_bricks - 1).long() * d3 + cell.clamp(0, d3 - 1).long()


def _bg(bg):
    """``bg`` (three numbers: a tuple, an array or a tensor) as f32 values."""
    return [float(x) for x in np.asarray(torch.as_tensor(bg, dtype=torch.float32).cpu(),
                                         np.float32).reshape(3)]


def albedo_forward_plain(params, hit, brick, cell, normal, bg=(0.0, 0.0, 0.0)):
    """The plain PyTorch forward (see :func:`albedo_forward`)."""
    rows = params.reshape(-1, 3)[_rows(brick, cell, params.shape[:2])]
    rows = torch.where((hit & (brick >= 0))[:, None], rows, 0.0)
    lit = rows * lambert(normal)[:, None]
    bg = torch.tensor(_bg(bg), dtype=torch.float32, device=params.device)
    return torch.where(hit[:, None], lit, bg.expand_as(lit))


def albedo_backward_plain(grad_rgb, hit, brick, cell, normal, shape):
    """The plain PyTorch backward (see :func:`albedo_backward`): the rows
    ``dL/drgb * lambert`` added with ``index_add_``."""
    n_bricks, d3 = shape
    ok = hit & (brick >= 0)
    rows = grad_rgb[ok] * lambert(normal[ok])[:, None]
    flat = (_rows(brick[ok], cell[ok], shape)[:, None] * 3
            + torch.arange(3, device=grad_rgb.device)).reshape(-1)
    g = torch.zeros(n_bricks * d3 * 3, dtype=torch.float32, device=grad_rgb.device)
    g.index_add_(0, flat, rows.reshape(-1))
    return g.view(n_bricks, d3, 3)


def backward_adds(hit, brick, cell, shape):
    """The atomic adds that the backward kernel (``csrc/albedo.cu``) issues
    on these rays, as ``(adds, runs)``, counted from the data: a thread sums
    each run of its :data:`CHUNK` consecutive rays (the rays that hit a
    voxel with params, in order, on one row); a warp's 32 chunks merge the
    runs that cross their edges and the runs that end on one row; each
    merged run goes out as 2 atomics (an 8 B vector and a scalar).  Chunks
    start where the kernel starts them, at ``hit``'s address."""
    off = hit.data_ptr() % CHUNK
    ok = (hit & (brick >= 0)).cpu().numpy()
    ray = np.flatnonzero(ok)
    rows = _rows(brick[ok], cell[ok], shape).cpu().numpy()
    chunks = (ray + off) // CHUNK
    new = np.ones(len(ray), bool)
    new[1:] = (rows[1:] != rows[:-1]) | (chunks[1:] != chunks[:-1])
    run_row, run_chunk = rows[new], chunks[new]
    n_runs = len(run_row)
    if not n_runs:
        return 0, 0
    uc, first, count = np.unique(run_chunk, return_index=True, return_counts=True)
    last = first + count - 1
    flushes = int((count - np.minimum(count, 2)).sum())  # runs neither first nor last
    after = np.zeros(len(uc), bool)  # the chunk before, in the same warp, has a run
    after[1:] = (uc[1:] == uc[:-1] + 1) & (uc[1:] % 32 != 0)
    joins = np.zeros(len(uc), bool)
    joins[1:] = run_row[last[:-1]] == run_row[first[1:]]
    flushes += int((count >= 2).sum() - (after & joins & (count >= 2)).sum())
    flushes += len(np.unique(np.stack([uc // 32, run_row[last]], 1), axis=0))
    return 2 * flushes, n_runs


def _check(dev, hit, brick, cell, normal, extra=()):
    R = hit.shape[0]
    _build.check_inputs(dev, (
        ("hit", hit, torch.bool, (R,)),
        ("brick", brick, torch.int32, (R,)),
        ("cell", cell, torch.int32, (R,)),
        ("normal", normal, torch.float32, (R, 3)),
        *extra,
    ))
    return R


def albedo_forward(params, hit, brick, cell, normal, bg=(0.0, 0.0, 0.0)):
    """rgb f32 [R, 3]: ``bg`` where a ray missed, 0 where it hit a voxel
    with no params (``brick < 0``), else its albedo row ``params[brick,
    cell]`` (both clipped into range) times its Lambert term
    (:func:`lambert`): the reference's ``DiffRenderer.render`` after the
    trace.  ``params`` f32 [B, d^3, 3].

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    dev = params.device
    if dev.type == "cpu":
        return albedo_forward_plain(params, hit, brick, cell, normal, bg)
    if dev.type != "cuda":
        raise ValueError(f"albedo runs on cuda or cpu tensors, not {dev}")
    if params.dim() != 3 or params.shape[2] != 3:
        raise ValueError(f"params: want [B, d^3, 3], got {tuple(params.shape)}")
    n_bricks, d3 = params.shape[:2]
    R = _check(dev, hit, brick, cell, normal,
               (("params", params, torch.float32, (n_bricks, d3, 3)),))
    lib = _build.library()
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    err = lib.vhx_albedo_forward(
        params.data_ptr(), hit.data_ptr(), brick.data_ptr(), cell.data_ptr(), normal.data_ptr(),
        R, n_bricks, d3, (ctypes.c_float * 3)(*_bg(bg)),
        rgb.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "albedo forward kernel launch")
    albedo_forward.launches += 1
    return rgb


def albedo_backward(grad_rgb, hit, brick, cell, normal, shape):
    """The gradient of :func:`albedo_forward` in its params for ``grad_rgb``
    = dL/drgb f32 [R, 3]: f32 [B, d^3, 3] (``shape`` = (B, d^3)), a view of
    a flat gradient into which each ray that hit a voxel with params adds
    ``dL/drgb * lambert`` at its row.

    CPU tensors run the plain version; CUDA tensors launch the kernel (its
    C entry zeroes the gradient on the stream first), which sums each run
    of rays on one row in registers and adds the runs with f32 atomics in
    no fixed order."""
    dev = grad_rgb.device
    if dev.type == "cpu":
        return albedo_backward_plain(grad_rgb, hit, brick, cell, normal, shape)
    if dev.type != "cuda":
        raise ValueError(f"albedo runs on cuda or cpu tensors, not {dev}")
    n_bricks, d3 = (int(x) for x in shape)
    R = _check(dev, hit, brick, cell, normal,
               (("grad_rgb", grad_rgb, torch.float32, (hit.shape[0], 3)),))
    lib = _build.library()
    g = torch.empty(n_bricks * d3 * 3, dtype=torch.float32, device=dev)
    err = lib.vhx_albedo_backward(
        grad_rgb.data_ptr(), hit.data_ptr(), brick.data_ptr(), cell.data_ptr(), normal.data_ptr(),
        R, n_bricks, d3, g.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "albedo backward kernel launch")
    albedo_backward.launches += 1
    return g.view(n_bricks, d3, 3)


albedo_forward.launches = 0
albedo_backward.launches = 0


class AlbedoShade(torch.autograd.Function):
    """:func:`albedo_forward` with :func:`albedo_backward` as its gradient
    in ``params``; the hit data carry none."""

    @staticmethod
    def forward(ctx, params, hit, brick, cell, normal, bg):
        ctx.save_for_backward(hit, brick, cell, normal)
        ctx.shape = tuple(params.shape[:2])
        return albedo_forward(params, hit, brick, cell, normal, bg)

    @staticmethod
    def backward(ctx, grad_rgb):
        hit, brick, cell, normal = ctx.saved_tensors
        g = albedo_backward(grad_rgb.contiguous(), hit, brick, cell, normal, ctx.shape)
        return g, None, None, None, None, None


def shade_albedo(params, hit, brick, cell, normal, bg=(0.0, 0.0, 0.0)):
    """Differentiable :func:`albedo_forward` (gradient by
    :func:`albedo_backward`)."""
    return AlbedoShade.apply(params, hit, brick, cell, normal, bg)
