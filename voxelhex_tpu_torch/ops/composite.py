"""Transmittance compositing, forward and backward: the CUDA kernels of
``csrc/composite.cu``, their wrappers and the autograd function over them.

Replaces the soft renderer's ``composite`` and the scatter-add of its flat
gather's gradient (``voxelhex_tpu/diff/soft.py``), XLA programs with no
Pallas source.  :func:`composite_forward_plain` and
:func:`composite_backward_plain` are the plain PyTorch versions.  Params are
flat: albedo f32 [S^3 * 3] (voxel i's color at 3 i .. 3 i + 2) and logits
f32 [S^3]; ``voxels`` int32 [R, K, 3] from the multi-hit march, -1 in an
empty slot.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxelhex_tpu_torch.ops import _build

MAX_HITS = 8  # the kernels' slots per ray (composite.cu dispatches K = 1..8)


def _slots(albedo, logits, voxels, size):
    """Per slot: valid [R, K], flat voxel address [R, K] (0 where empty,
    as the reference clips -1), alpha [R, K] (0 where empty), albedo
    [R, K, 3]."""
    valid = voxels[..., 0] >= 0
    v = voxels.clamp(0, size - 1).long()
    addr = v[..., 0] + v[..., 1] * size + v[..., 2] * size * size
    a = torch.where(valid, 1.0 / (torch.exp(-logits[addr]) + 1.0), 0.0)
    c = albedo.view(-1, 3)[addr]
    return valid, addr, a, c


def composite_forward_plain(albedo, logits, voxels, size, bg=None):
    """The plain PyTorch forward (see :func:`composite_forward`)."""
    _valid, _addr, a, c = _slots(albedo, logits, voxels, size)
    K = voxels.shape[1]
    rgb = torch.zeros((voxels.shape[0], 3), dtype=torch.float32, device=albedo.device)
    T = torch.ones_like(a[:, 0])
    for k in range(K):
        w = a[:, k] * T
        term = w[:, None] * c[:, k]
        rgb = term if k == 0 else rgb + term
        T = T * ((1.0 - a[:, k]) + 1e-9)
    if bg is not None:
        rgb = rgb + T[:, None] * torch.tensor(np.asarray(bg, np.float32), device=rgb.device)
    return rgb


def composite_backward_plain(grad_rgb, albedo, logits, voxels, size, bg=None,
                             need_albedo=True, need_logits=True, count=None):
    """The plain PyTorch backward (see :func:`composite_backward`)."""
    valid, addr, a, c = _slots(albedo, logits, voxels, size)
    if count is not None:  # a ray of count 0 adds nothing
        valid = valid & (count > 0)[:, None]
    K = voxels.shape[1]
    f = (1.0 - a) + 1e-9
    Tp = [torch.ones_like(a[:, 0])]
    for k in range(1, K):
        Tp.append(Tp[-1] * f[:, k - 1])
    g = grad_rgb
    if bg is not None:
        b = np.asarray(bg, np.float32)
        Q = (g[:, 0] * float(b[0]) + g[:, 1] * float(b[1])) + g[:, 2] * float(b[2])
    else:
        Q = torch.zeros_like(a[:, 0])
    g_albedo = torch.zeros_like(albedo) if need_albedo else None
    g_logits = torch.zeros_like(logits) if need_logits else None
    for k in reversed(range(K)):
        ok = valid[:, k]
        ck = c[:, k]
        dw = (g[:, 0] * ck[:, 0] + g[:, 1] * ck[:, 1]) + g[:, 2] * ck[:, 2]
        da = Tp[k] * (dw - Q)
        Q = torch.where(ok, dw * a[:, k] + f[:, k] * Q, Q)
        idx = addr[ok, k]
        if need_logits:
            ak = a[ok, k]
            g_logits.index_add_(0, idx, da[ok] * (ak * (1.0 - ak)))
        if need_albedo:
            w = a[ok, k] * Tp[k][ok]
            flat = (idx[:, None] * 3 + torch.arange(3, device=idx.device)).reshape(-1)
            g_albedo.index_add_(0, flat, (w[:, None] * g[ok]).reshape(-1))
    return g_albedo, g_logits


def backward_adds(voxels, size, count=None, need_albedo=True, need_logits=True):
    """The atomic adds that the backward kernel (``csrc/composite.cu``)
    issues on these slots, as ``(adds, hit slots)``, counted from the data:
    for each warp (32 consecutive rays) and slot k, each distinct voxel of
    the warp's valid slots k (of rays of count > 0, with ``count``) adds
    once, 1 add into the logits and 2 into the albedo (an 8 B vector and a
    scalar)."""
    valid = voxels[..., 0] >= 0
    if count is not None:
        valid = valid & (count > 0)[:, None]
    v = voxels.clamp(0, size - 1).long()
    addr = v[..., 0] + v[..., 1] * size + v[..., 2] * size * size
    R, K = valid.shape
    warp = torch.arange(R, device=voxels.device)[:, None] // 32
    slot = torch.arange(K, device=voxels.device)[None, :]
    key = torch.stack([(warp * K + slot).expand(R, K)[valid], addr[valid]], 1)
    merged = int(torch.unique(key, dim=0).shape[0]) if key.shape[0] else 0
    per = int(bool(need_logits)) + 2 * int(bool(need_albedo))
    return per * merged, int(valid.sum())


def _check(albedo, logits, voxels, size, extra=()):
    R, K = voxels.shape[0], voxels.shape[1]
    n = int(size) ** 3
    if not 1 <= K <= MAX_HITS:
        raise ValueError(f"{K} hit slots; the kernels take 1..{MAX_HITS}")
    _build.check_inputs(albedo.device, (
        ("albedo", albedo, torch.float32, (3 * n,)),
        ("logits", logits, torch.float32, (n,)),
        ("voxels", voxels, torch.int32, (R, K, 3)),
        *extra,
    ))
    return R, K


def _bg_arg(bg):
    if bg is None:
        return None
    return (ctypes.c_float * 3)(*np.asarray(bg, np.float32).reshape(3).tolist())


def composite_forward(albedo, logits, voxels, size, bg=None):
    """Composite each ray's K recorded voxels front to back: ``rgb`` f32
    [R, 3] = sum_k a_k T_{k-1} albedo_k (+ T_{K-1} bg), a = sigmoid(logit)
    (0 in an empty slot), T_k = prod_{j <= k} ((1 - a_j) + 1e-9).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if albedo.device.type == "cpu":
        return composite_forward_plain(albedo, logits, voxels, size, bg)
    if albedo.device.type != "cuda":
        raise ValueError(f"composite runs on cuda or cpu tensors, not {albedo.device}")
    R, K = _check(albedo, logits, voxels, size)
    dev = albedo.device
    lib = _build.library()
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    err = lib.vhx_composite_forward(
        albedo.data_ptr(), logits.data_ptr(), voxels.data_ptr(), R, K, int(size), _bg_arg(bg),
        rgb.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "composite forward kernel launch")
    composite_forward.launches += 1
    return rgb


def composite_backward(grad_rgb, albedo, logits, voxels, size, bg=None, need_albedo=True,
                       need_logits=True, count=None):
    """The gradients of :func:`composite_forward` for ``grad_rgb`` = dL/drgb
    f32 [R, 3]: ``(g_albedo f32 [S^3 * 3] or None, g_logits f32 [S^3] or
    None)``, scatter-added into zeros over the hit slots (rays with no hit
    add nothing).  ``count`` (int32 [R], the march's hits a ray, optional):
    a ray of count 0 adds nothing, and the kernel does not read its slots;
    the march's counts give the same gradients as none.

    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    adds with f32 atomics in no fixed order."""
    if albedo.device.type == "cpu":
        return composite_backward_plain(grad_rgb, albedo, logits, voxels, size, bg,
                                        need_albedo, need_logits, count)
    if albedo.device.type != "cuda":
        raise ValueError(f"composite runs on cuda or cpu tensors, not {albedo.device}")
    extra = (("grad_rgb", grad_rgb, torch.float32, (voxels.shape[0], 3)),)
    if count is not None:
        extra += (("count", count, torch.int32, (voxels.shape[0],)),)
    R, K = _check(albedo, logits, voxels, size, extra)
    dev = albedo.device
    lib = _build.library()
    g_albedo = torch.zeros_like(albedo) if need_albedo else None
    g_logits = torch.zeros_like(logits) if need_logits else None
    err = lib.vhx_composite_backward(
        grad_rgb.data_ptr(), albedo.data_ptr(), logits.data_ptr(), voxels.data_ptr(),
        None if count is None else count.data_ptr(), R, K, int(size), _bg_arg(bg),
        None if g_albedo is None else g_albedo.data_ptr(),
        None if g_logits is None else g_logits.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "composite backward kernel launch")
    composite_backward.launches += 1
    return g_albedo, g_logits


composite_forward.launches = 0
composite_backward.launches = 0


class Composite(torch.autograd.Function):
    """:func:`composite_forward` with :func:`composite_backward` as its
    gradient, for albedo and logits; ``voxels`` and ``count`` carry none."""

    @staticmethod
    def forward(ctx, albedo, logits, voxels, size, bg, count=None):
        ctx.save_for_backward(albedo, logits, voxels, count)
        ctx.size, ctx.bg = size, bg
        return composite_forward(albedo, logits, voxels, size, bg)

    @staticmethod
    def backward(ctx, grad_rgb):
        albedo, logits, voxels, count = ctx.saved_tensors
        need_albedo, need_logits = ctx.needs_input_grad[:2]
        g_albedo, g_logits = composite_backward(grad_rgb.contiguous(), albedo, logits, voxels,
                                                ctx.size, ctx.bg, need_albedo, need_logits,
                                                count)
        return g_albedo, g_logits, None, None, None, None


def composite(albedo, logits, voxels, size, bg=None, count=None):
    """Differentiable :func:`composite_forward` (gradients by
    :func:`composite_backward`, which skips the rays of ``count`` 0 without
    reading their slots where the march's ``count`` is given)."""
    return Composite.apply(albedo, logits, voxels, int(size), bg, count)
