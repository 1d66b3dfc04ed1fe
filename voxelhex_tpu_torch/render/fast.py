"""The fast flat-tree tracer and its renderer, with the half-res prepass.

The port's counterpart of the reference's ``render/fast.py``: the
wavefront automaton (:mod:`voxelhex_tpu_torch.render.wavefront`) with
child meta packed into the node entries (bits 28/29), the node stack of
packed entries, bitmap bricks for ``brick_dim <= 4`` (a brick's occupancy
word pair is its voxel mask: up to 4 cells a body on register bits), the
voxel read once after the march, and an ADVANCE of 2 substeps a body.
:class:`FastRenderer` can start full-res rays from a half-res depth
prepass: the 2x2 minimum of the half-res depths, less 2.0.

On the card a ray is one thread of ``flat_fast_kernel`` (``csrc/flat.cu``,
through :func:`voxelhex_tpu_torch.ops.flat.trace_fast`);
:func:`make_fast_tracer` here is its plain PyTorch version, bit-equal to
the reference on XLA:CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.render.wavefront import (
    ENTRY_FMA,
    META_SHIFT,
    LockstepConfig,
    lockstep_init,
    lockstep_run,
)
from voxelhex_tpu_torch.tree.flat import FlatTree

# The prepassed frame's program computes the full-res march's entry point
# in a scalar loop, which XLA:CPU fuses on all three axes (the trace's,
# from the entry or from start_t, on render.wavefront.ENTRY_FMA's)
PREPASS_ENTRY_FMA = (True, True, True)


def pack_device_tree(flat: FlatTree, device="cuda") -> dict:
    """The tree's arrays as tensors on ``device``, each internal node's
    child entries carrying the child's meta in bits 28/29 (int32 bit
    patterns for the u32 words); ``size`` a float and ``root_meta`` an int.
    A tree with no parted brick is padded to one empty brick."""
    if flat.bricks.shape[0] == 0:
        flat = flat.with_padding(node_multiple=1, brick_multiple=1)
    if flat.brick_ocbits is None:
        raise ValueError("flat snapshot missing brick_ocbits")
    children = flat.node_children.astype(np.int64)
    meta = flat.node_meta.astype(np.int64)
    n = children.shape[0]
    internal = ((meta & 1) == 0)[:, None] & (children >= 0)
    child_meta = meta[np.clip(children, 0, n - 1)]
    children = np.where(internal, children | (child_meta << META_SHIFT), children)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(device)

    return {
        "node_children": t(children.astype(np.int32), np.int32),
        "node_ocbits": t(flat.node_ocbits.astype(np.uint32), np.int32),
        "bricks": t(flat.bricks.astype(np.int32), np.int32),
        "brick_ocbits": t(flat.brick_ocbits.astype(np.uint32), np.int32),
        "palette": t(flat.palette.astype(np.float32), np.float32),
        "size": float(np.float32(flat.size)),
        "root_meta": int(flat.node_meta[0]),
    }


def make_fast_tracer(brick_dim: int, max_iters: int = 4096, max_restarts: int = 8,
                     brick_substeps: int = 4, advance_substeps: int = 2, entry_fma=ENTRY_FMA):
    """The plain tracer of the reference's ``make_fast_tracer``: ``trace(tree,
    o, dirv, start_t=None) -> (hit, voxel, brick, cell, point, normal)``
    over ``[R]`` rays on the tensors of :func:`pack_device_tree`; ``point``
    is where each ray's march ended.  ``start_t`` [R]: each ray starts at
    least that far along, clipped to just inside its exit; ``record``: as
    :func:`~voxelhex_tpu_torch.render.wavefront.lockstep_run`'s.
    ``entry_fma``: the axes on which the entry point is fused
    (:data:`PREPASS_ENTRY_FMA` for the prepassed frame's full-res march)."""
    d = int(brick_dim)
    cfg = LockstepConfig(d, max_iters, max_restarts, packed=True, bitmap=d <= 4,
                         brick_substeps=brick_substeps, advance_substeps=advance_substeps,
                         entry_fma=entry_fma)

    def trace(tree, o, dirv, start_t=None, record=None):
        st = lockstep_run(tree, lockstep_init(tree, o, dirv, cfg, start_t), cfg, record)
        return finish(tree, st, d)

    trace.config = cfg
    return trace


def finish(tree, st, d):
    """The six outputs of a fast march's state: the voxel of a parted hit
    read now from its brick and cell, a solid hit's from its entry."""
    rows = tree["bricks"]
    hit, hbrick, hcell = st["hit"], st["hbrick"], st["hcell"]
    bvox = rows[hbrick.clamp(0, rows.shape[0] - 1).long(), hcell.clamp(0, d * d * d - 1).long()]
    voxel = torch.where(hit & (hbrick >= 0), bvox, st["voxel"])
    return hit, voxel, hbrick, hcell, st["point"], st["hnormal"]


def prepass_depth(hit, point, origins):
    """The half-res depth of each ray: ``norm(point - origin)``, 0 on a
    miss; its sum of squares added in the reference's order, not fused
    (XLA:CPU squares the three axes as one vector, then adds)."""
    from voxelhex_tpu_torch.fp import sqrt32

    x = point - origins
    sq = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    return torch.where(hit, sqrt32(sq), torch.zeros_like(sq))


def start_from_depth(depth, h2, w2):
    """The full-res start of each pixel from the half-res depths [h2 * w2]:
    the minimum over the edge-padded 2x2 neighbourhood of its half-res
    pixel, less 2.0, at least 0; [4 * h2 * w2] in row order."""
    from voxelhex_tpu_torch.fp import maximum, minimum

    dm = depth.reshape(h2, w2)
    dpad = torch.cat([dm, dm[-1:]], dim=0)
    dpad = torch.cat([dpad, dpad[:, -1:]], dim=1)
    dmin = minimum(minimum(dpad[:-1, :-1], dpad[1:, :-1]), minimum(dpad[:-1, 1:], dpad[1:, 1:]))
    start = dmin.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1).reshape(-1)
    return maximum(start - np.float32(2.0), torch.zeros_like(start))


class FastRenderer:
    """Whole-frame renderer over the fast tracer, a ray a thread of
    ``flat_fast_kernel`` (the reference's ``FastRenderer``), with the
    optional half-res depth prepass.  ``device="cpu"`` runs the plain
    version; without a card the default raises."""

    def __init__(self, flat: FlatTree, max_iters: int = 4096, prepass: bool = False,
                 device="cuda"):
        from voxelhex_tpu_torch.render.renderer import resolve_device

        self.flat = flat
        self.device = resolve_device(device)
        self.tree = pack_device_tree(flat, self.device)
        self.brick_dim = flat.brick_dim
        self.prepass = prepass
        self.max_iters = int(max_iters)

    def trace(self, origins, directions, start_t=None):
        """Raw per-ray results: ``(hit [R], voxel [R], brick [R], cell [R],
        point [R, 3], normal [R, 3])`` on the renderer's device; ``point``
        is where the march ended."""
        from voxelhex_tpu_torch.ops.flat import trace_fast
        from voxelhex_tpu_torch.render.jax_renderer import rays_on

        o, d = rays_on(origins, directions, self.device)
        return trace_fast(self.tree, self.brick_dim, o, d, self.max_iters, start_t=start_t)

    def render(self, camera, bg=(0.0, 0.0, 0.0)):
        """A frame of ``camera``'s host rays: f32 NumPy [H, W, 3].  With
        ``prepass`` and an even size, a half-res depth launch first gives
        each full-res ray its start.  Each launch's warps take 4 x 8 pixel
        tiles of its frame."""
        from voxelhex_tpu_torch.ops.flat import trace_fast
        from voxelhex_tpu_torch.render.camera import Camera
        from voxelhex_tpu_torch.render.jax_renderer import rays_on, shade_frame

        origins, dirs = camera.rays()
        h, w = origins.shape[:2]
        o, d = rays_on(origins, dirs, self.device)
        if self.prepass and h % 2 == 0 and w % 2 == 0:
            half = Camera(origin=camera.origin, target=camera.target, up=camera.up,
                          fov_y_deg=camera.fov_y_deg, resolution=(w // 2, h // 2))
            po, pd = rays_on(*half.rays(), self.device)
            depth = trace_fast(self.tree, self.brick_dim, po, pd, self.max_iters, depth=True,
                               _width=w // 2)
            hit, voxel, _b, _c, _p, normal = trace_fast(
                self.tree, self.brick_dim, o, d, self.max_iters,
                start_depth=(depth, h // 2, w // 2), _width=w)
        else:
            hit, voxel, _b, _c, _p, normal = trace_fast(self.tree, self.brick_dim, o, d,
                                                        self.max_iters, _width=w)
        rgb = shade_frame(self.tree["palette"], hit, voxel, normal, bg)
        return rgb.cpu().numpy().reshape(h, w, 3)


