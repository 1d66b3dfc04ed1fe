"""Differentiable rendering of per-voxel albedo over a flat boxtree, the
port's copy of the reference's ``voxelhex_tpu/diff/render.py``.

The structure (occupancy, topology) is fixed; the per-voxel albedo
[B, d^3, 3] is the trainable parameter:

* ``densify`` rewrites solid brick descriptors into real bricks, so every
  hit addresses a trainable voxel;
* the march is the BitGrid traversal (:func:`~voxelhex_tpu_torch.ops.
  traverse.traverse`, ``csrc/traverse.cu`` on the card), and each hit's
  (brick, cell) comes from dense lookup grids built once;
* shading gathers ``albedo[brick, cell]`` and lights it, and its gradient
  scatters the pixel gradients back into the albedo
  (:func:`~voxelhex_tpu_torch.ops.albedo.shade_albedo`, ``csrc/albedo.cu``
  on the card).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from voxelhex_tpu_torch.constants import (BOX_NODE_CHILDREN_COUNT, EMPTY_DESC, NO_COLOR_HIT,
                                          SOLID_FLAG)
from voxelhex_tpu_torch.ops.albedo import lambert, shade_albedo
from voxelhex_tpu_torch.ops.traverse import traverse
from voxelhex_tpu_torch.render.bitgrid import build_bitgrid, device_bitgrid
from voxelhex_tpu_torch.render.renderer import resolve_device
from voxelhex_tpu_torch.tree.flat import FlatTree


def densify(flat: FlatTree) -> FlatTree:
    """Expand solid brick descriptors into parted bricks (one brick per
    descriptor slot group) so hits always carry (brick, cell) indices."""
    d3 = flat.brick_dim**3
    children = flat.node_children.copy()
    mips = flat.node_mips.copy()
    new_bricks = [flat.bricks]
    next_idx = flat.bricks.shape[0]

    def expand(desc: int) -> int:
        nonlocal next_idx
        new_bricks.append(np.full((1, d3), desc & ~SOLID_FLAG, dtype=np.int32))
        next_idx += 1
        return next_idx - 1

    for key in range(flat.n_nodes):
        meta = int(flat.node_meta[key])
        if not meta & 1:  # internal: children are node keys
            continue
        if meta & 2:  # uniform: one descriptor replicated
            desc = int(children[key, 0])
            if desc != EMPTY_DESC and desc & SOLID_FLAG:
                children[key, :] = expand(desc)
        else:
            for s in range(BOX_NODE_CHILDREN_COUNT):
                desc = int(children[key, s])
                if desc != EMPTY_DESC and desc & SOLID_FLAG:
                    children[key, s] = expand(desc)
    for key in range(flat.n_nodes):
        desc = int(mips[key])
        if desc != EMPTY_DESC and desc & SOLID_FLAG:
            mips[key] = expand(desc)

    bricks = np.concatenate(new_bricks, axis=0) if len(new_bricks) > 1 else flat.bricks
    return replace(flat, node_children=children, node_mips=mips, bricks=bricks)


def dense_brick_cells(flat: FlatTree):
    """Dense int32 [S^3] grids (x-fastest voxel-address order): for every
    voxel the brick-pool row and in-brick cell covering it, or -1.

    The inverse of the brick pool at render time: a dense-grid tracer's hit
    voxel addresses the [B, d^3, 3] albedo with one gather.  Assumes
    ``densify`` ran (no solid descriptors)."""
    S, d = flat.size, flat.brick_dim
    brick_of = np.full(S * S * S, -1, dtype=np.int32)
    cell_of = np.full(S * S * S, -1, dtype=np.int32)

    def paint(desc, x0, y0, z0, extent):
        if desc == EMPTY_DESC or desc & SOLID_FLAG:
            return  # solids were densified away; leftovers carry no params
        vox = flat.bricks[desc].reshape(d, d, d).transpose(2, 1, 0)  # [x, y, z]
        f = max(extent // d, 1)
        # voxel (x0 + i, y0 + j, z0 + k) maps to brick cell (i // f, j // f, k // f)
        ci = np.arange(extent) // f if extent >= d else np.arange(extent)
        cx, cy, cz = np.meshgrid(ci, ci, ci, indexing="ij")
        cell = cx + cy * d + cz * d * d  # [extent]^3, [x, y, z]
        occupied = vox[cx, cy, cz] != EMPTY_DESC
        xs = np.arange(x0, x0 + extent)
        ys = np.arange(y0, y0 + extent)
        zs = np.arange(z0, z0 + extent)
        addr = xs[:, None, None] + ys[None, :, None] * S + zs[None, None, :] * S * S
        a = addr[occupied]
        brick_of[a] = desc
        cell_of[a] = cell[occupied]

    def visit(key, x0, y0, z0, size_):
        meta = int(flat.node_meta[key])
        cell = size_ // 4
        if meta & 2:  # uniform
            paint(int(flat.node_children[key, 0]), x0, y0, z0, size_)
        elif meta & 1:  # leaf
            for s in range(BOX_NODE_CHILDREN_COUNT):
                desc = int(flat.node_children[key, s])
                if desc == EMPTY_DESC:
                    continue
                paint(desc, x0 + (s % 4) * cell, y0 + ((s // 4) % 4) * cell,
                      z0 + (s // 16) * cell, cell)
        else:
            for s in range(BOX_NODE_CHILDREN_COUNT):
                child = int(flat.node_children[key, s])
                if child < 0:
                    continue
                visit(child, x0 + (s % 4) * cell, y0 + ((s // 4) % 4) * cell,
                      z0 + (s // 16) * cell, cell)

    visit(0, 0, 0, 0, S)
    return brick_of, cell_of


def albedo_params_from_flat(flat: FlatTree) -> torch.Tensor:
    """Initial per-voxel albedo f32 [B, d^3, 3] (on the CPU) from the
    palette colors; 0 for empty and colorless voxels."""
    vox = np.maximum(flat.bricks, 0)
    vox = np.minimum(vox, flat.palette.shape[0] - 1)
    alb = flat.palette[vox][:, :, :3].astype(np.float32)
    alb[flat.bricks < 0] = 0.0
    alb[flat.bricks == NO_COLOR_HIT] = 0.0
    return torch.from_numpy(alb)


def shade_diff(albedo_rgb, hit, normal, bg):
    """The reference's shading, differentiable in albedo: ``albedo_rgb *
    lambert`` where a ray hit, ``bg`` where it missed (plain PyTorch; the
    renderer's own path is :func:`~voxelhex_tpu_torch.ops.albedo.
    shade_albedo`)."""
    lit = albedo_rgb * lambert(normal)[:, None]
    bg = torch.as_tensor(bg, dtype=torch.float32, device=lit.device)
    return torch.where(hit[:, None], lit, bg.expand_as(lit))


class DiffRenderer:
    """Differentiable forward renderer with loss helpers, on one device.

    ``render(params, origins, dirs)`` is differentiable in ``params`` (the
    [B, d^3, 3] per-voxel albedo): the BitGrid traversal finds each ray's
    hit, and the albedo kernel gathers, lights and (backward) scatters.
    ``max_inner`` is the traversal's step limit a ray.  The traversal runs
    the kernels' tracer settings (``ops.traverse.KERNEL_CONFIG``, four DDA
    substeps an ADVANCE) where the reference's ``DiffRenderer`` runs two:
    the substeps unroll the same DDA, so every ray that ends within
    ``max_inner`` steps hits the same voxel with the same normal; only
    ``point``, where the march stopped, may differ.  ``flat_albedo_bwd`` is
    accepted at both values and changes nothing: the backward is always the
    flat scatter."""

    def __init__(self, flat: FlatTree, max_inner: int = 2048, flat_albedo_bwd: bool = True, *,
                 device="cuda"):
        if not isinstance(flat, FlatTree):
            raise TypeError(f"DiffRenderer takes a FlatTree, not {type(flat).__name__}")
        self.device = resolve_device(device)
        self.flat_albedo_bwd = bool(flat_albedo_bwd)
        self.flat = densify(flat)
        self.brick_dim = self.flat.brick_dim
        self.bitgrid = build_bitgrid(self.flat)
        self.size = int(self.bitgrid.size)
        self.max_inner = int(max_inner)
        self.tree = device_bitgrid(self.bitgrid, self.device)
        brick_of, cell_of = dense_brick_cells(self.flat)
        self.tree["brick_of"] = torch.from_numpy(brick_of).to(self.device)
        self.tree["cell_of"] = torch.from_numpy(cell_of).to(self.device)

    def init_params(self) -> torch.Tensor:
        """The palette colors as albedo f32 [B, d^3, 3] on the device."""
        return albedo_params_from_flat(self.flat).to(self.device)

    def _rays(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1, 3)

    def trace_rays(self, origins, dirs):
        """The geometry pass, with no gradient: per ray ``(hit bool, voxel
        int32, brick int32, cell int32, point f32 [3], normal f32 [3])``;
        brick and cell are -1 where the ray missed."""
        hit, voxel, hvox, point, normal = traverse(self.tree, self._rays(origins),
                                                   self._rays(dirs), self.max_inner)
        S = self.size
        v = hvox.clamp(0, S - 1).long()
        addr = v[:, 0] + v[:, 1] * S + v[:, 2] * S * S
        none = torch.full_like(hvox[:, 0], -1)
        brick = torch.where(hit, self.tree["brick_of"][addr], none)
        cell = torch.where(hit, self.tree["cell_of"][addr], none)
        return hit, voxel, brick, cell, point, normal

    def render(self, params, origins, dirs, bg=(0.0, 0.0, 0.0)):
        """rgb f32 [R, 3] of the rays, differentiable in ``params``."""
        hit, _voxel, brick, cell, _point, normal = self.trace_rays(origins, dirs)
        return shade_albedo(params, hit, brick, cell, normal, bg)

    def loss(self, params, origins, dirs, target, bg=(0.0, 0.0, 0.0)):
        rgb = self.render(params, origins, dirs, bg)
        return torch.mean((rgb - self._rays(target)) ** 2)
