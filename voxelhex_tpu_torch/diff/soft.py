"""Soft-occupancy differentiable rendering: transmittance compositing over
the first K voxels each ray meets (the reference's ``diff/soft.py``).

Each ray records its first K occupied voxels (the multi-hit march), and the
image is composited with soft per-voxel opacities

    C = sum_i T_{i-1} a_i c_i (+ T_K bg),   T_i = prod_{j <= i} ((1 - a_j) + 1e-9),

a = sigmoid(logit), over dense flat params: albedo f32 [S^3 * 3], logits
f32 [S^3].  Pixel gradients flow into the albedo and the opacity of every
recorded voxel.  On the card a training step is four kernel launches: the
march (``ops/multihit.py``), the composite forward and backward
(``ops/composite.py``) and the Adam update (``ops/adam.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.constants import COLOR_EMPTY
from voxelhex_tpu_torch.ops.composite import MAX_HITS, composite as _composite
from voxelhex_tpu_torch.ops.multihit import multihit
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS
from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
from voxelhex_tpu_torch.render.renderer import check_source, resolve_device

# the param clamps of the reference's step (`_apply_update`)
CLAMPS = ((0.0, 1.0), (-12.0, 12.0))  # albedo, logits


class SoftRenderer:
    """Differentiable renderer over dense per-voxel (albedo, opacity) params
    of one BitGrid (or of a BoxTree's or FlatTree's, built by
    ``check_source``), on one device.

    A training step is a fixed sequence of launches that reads nothing back
    to the host: one thread per ray marches until its own end, and the
    backward skips rays with no hit.  So the reference's march plans,
    compaction buckets, validation tokens and ray fingerprints
    (``soft.py:617-780``) have no counterpart here, and each step is exact
    without them.  Params and optimizer state are updated in place.

    Not ported (ROADMAP.md): ``tracer="skip"``, ``flat_params=False``, the
    beam prepass (``beam=``), ``with_candidates``, ``fit_soft`` and
    ``params_to_tree``."""

    def __init__(self, source, max_hits: int = 4, max_iters: int = MAX_ITERS,
                 device="cuda", tracer: str = "stack", flat_params: bool = True):
        if tracer != "stack":
            raise NotImplementedError(f"tracer={tracer!r}: the skip tracer is ROADMAP.md "
                                      "queue 1 item 11")
        if not flat_params:
            raise NotImplementedError("flat_params=False (the [S^3, 3] albedo rows) is not "
                                      "ported; params are flat (ROADMAP.md queue 1 item 6)")
        if not 1 <= int(max_hits) <= MAX_HITS:
            raise ValueError(f"max_hits {max_hits}: the kernels take 1..{MAX_HITS}")
        self.device = resolve_device(device)
        self.bitgrid = check_source(source)
        self.tree = device_bitgrid(self.bitgrid, self.device)
        self.size = int(self.bitgrid.size)
        self.max_hits = int(max_hits)
        self.max_iters = int(max_iters)

    def init_params(self, init_opacity: float = 0.99):
        """Flat albedo [S^3 * 3] (the voxel's palette color, 0 where empty)
        and opacity logits [S^3] (logit(init_opacity) where occupied, -10
        where empty), on the renderer's device."""
        colors = np.asarray(self.bitgrid.colors)
        pal = np.asarray(self.bitgrid.palette)
        occupied = colors != COLOR_EMPTY
        ci = np.clip(colors, 0, pal.shape[0] - 1).astype(np.int64)
        albedo = pal[ci][:, :3].astype(np.float32)
        albedo[~occupied] = 0.0
        logit = np.float32(np.log(init_opacity / (1 - init_opacity)))
        logits = np.where(occupied, logit, np.float32(-10.0)).astype(np.float32)
        return {"albedo": torch.from_numpy(albedo.reshape(-1)).to(self.device),
                "logits": torch.from_numpy(logits).to(self.device)}

    def _rays(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1, 3)

    def trace_hits(self, origins, dirs, compact=None, beam=None):
        """``(count int32 [R], voxels int32 [R, K, 3], dists f32 [R, K])``:
        the first K occupied voxels along each ray, -1 / inf in empty slots.
        ``compact`` changes nothing (every ray stops on its own); ``beam``
        is not ported (ROADMAP.md queue 1 item 3)."""
        del compact
        if beam is not None:
            raise NotImplementedError("the beam prepass is ROADMAP.md queue 1 item 3")
        return multihit(self.tree, self._rays(origins), self._rays(dirs), self.max_hits,
                        self.max_iters)

    def composite(self, params, voxels, bg_color=None):
        """Differentiable transmittance compositing over recorded voxels:
        rgb f32 [R, 3]."""
        if params["albedo"].ndim != 1:
            raise ValueError(f"params['albedo'] has ndim {params['albedo'].ndim}; the port's "
                             "params are flat ([S^3 * 3]): use albedo.reshape(-1)")
        return _composite(params["albedo"], params["logits"], voxels, self.size, bg_color)

    def render(self, params, origins, dirs, bg_color=None):
        _count, voxels, _d = self.trace_hits(origins, dirs)
        return self.composite(params, voxels, bg_color)

    def loss(self, params, voxels, target):
        rgb = self.composite(params, voxels)
        return torch.mean((rgb - target) ** 2)

    def grad_on_hits(self, params, count, voxels, target, fit_albedo: bool = True):
        """``(loss, grads)``: the loss of :meth:`loss` and its gradients
        ``{"albedo": f32 [S^3 * 3] or None, "logits": f32 [S^3]}`` (albedo None
        when ``fit_albedo`` is false).  Rays with no hit add nothing to the
        gradients (the backward kernel skips them), which is what the
        reference's compaction of hit rows computes; ``count`` is accepted
        for the reference's signature."""
        del count
        target = self._rays(target)
        albedo = params["albedo"].detach().requires_grad_(fit_albedo)
        logits = params["logits"].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss({"albedo": albedo, "logits": logits}, voxels, target)
            wrt = [albedo, logits] if fit_albedo else [logits]
            g = torch.autograd.grad(loss, wrt)
        grads = {"albedo": g[0] if fit_albedo else None, "logits": g[-1]}
        return loss.detach(), grads

    def train_step_fused(self, params, opt_state, opt, origins, dirs, target, beam=None,
                         opacity_l1: float = 0.0, fit_albedo: bool = True, validate=None):
        """One training step: the march, the composite and its gradient, the
        opacity-L1 term, ``opt``'s update (:func:`~voxelhex_tpu_torch.diff.
        optim.adam`) and the param clamps.  Returns ``(params, opt_state,
        loss)`` with ``loss`` a device scalar; params and the moments are
        updated in place.  ``fit_albedo=False`` gives Adam zero albedo
        gradients, as the reference does (momentum still moves albedo).
        Nothing is read back to the host, so steps queue back to back;
        ``validate`` is accepted for the reference's signature and has
        nothing to check."""
        del validate
        _count, voxels, _dists = self.trace_hits(origins, dirs, beam=beam)
        loss, grads = self.grad_on_hits(params, None, voxels, target, fit_albedo)
        if opacity_l1:
            loss = loss + opacity_l1 * torch.mean(torch.sigmoid(params["logits"]))
        params, opt_state = opt.update(grads, opt_state, params, opacity_l1=opacity_l1,
                                       clamps=CLAMPS)
        return params, opt_state, loss

    def train_steps_fused(self, params, opt_state, opt, origins, dirs, target, n_steps: int,
                          beam=None, opacity_l1: float = 0.0, fit_albedo: bool = True,
                          validate=None):
        """``n_steps`` of :meth:`train_step_fused`: ``(params, opt_state,
        losses f32 [n_steps])`` on the device."""
        origins, dirs, target = self._rays(origins), self._rays(dirs), self._rays(target)
        losses = []
        for _ in range(int(n_steps)):
            params, opt_state, loss = self.train_step_fused(
                params, opt_state, opt, origins, dirs, target, beam=beam,
                opacity_l1=opacity_l1, fit_albedo=fit_albedo, validate=validate)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)
