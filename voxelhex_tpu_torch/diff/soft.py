"""Soft-occupancy differentiable rendering: transmittance compositing over
the first K voxels each ray meets (the reference's ``diff/soft.py``).

Each ray records its first K occupied voxels (the multi-hit march), and the
image is composited with soft per-voxel opacities

    C = sum_i T_{i-1} a_i c_i (+ T_K bg),   T_i = prod_{j <= i} ((1 - a_j) + 1e-9),

a = sigmoid(logit), over dense flat params: albedo f32 [S^3 * 3], logits
f32 [S^3] (or, with ``flat_params=False``, albedo rows [S^3, 3]).  Pixel
gradients flow into the albedo and the opacity of every recorded voxel.  On
the card a training step is four kernel launches: the march
(``ops/multihit.py``), the composite forward and backward
(``ops/composite.py``) and the Adam update (``ops/adam.py``).  With a beam
(``beam_spec``, the reference's beam prepass on the multi-hit march) a step
is one launch of the beam kernel (``ops/beam.py``) more, and the march
starts each ray from its tile's beam start; a chain of steps
(``train_steps_fused``) runs the beam once.

Around the renderer: :func:`fit_soft`, the offline trainer (one march, then
the composite and the update each step); :func:`with_candidates`, a
renderer whose march also records the empty shell around the scene, so a
fit can grow geometry; :func:`params_to_tree`, the bake of fitted params
back into a BoxTree.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.constants import COLOR_EMPTY
from voxelhex_tpu_torch.diff.optim import adam, resume, run_steps
from voxelhex_tpu_torch.ops.beam import beam_tiles
from voxelhex_tpu_torch.ops.composite import MAX_HITS, composite as _composite
from voxelhex_tpu_torch.ops.multihit import multihit
from voxelhex_tpu_torch.ops.traverse import MAX_ITERS
from voxelhex_tpu_torch.render.bitgrid import BitGrid, _pack_pyramid, device_bitgrid
from voxelhex_tpu_torch.render.renderer import beam_spec_of, check_source, resolve_device
from voxelhex_tpu_torch.render.starts import BEAM_TILE
from voxelhex_tpu_torch.tree.build import from_voxels

# the param clamps of the reference's step (`_apply_update`)
CLAMPS = ((0.0, 1.0), (-12.0, 12.0))  # albedo, logits
SKIP_SUBSTEPS = 3  # the reference's skip_substeps default, which its soft renderer takes


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

    The albedo is flat [S^3 * 3] (``flat_params``, the default) or rows
    [S^3, 3]; both reach the same kernels (the rows as a flat view), and the
    gradients, moments and ``init_params`` keep the layout.
    ``flat_albedo_bwd`` is accepted at both values and changes nothing.

    ``tracer="skip"`` uploads the grid's skip rows and marches the skip
    tracer (``skip_substeps`` 3, the reference's default), as the
    reference's compacted march (``trace_hits_compacted``) does; its
    non-compacted route marches the stack tracer whatever ``tracer`` says
    (ROADMAP.md queue 3), and the port has the one route."""

    def __init__(self, source, max_hits: int = 4, max_iters: int = MAX_ITERS,
                 tracer: str = "stack", flat_albedo_bwd: bool = True, flat_params: bool = True,
                 *, device="cuda"):
        if tracer not in ("stack", "skip"):
            raise ValueError(f"tracer {tracer!r}: 'stack' or 'skip'")
        if not 1 <= int(max_hits) <= MAX_HITS:
            raise ValueError(f"max_hits {max_hits}: the kernels take 1..{MAX_HITS}")
        self.device = resolve_device(device)
        self.bitgrid = check_source(source)
        self.tracer = tracer
        # the march's tracer, as the wrappers take it: None for the stack
        self._skip_substeps = SKIP_SUBSTEPS if tracer == "skip" else None
        self.tree = device_bitgrid(self.bitgrid, self.device, skip_rows=tracer == "skip")
        # the beam prepass's dilated grids, one a level (beam_spec)
        self._beam_grids: dict = {}
        self.size = int(self.bitgrid.size)
        self.max_hits = int(max_hits)
        self.max_iters = int(max_iters)
        self.flat_albedo_bwd = bool(flat_albedo_bwd)
        self.flat_params = bool(flat_params)

    def init_params(self, init_opacity: float = 0.99):
        """Albedo [S^3 * 3] (rows [S^3, 3] with ``flat_params=False``: the
        voxel's palette color, 0 where empty) and opacity logits [S^3]
        (logit(init_opacity) where occupied, -10 where empty), on the
        renderer's device."""
        colors = np.asarray(self.bitgrid.colors)
        pal = np.asarray(self.bitgrid.palette)
        occupied = colors != COLOR_EMPTY
        ci = np.clip(colors, 0, pal.shape[0] - 1).astype(np.int64)
        albedo = pal[ci][:, :3].astype(np.float32)
        albedo[~occupied] = 0.0
        logit = np.float32(np.log(init_opacity / (1 - init_opacity)))
        logits = np.where(occupied, logit, np.float32(-10.0)).astype(np.float32)
        if self.flat_params:
            albedo = albedo.reshape(-1)  # row-major: (i, c) at 3 i + c
        return {"albedo": torch.from_numpy(albedo).to(self.device),
                "logits": torch.from_numpy(logits).to(self.device)}

    def _rays(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1, 3)

    def beam_spec(self, camera):
        """The beam prepass of ``camera`` for :meth:`trace_hits` and the
        training steps (``beam=``), or None where the reference's is: the
        tile does not divide the resolution, or no level keeps the beam
        bound.  The beam reads the occupancy of this renderer's pyramid (a
        dilated candidate grid's too) through the stack automaton on its
        dilated level-L grid, whatever the tracer, as the reference's; it
        proves no occupied voxel lies before each tile's start, so the first
        K hits are unchanged, but on rays that graze a voxel's edge, whose
        float path the start moves (5 of the bench pose's 2,073,600 rays, as
        in the reference).  The spec holds the camera, its beam grid and
        cell, the tile, and the reference's ``key`` ``(L, h / tile, w /
        tile, tile)``; the rays that go with it are the camera's ``h * w``
        rays in row order."""
        spec = beam_spec_of(self.bitgrid, self._beam_grids, self.device, camera, BEAM_TILE)
        if spec is None:
            return None
        grid, cell = spec
        w, h = camera.resolution
        L = int(cell).bit_length() // 2  # cell = 4^L
        return {"key": (L, h // BEAM_TILE, w // BEAM_TILE, BEAM_TILE), "grid": grid,
                "cell": cell, "camera": camera, "tile": BEAM_TILE}

    def beam_starts(self, beam, n_rays: int):
        """The start map of the beam spec ``beam`` (:meth:`beam_spec`) for
        ``n_rays`` rays, ``(map f32 [h / tile, w / tile], tile, w)`` on the
        device: one launch of the beam kernel.  The rays must be the spec
        camera's ``h * w`` rays in row order; another count raises
        ``ValueError`` (the reference fails there on a shape mismatch)."""
        cam, tile = beam["camera"], beam["tile"]
        w, h = cam.resolution
        if n_rays != w * h:
            raise ValueError(f"a beam for {w}x{h} = {w * h} rays, not {n_rays}: trace the "
                             "beam camera's rays in row order")
        starts = beam_tiles([(beam["grid"], beam["cell"], cam)], tile, self.device)[0]
        return starts, tile, w

    def _march(self, origins, dirs, start=None):
        return multihit(self.tree, origins, dirs, self.max_hits, self.max_iters, start,
                        self._skip_substeps)

    def trace_hits(self, origins, dirs, compact=None, beam=None):
        """``(count int32 [R], voxels int32 [R, K, 3], dists f32 [R, K])``:
        the first K occupied voxels along each ray, -1 / inf in empty slots.
        ``compact`` changes nothing (every ray stops on its own).  With
        ``beam`` (:meth:`beam_spec`), one launch of the beam kernel, then the
        march from each ray's beam start (:meth:`beam_starts`)."""
        del compact
        o, d = self._rays(origins), self._rays(dirs)
        start = None if beam is None else self.beam_starts(beam, o.shape[0])
        return self._march(o, d, start)

    def composite(self, params, voxels, bg_color=None, count=None):
        """Differentiable transmittance compositing over recorded voxels:
        rgb f32 [R, 3].  The albedo's layout must be this renderer's.  With
        the march's ``count`` the backward reads no slot of a ray that
        recorded no hit."""
        want_ndim = 1 if self.flat_params else 2
        if params["albedo"].ndim != want_ndim:
            raise ValueError(
                f"params['albedo'] has ndim {params['albedo'].ndim} but this "
                f"SoftRenderer(flat_params={self.flat_params}) expects ndim {want_ndim}: a "
                "checkpoint saved under the other layout?  Convert with albedo.reshape(-1) "
                "(flat) or albedo.reshape(-1, 3) (rows), or construct the renderer with the "
                "matching flat_params.")
        return _composite(params["albedo"].reshape(-1), params["logits"], voxels, self.size,
                          bg_color, count)

    def render(self, params, origins, dirs, bg_color=None):
        _count, voxels, _d = self.trace_hits(origins, dirs)
        return self.composite(params, voxels, bg_color)

    def loss(self, params, voxels, target, count=None):
        rgb = self.composite(params, voxels, count=count)
        return torch.mean((rgb - target) ** 2)

    def grad_on_hits(self, params, count, voxels, target, fit_albedo: bool = True):
        """``(loss, grads)``: the loss of :meth:`loss` and its gradients
        ``{"albedo": f32 in the albedo's layout or None, "logits": f32
        [S^3]}`` (albedo None when ``fit_albedo`` is false).  Rays with no hit add nothing to the
        gradients (the backward kernel skips them), which is what the
        reference's compaction of hit rows computes; with the march's
        ``count`` (or None) the kernel reads no slot of such a ray."""
        target = self._rays(target)
        albedo = params["albedo"].detach().requires_grad_(fit_albedo)
        logits = params["logits"].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss({"albedo": albedo, "logits": logits}, voxels, target, count)
            wrt = [albedo, logits] if fit_albedo else [logits]
            g = torch.autograd.grad(loss, wrt)
        grads = {"albedo": g[0] if fit_albedo else None, "logits": g[-1]}
        return loss.detach(), grads

    def fit_step(self, params, opt_state, opt, voxels, target, opacity_l1: float = 0.0,
                 fit_albedo: bool = True, count=None):
        """A step on recorded voxels: the composite and its gradient, the
        opacity-L1 term, ``opt``'s update (:func:`~voxelhex_tpu_torch.diff.
        optim.adam`) and the param clamps.  Returns ``(params, opt_state,
        loss)`` with ``loss`` a device scalar; params and the moments are
        updated in place.  ``fit_albedo=False`` gives Adam zero albedo
        gradients, as the reference does (momentum still moves albedo).
        ``count``: the march's, or None (:meth:`grad_on_hits`)."""
        loss, grads = self.grad_on_hits(params, count, voxels, target, fit_albedo)
        if opacity_l1:
            loss = loss + opacity_l1 * torch.mean(torch.sigmoid(params["logits"]))
        params, opt_state = opt.update(grads, opt_state, params, opacity_l1=opacity_l1,
                                       clamps=CLAMPS)
        return params, opt_state, loss

    def train_step_fused(self, params, opt_state, opt, origins, dirs, target, beam=None,
                         opacity_l1: float = 0.0, fit_albedo: bool = True, validate=None):
        """One training step: the march (after the beam, with ``beam``), then
        :meth:`fit_step`.  Returns ``(params, opt_state, loss)`` with
        ``loss`` a device scalar.  Nothing is read back to the host, so
        steps queue back to back; ``validate`` is accepted for the
        reference's signature and has nothing to check."""
        del validate
        count, voxels, _dists = self.trace_hits(origins, dirs, beam=beam)
        return self.fit_step(params, opt_state, opt, voxels, target, opacity_l1, fit_albedo,
                             count)

    def train_steps_fused(self, params, opt_state, opt, origins, dirs, target, n_steps: int,
                          beam=None, opacity_l1: float = 0.0, fit_albedo: bool = True,
                          validate=None):
        """``n_steps`` of :meth:`train_step_fused`: ``(params, opt_state,
        losses f32 [n_steps])`` on the device.  With ``beam`` the beam runs
        once, before the first step, and every step's march starts from its
        starts, as the reference's chain program does (the scene does not
        change within a chain)."""
        del validate
        origins, dirs, target = self._rays(origins), self._rays(dirs), self._rays(target)
        start = None if beam is None else self.beam_starts(beam, origins.shape[0])
        losses = []
        for _ in range(int(n_steps)):
            count, voxels, _dists = self._march(origins, dirs, start)
            params, opt_state, loss = self.fit_step(params, opt_state, opt, voxels, target,
                                                    opacity_l1, fit_albedo, count)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)


def with_candidates(source, radius: int = 1, max_hits: int = 6, candidate_logit: float = -3.0,
                    candidate_albedo: float = 0.5, max_iters: int = MAX_ITERS, *, device="cuda"):
    """Grow-geometry setup: a SoftRenderer whose traced occupancy is the
    scene (a BitGrid, BoxTree or FlatTree) dilated by ``radius`` voxels
    (6-neighborhood), and params where the candidate voxels start nearly
    transparent (``candidate_logit``) with ``candidate_albedo``.

    The march records only voxels of the occupancy pyramid, so an absent
    voxel gets no gradient; the dilated pyramid lets rays record the empty
    shell around the geometry, and a fit can then raise a candidate's
    opacity (grow) as well as carve.  The colors stay the scene's.  Returns
    ``(renderer, params, candidate_mask)``, the mask a NumPy bool [S^3] in
    voxel-address order (x fastest)."""
    bg = check_source(source)
    S = int(bg.size)
    occ = (np.asarray(bg.colors) != COLOR_EMPTY).reshape(S, S, S)  # [z, y, x]
    dil = occ.copy()
    for _ in range(radius):
        grown = dil.copy()
        for ax in (0, 1, 2):
            for shift, edge in ((1, 0), (-1, -1)):
                shifted = np.roll(dil, shift, axis=ax)
                sl = [slice(None)] * 3
                sl[ax] = edge
                shifted[tuple(sl)] = False
                grown |= shifted
        dil = grown
    # the pyramid of the dilated mask ([x, y, z] for the packer)
    levels_lo, levels_hi, bases = _pack_pyramid(dil.transpose(2, 1, 0))
    bg2 = BitGrid(size=S, n_levels=len(levels_lo), level_bases=bases,
                  occ_lo=np.concatenate(levels_lo), occ_hi=np.concatenate(levels_hi),
                  colors=np.asarray(bg.colors), palette=np.asarray(bg.palette))
    renderer = SoftRenderer(bg2, max_hits=max_hits, max_iters=max_iters, device=device)
    params = renderer.init_params()
    cand = (dil & ~occ).ravel()  # [z, y, x] ravels x fastest
    cand_t = torch.from_numpy(cand).to(renderer.device)
    params["logits"] = torch.where(cand_t, float(np.float32(candidate_logit)), params["logits"])
    alb = torch.where(cand_t[:, None], float(np.float32(candidate_albedo)),
                      params["albedo"].reshape(-1, 3))
    params["albedo"] = alb.reshape(-1) if renderer.flat_params else alb
    return renderer, params, cand


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def params_to_tree(renderer: SoftRenderer, params, threshold: float = 0.5, brick_dim: int = 4,
                   simplify: bool = True):
    """Bake fitted soft params into an editable BoxTree: the voxels whose
    ``sigmoid(logit) >= threshold`` become occupied with their albedo
    (rounded to u8 RGB, alpha 255), everything else is empty.  ``params``
    may use either albedo layout; an identity bake of ``init_params()``
    (opacity 0.99) gives the source scene's voxels and colors."""
    S = renderer.size
    logits = _numpy(params["logits"]).reshape(-1)
    alb = _numpy(params["albedo"]).reshape(-1, 3)
    keep = 1.0 / (1.0 + np.exp(-logits)) >= threshold
    idx = np.flatnonzero(keep)
    # voxel address order is x + y*S + z*S^2
    positions = np.stack([idx % S, (idx // S) % S, idx // (S * S)], axis=1).astype(np.int64)
    rgb = np.clip(np.round(alb[idx] * 255.0), 0, 255).astype(np.uint8)
    colors = np.concatenate([rgb, np.full((idx.shape[0], 1), 255, dtype=np.uint8)], axis=1)
    return from_voxels(positions, colors, size=S, brick_dim=brick_dim, simplify=simplify)


def fit_soft(renderer: SoftRenderer, origins, dirs, targets, steps: int = 300, lr: float = 0.05,
             params0=None, opacity_l1: float = 0.0, fit_albedo: bool = True,
             checkpoint_path=None, checkpoint_every: int = 0, chain: int = 8):
    """Optimize albedo and occupancy logits against target pixels: returns
    ``(params, losses)``.

    The rays are marched once; each step is :meth:`SoftRenderer.fit_step`
    (the composite's forward and backward, the Adam update and the clamps).
    ``opacity_l1`` penalizes the mean opacity (carving); ``fit_albedo=False``
    freezes the colors' gradient, so only geometry adapts.  ``params0`` is
    copied (default ``init_params()``).  ``checkpoint_path`` /
    ``checkpoint_every``: save (step, params, optimizer state) every
    ``checkpoint_every`` steps and at the end; a fit restarted with the same
    path resumes from the last checkpoint, with the results of an
    uninterrupted run.  ``chain``: steps queued before one blocking read of
    their losses (:func:`~voxelhex_tpu_torch.diff.optim.run_steps`); it
    changes no result."""
    targets = renderer._rays(targets)
    if params0 is None:
        params = renderer.init_params()
    else:
        params = {k: torch.as_tensor(params0[k], dtype=torch.float32,
                                     device=renderer.device).clone() for k in ("albedo", "logits")}
    count, voxels, _dists = renderer.trace_hits(origins, dirs)
    opt = adam(lr)
    start, params, opt_state = resume(checkpoint_path, params, opt.init(params))

    def step(p, s):
        return renderer.fit_step(p, s, opt, voxels, targets, opacity_l1, fit_albedo, count)

    params, _state, losses = run_steps(step, params, opt_state, start, steps, chain,
                                       checkpoint_path, checkpoint_every)
    return params, losses
