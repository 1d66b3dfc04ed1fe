"""Differentiable rendering.

* :mod:`voxelhex_tpu_torch.diff.render` — ``DiffRenderer``: per-voxel
  albedo over a flat boxtree, the traversal for geometry and the albedo
  kernel for shading and its gradient;
* :mod:`voxelhex_tpu_torch.diff.fit` — ``fit_albedo``, its offline trainer;
* :mod:`voxelhex_tpu_torch.diff.soft` — the soft-occupancy renderer (the
  multi-hit march, transmittance compositing and its gradient, the
  training step), ``fit_soft``, ``with_candidates`` and ``params_to_tree``;
* :mod:`voxelhex_tpu_torch.diff.optim` — optax's Adam as one fused pass, and
  the trainers' loop with checkpoint and resume.
"""

from voxelhex_tpu_torch.diff.fit import fit_albedo
from voxelhex_tpu_torch.diff.render import DiffRenderer, albedo_params_from_flat, densify

__all__ = ["DiffRenderer", "albedo_params_from_flat", "densify", "fit_albedo"]
