"""Differentiable rendering.

* :mod:`voxelhex_tpu_torch.diff.soft` — the soft-occupancy renderer: the
  multi-hit march, transmittance compositing and its gradient, and the
  training step.
* :mod:`voxelhex_tpu_torch.diff.optim` — optax's Adam as one fused pass.
"""
