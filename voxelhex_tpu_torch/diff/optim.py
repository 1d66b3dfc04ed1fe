"""The optimizer of the soft renderer's training step.

:func:`adam` is optax's ``adam`` (0.2.6) for the soft renderer's two flat
param groups, with the state optax keeps (``ScaleByAdamState``: ``count``,
``mu``, ``nu``).  Its ``update`` is the step's fused pass
(:func:`voxelhex_tpu_torch.ops.adam.adam_update`), which also applies the
renderer's opacity-L1 term and clamps; it is not a general optax
replacement.
"""

from __future__ import annotations

from voxelhex_tpu_torch.ops.adam import AdamConfig


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamConfig:
    """optax.adam(lr, b1, b2, eps) for the soft renderer's params: an
    :class:`~voxelhex_tpu_torch.ops.adam.AdamConfig` with ``init(params)``
    and ``update(grads, state, params, opacity_l1=0.0, clamps=(None, None))``."""
    return AdamConfig(float(lr), float(b1), float(b2), float(eps))
