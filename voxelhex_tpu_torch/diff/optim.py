"""The optimizer of the trainers, and their loop of steps.

:func:`adam` is optax's ``adam`` (0.2.6) for the soft renderer's two param
groups or one param tensor, with the state optax keeps
(``ScaleByAdamState``: ``count``, ``mu``, ``nu``).  Its ``update`` is the
step's fused pass (:func:`voxelhex_tpu_torch.ops.adam.adam_update`), which
also applies the soft renderer's opacity-L1 term and the clamps; it is not
a general optax replacement.

:func:`run_steps` is the loop of the offline trainers (``fit_soft``,
``fit_albedo``): steps queued ``chain`` at a time before one blocking read
of their losses, with checkpoint and resume on the reference's step
boundaries.
"""

from __future__ import annotations

import os

import torch

from voxelhex_tpu_torch.io.checkpoint import load_train_state, save_train_state
from voxelhex_tpu_torch.ops.adam import AdamConfig


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamConfig:
    """optax.adam(lr, b1, b2, eps) for the trainers' params: an
    :class:`~voxelhex_tpu_torch.ops.adam.AdamConfig` with ``init(params)``
    and ``update(grads, state, params, opacity_l1=0.0, clamps=None)``."""
    return AdamConfig(float(lr), float(b1), float(b2), float(eps))


def resume(checkpoint_path, params, opt_state):
    """``(start step, params, opt_state)``: the state saved at
    ``checkpoint_path`` restored into the given templates, or step 0 and the
    templates themselves where there is no checkpoint."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        return load_train_state(checkpoint_path, params, opt_state)
    return 0, params, opt_state


def run_steps(step, params, opt_state, start: int, steps: int, chain: int = 8,
              checkpoint_path=None, checkpoint_every: int = 0):
    """Run ``step(params, opt_state) -> (params, opt_state, loss)`` (``loss``
    a device scalar) from step ``start`` to ``steps``: ``(params, opt_state,
    losses)``, the losses of the steps run as floats.

    The reference's loop (``fit_soft``, ``fit_albedo``): the steps run in
    blocks of ``chain`` whose losses are read in one blocking read, and one
    at a time (one read each) where fewer than ``chain`` steps are left
    before the end or the next checkpoint boundary; with
    ``checkpoint_path`` and ``checkpoint_every``, the state is saved at
    every multiple of ``checkpoint_every``, and with ``checkpoint_path`` at
    the end, so a resumed run stops where the uninterrupted one stopped.
    The blocks only set where the host waits: the steps and their results
    are the same for any ``chain``."""
    chain = max(1, int(chain))
    losses = []
    i = start
    while i < steps:
        stop = steps
        if checkpoint_path and checkpoint_every:
            stop = min(stop, (i // checkpoint_every + 1) * checkpoint_every)
        n = chain if chain > 1 and stop - i >= chain else 1
        block = []
        for _ in range(n):
            params, opt_state, loss = step(params, opt_state)
            block.append(loss)
        losses.extend(torch.stack(block).tolist())  # the block's one blocking read
        i += n
        if checkpoint_path and checkpoint_every and i % checkpoint_every == 0:
            save_train_state(checkpoint_path, i, params, opt_state)
    if checkpoint_path and start < steps:
        save_train_state(checkpoint_path, steps, params, opt_state)
    return params, opt_state, losses
