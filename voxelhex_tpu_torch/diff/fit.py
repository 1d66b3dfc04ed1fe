"""Albedo fitting: per-voxel colors optimized against target pixels, the
port's copy of the reference's ``voxelhex_tpu/diff/fit.py`` (the
"differentiable fit" configuration: render a scene from several viewpoints,
start from other colors, recover the originals by gradient descent through
the renderer).

A step is the albedo kernel's forward and backward (``csrc/albedo.cu``) and
one launch of ``csrc/adam.cu`` over the single [B, d^3, 3] param, clamped
to [0, 1]; with ``precompute_hits=False`` each step also traces
(``csrc/traverse.cu``).
"""

from __future__ import annotations

import torch

from voxelhex_tpu_torch.diff.optim import adam, resume, run_steps
from voxelhex_tpu_torch.diff.render import DiffRenderer
from voxelhex_tpu_torch.ops.albedo import shade_albedo

CLAMP = (0.0, 1.0)  # the albedo's clamp after each update


def albedo_step(params, opt_state, opt, loss_fn):
    """One step: ``loss_fn(params)`` (a differentiable scalar) and its
    gradient, ``opt``'s update in place, the clamp.  Returns ``(params,
    opt_state, loss)``, the loss a device scalar; nothing is read back."""
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(p)
        (grad,) = torch.autograd.grad(loss, [p])
    params, opt_state = opt.update(grad, opt_state, params, clamps=(CLAMP,))
    return params, opt_state, loss.detach()


def fit_albedo(diff: DiffRenderer, origins, dirs, targets, steps: int = 200, lr: float = 0.05,
               params0=None, precompute_hits: bool = True, checkpoint_path=None,
               checkpoint_every: int = 0, chain: int = 8):
    """Fit per-voxel albedo to target pixels: returns ``(params, losses)``.

    * ``origins`` / ``dirs`` — [R, 3] rays (all viewpoints concatenated);
    * ``targets`` — [R, 3] target pixel colors;
    * ``params0`` — the start, [B, d^3, 3] (copied; default the palette
      colors);
    * ``precompute_hits`` — trace once and train on the cached hits (the
      structure is fixed), else trace every step;
    * ``checkpoint_path`` / ``checkpoint_every`` — save (step, params,
      optimizer state) every ``checkpoint_every`` steps and at the end; a
      fit restarted with the same path resumes where it stopped, with the
      results of an uninterrupted run;
    * ``chain`` — steps queued before one blocking read of their losses
      (:func:`~voxelhex_tpu_torch.diff.optim.run_steps`); it changes no
      result."""
    origins, dirs, targets = diff._rays(origins), diff._rays(dirs), diff._rays(targets)
    if params0 is None:
        params = diff.init_params()
    else:
        params = torch.as_tensor(params0, dtype=torch.float32, device=diff.device).clone()
    opt = adam(lr)
    start, params, opt_state = resume(checkpoint_path, params, opt.init(params))

    if precompute_hits:
        hit, _voxel, brick, cell, _point, normal = diff.trace_rays(origins, dirs)

        def loss_fn(p):
            return torch.mean((shade_albedo(p, hit, brick, cell, normal) - targets) ** 2)
    else:
        def loss_fn(p):
            return diff.loss(p, origins, dirs, targets)

    params, _state, losses = run_steps(
        lambda p, s: albedo_step(p, s, opt, loss_fn), params, opt_state, start, steps, chain,
        checkpoint_path, checkpoint_every)
    return params, losses
