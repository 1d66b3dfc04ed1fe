"""The soft renderer's optimizer step in one pass: the CUDA kernel
``csrc/adam.cu`` and its wrapper.

Replaces the XLA program of the step's tail (``_apply_update`` /
``_finish_step_fn`` with the opacity-L1 term, ``voxelhex_tpu/diff/soft.py``),
which has no Pallas source.  :func:`adam_plain` is the plain PyTorch
version.  Both compute optax 0.2.6's Adam in the order XLA:CPU compiles it
(see ``csrc/adam.cu``), so each equals the reference bit for bit on equal
inputs; ``torch.optim.Adam`` folds the bias corrections differently and is
not used.

Params and state are updated in place (the reference makes new arrays);
the new count is a new device tensor, so no step reads the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from voxelhex_tpu_torch.fp import fma32, sqrt32
from voxelhex_tpu_torch.ops import _build

GROUPS = ("albedo", "logits")  # the kernel's groups 0 and 1; the L1 term is on logits
INT32_MAX = 2**31 - 1


def _l1_scale(opacity_l1, n_logits: int):
    """``opacity_l1 / N`` as JAX's gradient of ``opacity_l1 *
    mean(sigmoid(logits))`` computes it: one f32 division."""
    return np.float32(opacity_l1) / np.float32(n_logits)


def _bounds(clamps, grp):
    c = clamps[grp]
    return (-np.inf, np.inf) if c is None else (float(c[0]), float(c[1]))


@dataclass(frozen=True)
class AdamConfig:
    """optax.adam's hyperparameters, and the soft renderer's fused step with
    them (:meth:`init`, :meth:`update`).  Not a general optax replacement:
    the params are the soft renderer's two flat groups (``GROUPS``), and the
    step adds the opacity-L1 gradient and clamps each group."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        """``{"count": int32 [] (0), "mu": zeros, "nu": zeros}`` on the params'
        device, ``mu`` and ``nu`` keyed as ``params``: optax's
        ``ScaleByAdamState``."""
        dev = params[GROUPS[0]].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros_like(params[k]) for k in GROUPS},
            "nu": {k: torch.zeros_like(params[k]) for k in GROUPS},
        }

    def update(self, grads, state, params, opacity_l1: float = 0.0, clamps=(None, None)):
        """optax's ``update`` and ``apply_updates`` in one pass: returns
        ``(params, state)``, params updated in place (see
        :func:`adam_update`)."""
        return params, adam_update(params, grads, state, self, opacity_l1, clamps)


def _bias_corrections(count, cfg):
    """``(count + 1 (saturating), 1 - b1^c, 1 - b2^c)`` on the count's
    device: the power is the correctly rounded f32 of ``b^c``."""
    c = torch.where(count < INT32_MAX, count + 1, count)
    cd = c.double()
    bc1 = 1.0 - torch.pow(torch.tensor(float(np.float32(cfg.b1)), dtype=torch.float64,
                                       device=count.device), cd).float()
    bc2 = 1.0 - torch.pow(torch.tensor(float(np.float32(cfg.b2)), dtype=torch.float64,
                                       device=count.device), cd).float()
    return c, bc1, bc2


def adam_plain(params, grads, state, cfg: AdamConfig, opacity_l1: float = 0.0,
               clamps=(None, None)):
    """The plain PyTorch step (see :func:`adam_update`)."""
    c, bc1, bc2 = _bias_corrections(state["count"], cfg)
    f = np.float32
    for grp, name in enumerate(GROUPS):
        p, mu, nu = params[name], state["mu"][name], state["nu"][name]
        g = grads.get(name)
        g = torch.zeros_like(p) if g is None else g
        if name == "logits" and opacity_l1:
            s = 1.0 / (torch.exp(-p) + 1.0)
            scale = float(_l1_scale(opacity_l1, p.numel()))
            g = fma32(torch.full_like(p, scale), s * (1.0 - s), g)
        m = fma32(g, float(f(1 - cfg.b1)), float(f(cfg.b1)) * mu)
        v = fma32(g * g, float(f(1 - cfg.b2)), float(f(cfg.b2)) * nu)
        den = bc1 * (sqrt32(v / bc2) + float(f(cfg.eps)))
        y = fma32(m / den, -float(f(cfg.lr)), p)
        lo, hi = _bounds(clamps, grp)
        y = torch.where(y < lo, torch.full_like(y, lo), y)
        y = torch.where(y > hi, torch.full_like(y, hi), y)
        mu.copy_(m)
        nu.copy_(v)
        p.copy_(y)
    return dict(state, count=c)


def adam_params(cfg: AdamConfig, n_logits: int, opacity_l1: float = 0.0,
                clamps=(None, None)) -> _build.AdamParams:
    """The kernel's launch constants."""
    f = np.float32
    a = _build.AdamParams()
    a.neg_lr = -f(cfg.lr)
    a.b1, a.b2 = f(cfg.b1), f(cfg.b2)
    a.one_m_b1, a.one_m_b2 = f(1 - cfg.b1), f(1 - cfg.b2)
    a.eps = f(cfg.eps)
    a.b1_d, a.b2_d = float(f(cfg.b1)), float(f(cfg.b2))
    a.l1_scale = _l1_scale(opacity_l1, n_logits) if opacity_l1 else 0.0
    for grp in range(2):
        a.lo[grp], a.hi[grp] = _bounds(clamps, grp)
    return a


def adam_update(params, grads, state, cfg: AdamConfig, opacity_l1: float = 0.0,
                clamps=(None, None)):
    """One optimizer step over ``params`` = {"albedo": f32 [3N], "logits": f32
    [N]}: the opacity-L1 gradient ``opacity_l1 * sigmoid'(logit) / N`` added
    to the logits' gradient, optax's Adam (``state`` = {"count": int32 [],
    "mu": {...}, "nu": {...}}), then each group's clamp, ``clamps[i]`` =
    (low, high) or None for no clamp.  A gradient of
    ``None`` is zeros.  Updates params, mu and nu in place and returns the
    state with the new count.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    dev = params["logits"].device
    if dev.type == "cpu":
        return adam_plain(params, grads, state, cfg, opacity_l1, clamps)
    if dev.type != "cuda":
        raise ValueError(f"adam runs on cuda or cpu tensors, not {dev}")
    specs = [("count", state["count"], torch.int32, ())]
    for name in GROUPS:
        n = params[name].numel()
        specs += [(name, params[name], torch.float32, (n,)),
                  (f"mu[{name}]", state["mu"][name], torch.float32, (n,)),
                  (f"nu[{name}]", state["nu"][name], torch.float32, (n,))]
        if grads.get(name) is not None:
            specs.append((f"grads[{name}]", grads[name], torch.float32, (n,)))
    _build.check_inputs(dev, specs)
    lib = _build.library()
    count = torch.empty_like(state["count"])
    ptrs = []
    for name in GROUPS:
        g = grads.get(name)
        ptrs += [params[name].data_ptr(), None if g is None else g.data_ptr(),
                 state["mu"][name].data_ptr(), state["nu"][name].data_ptr(), params[name].numel()]
    err = lib.vhx_adam(*ptrs, state["count"].data_ptr(), count.data_ptr(),
                       adam_params(cfg, params["logits"].numel(), opacity_l1, clamps),
                       dev.index or 0,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adam kernel launch")
    adam_update.launches += 1
    return dict(state, count=count)


adam_update.launches = 0
