"""Float32 primitives with the reference's exact rounding.

The reference runs on XLA:CPU, whose LLVM backend contracts a multiply that
feeds an add into one fused multiply-add (one rounding).  PyTorch has no
fused multiply-add operator, so :func:`fma32` emulates it exactly: the f32
product is exact in f64, the f64 sum is rounded to odd, and the final
f64->f32 rounding is then correctly rounded (53 >= 24 + 2 bits).
The CUDA kernels call ``__fmaf_rn`` at the same places.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x, like):
    if isinstance(x, torch.Tensor):
        return x.double()
    # a Python constant is an f32 constant in the reference
    return torch.tensor(float(np.float32(x)), dtype=torch.float64, device=like.device)


def fma32(a, b, c):
    """``a * b + c`` in float32 with one rounding; ``a`` is an f32 tensor,
    ``b`` and ``c`` f32 tensors or Python numbers (broadcasting)."""
    p = a.double() * _f64(b, a)  # exact: 24 + 24 bits
    c64 = _f64(c, a)
    s = p + c64
    # two-sum error of the f64 addition
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    # round to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def maximum(a, b):
    """XLA ``max``: NaN propagates and +0 > -0."""
    return torch.where(
        torch.isnan(a) | (a > b) | ((a == b) & ~torch.signbit(a)), a, b
    )


def sqrt32(x):
    """Correctly rounded f32 square root.  PyTorch's CPU ``sqrt`` of f32 is
    not always correctly rounded; the f64 root rounded once to f32 is."""
    return torch.sqrt(x.double()).float()


def fmin_nan(a, b):
    """``jnp.fmin``: NaN loses; on a tie the second operand wins."""
    return torch.where((a < b) | torch.isnan(b), a, b)


def fmax_nan(a, b):
    """``jnp.fmax``: NaN loses; on a tie the second operand wins."""
    return torch.where((a > b) | torch.isnan(b), a, b)
