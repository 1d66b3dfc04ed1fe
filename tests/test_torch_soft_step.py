"""The port's training step (plain versions, on the CPU) against the
reference's ``SoftRenderer.train_step_fused`` with ``optax.adam(0.05)``,
three steps from the same params and Adam state, carried across by
``convert.py``.

The march is exact; the composite's gradients match within the tolerance
``tests/test_torch_soft.py`` states (the reference's sigmoid rounds some
inputs an ulp otherwise, and sums run in another order).  Adam
itself is bit-exact on equal gradients (``tests/test_torch_adam.py``), but
its step is nearly sign-like, so a gradient an ulp away moves a param by
up to an ulp of the step: params are held to 5e-6.
"""

import jax
import numpy as np
import optax
import torch

from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
from voxelhex_tpu.render import bitgrid as refbg
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.diff.optim import adam
from voxelhex_tpu_torch.diff.soft import SoftRenderer
from voxelhex_tpu_torch.render import bitgrid as portbg


def _close_grads(got, want):
    """The gradients' tolerance of tests/test_torch_soft.py."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_train_steps_end_to_end():
    """Three steps of each, from the same params and Adam state carried
    across by convert.py; after each step the port's params, moments and
    loss match the reference's."""
    size = 64
    rng = np.random.default_rng(5)
    occ = rng.random((size, size, size)) < 0.03
    pal = rng.random((5, 4)).astype(np.float32)
    ref = RefSoft(refbg.bitgrid_from_occupancy(occ, palette=pal), max_hits=3)
    port = SoftRenderer(portbg.bitgrid_from_occupancy(occ, palette=pal), max_hits=3, device="cpu")
    n = 2048
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    opt_r = optax.adam(0.05)
    p_r = ref.init_params()
    s_r = opt_r.init(p_r)
    opt_p = adam(0.05)
    p_p = convert.from_jax_soft_params({k: np.asarray(v) for k, v in p_r.items()}, "cpu")
    s_p = convert.from_jax_adam_state([np.asarray(x) for x in jax.tree.leaves(s_r)], "cpu")
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, target))
    losses = []
    for step in range(3):
        p_r, s_r, loss_r = ref.train_step_fused(p_r, s_r, opt_r, o, d, target)
        p_p, s_p, loss_p = port.train_step_fused(p_p, s_p, opt_p, ot, dt, tt)
        np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-6)
        got = convert.to_numpy({"params": p_p, "mu": s_p["mu"], "nu": s_p["nu"]})
        leaves = [np.asarray(x) for x in jax.tree.leaves(s_r)]
        assert int(s_p["count"]) == int(leaves[0]) == step + 1
        want = {"params": {k: np.asarray(v) for k, v in p_r.items()},
                "mu": dict(zip(("albedo", "logits"), leaves[1:3])),
                "nu": dict(zip(("albedo", "logits"), leaves[3:5]))}
        # Adam is sign-like: gradients an ulp apart move a param by an ulp of
        # the step; the moments carry the gradients' tolerance
        for k in ("albedo", "logits"):
            np.testing.assert_allclose(got["params"][k], want["params"][k], rtol=0, atol=5e-6)
            _close_grads(got["mu"][k], want["mu"][k])
            np.testing.assert_allclose(got["nu"][k], want["nu"][k], rtol=1e-3,
                                       atol=1e-6 * float(np.abs(want["nu"][k]).max()))
        losses.append(float(loss_p))
    assert losses[2] < losses[0]  # the steps fit the target
