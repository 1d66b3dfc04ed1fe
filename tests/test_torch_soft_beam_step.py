"""The port's training steps with the beam prepass (plain versions, on the
CPU) against the reference's ``SoftRenderer.train_step_fused`` and
``train_steps_fused`` with ``optax.adam(0.05)``, from the same params and
Adam state, at ``tests/test_torch_soft_step.py``'s tolerances.  The scene,
camera and rays are ``test_torch_soft_beam.py``'s."""

import jax
import numpy as np
import optax
import torch

from test_torch_soft_beam import camera_pair, one_thread, pair, rays  # noqa: F401
from voxelhex_tpu_torch import convert


def test_training_steps_with_beam_equal_reference(pair):
    """One ``train_step_fused`` and a chain of four (one beam launch for the
    chain) with the beam, from the same params and Adam state."""
    from voxelhex_tpu_torch.diff.optim import adam

    ref, port = pair
    ref_cam, cam = camera_pair()
    o, d = rays(ref_cam)
    target = np.random.default_rng(3).random(o.shape).astype(np.float32)
    opt_r = optax.adam(0.05)
    p_r = ref.init_params()
    s_r = opt_r.init(p_r)
    opt_p = adam(0.05)
    p_p = convert.from_jax_soft_params({k: np.asarray(v) for k, v in p_r.items()}, "cpu")
    s_p = convert.from_jax_adam_state([np.asarray(x) for x in jax.tree.leaves(s_r)], "cpu")
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, target))
    spec_r, spec_p = ref.beam_spec(ref_cam), port.beam_spec(cam)
    p_r, s_r, loss_r = ref.train_step_fused(p_r, s_r, opt_r, o, d, target, beam=spec_r)
    p_p, s_p, loss_p = port.train_step_fused(p_p, s_p, opt_p, ot, dt, tt, beam=spec_p)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-6)
    p_r, s_r, losses_r = ref.train_steps_fused(p_r, s_r, opt_r, o, d, target, 4, beam=spec_r)
    p_p, s_p, losses_p = port.train_steps_fused(p_p, s_p, opt_p, ot, dt, tt, 4, beam=spec_p)
    np.testing.assert_allclose(losses_p.numpy(), np.asarray(losses_r), rtol=1e-6)
    assert int(s_p["count"]) == 5
    for k in ("albedo", "logits"):
        np.testing.assert_allclose(p_p[k].numpy(), np.asarray(p_r[k]), rtol=0, atol=5e-6)
    assert float(losses_p[-1]) < float(loss_p)
