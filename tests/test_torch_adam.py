"""The port's optimizer step (plain version, on the CPU) against the
reference's step tail on the CPU: ``SoftRenderer._finish_step_fn`` with
``optax.adam(0.05)``, that is the opacity-L1 term, optax's update and the
param clamps as one XLA program.

On equal gradients the update is bit-exact: the port computes optax's Adam
in the order XLA:CPU compiles it (``csrc/adam.cu``).  With the L1 term the
logits' gradient holds a sigmoid, whose ``exp`` XLA rounds otherwise than
PyTorch for some inputs, by an ulp; Adam's step is then equal to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
from voxelhex_tpu.render import bitgrid as refbg
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.diff.optim import adam
from voxelhex_tpu_torch.diff.soft import CLAMPS

S = 16


@pytest.fixture(scope="module")
def ref():
    occ = np.random.default_rng(0).random((S, S, S)) < 0.1
    return RefSoft(refbg.bitgrid_from_occupancy(occ), max_hits=2)


def _inputs(seed, count):
    """Params (some outside the clamps after a step), gradients (some zero)
    and an Adam state ``count`` steps in."""
    rng = np.random.default_rng(seed)
    n = S**3
    params = {"albedo": rng.uniform(-0.02, 1.02, 3 * n).astype(np.float32),
              "logits": rng.uniform(-12.03, 12.03, n).astype(np.float32)}
    grads = {k: (rng.normal(0, 1e-4, v.shape) * (rng.random(v.shape) < 0.7)).astype(np.float32)
             for k, v in params.items()}
    mu = {k: rng.normal(0, 1e-4, v.shape).astype(np.float32) for k, v in params.items()}
    nu = {k: (rng.random(v.shape) * 1e-8).astype(np.float32) for k, v in params.items()}
    opt = optax.adam(0.05)
    state = opt.init({k: jnp.asarray(v) for k, v in params.items()})
    state = (state[0]._replace(count=jnp.int32(count),
                               mu={k: jnp.asarray(v) for k, v in mu.items()},
                               nu={k: jnp.asarray(v) for k, v in nu.items()}),) + state[1:]
    return opt, params, grads, state


@pytest.mark.parametrize("fit_albedo", [True, False])
@pytest.mark.parametrize("opacity_l1", [0.0, 0.1])
@pytest.mark.parametrize("count", [0, 7])
def test_adam_update_matches_optax(ref, fit_albedo, opacity_l1, count):
    opt, params, grads, state = _inputs(count + 3, count)
    fin = ref._finish_step_fn(opt, opacity_l1, fit_albedo)
    p_r, s_r, loss_r = fin({k: jnp.asarray(v) for k, v in params.items()}, state,
                           jnp.float32(0.0), {k: jnp.asarray(v) for k, v in grads.items()})
    leaves = [np.asarray(x) for x in jax.tree.leaves(s_r)]

    p_p = convert.from_jax_soft_params(params, "cpu")
    s_p = convert.from_jax_adam_state([np.asarray(x) for x in jax.tree.leaves(state)], "cpu")
    g_p = {k: torch.from_numpy(v) for k, v in grads.items()}
    if not fit_albedo:
        g_p["albedo"] = None  # zeros, as the reference passes them
    p_p, s_p = adam(0.05).update(g_p, s_p, p_p, opacity_l1=opacity_l1, clamps=CLAMPS)

    assert int(s_p["count"]) == int(leaves[0]) == count + 1
    got = [p_p["albedo"], p_p["logits"], s_p["mu"]["albedo"], s_p["mu"]["logits"],
           s_p["nu"]["albedo"], s_p["nu"]["logits"]]
    want = [np.asarray(p_r["albedo"]), np.asarray(p_r["logits"])] + leaves[1:]
    assert float(want[0].min()) == 0.0 and float(want[1].max()) == 12.0  # clamps bite
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy()
        if opacity_l1 and i in (1, 3, 5):  # the logits group holds the L1 sigmoid
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    if opacity_l1:
        l1 = opacity_l1 * torch.mean(torch.sigmoid(torch.from_numpy(params["logits"])))
        np.testing.assert_allclose(float(l1), float(loss_r), rtol=1e-6)
