"""The port's soft renderer (plain versions, on the CPU) against the
reference's ``voxelhex_tpu.diff.soft`` on the CPU.

* The multi-hit march: counts and voxels exact against
  ``trace_hits_compacted`` (the reference's frame-scale path), on the bench
  scene and on grids of 2-4 levels.  Distances are exact too where the
  reference computes them in its 8-wide vector loop; rays that its
  compaction places in a remainder loop may differ by an ulp (see
  ``dists`` below).
* The composite and its gradient: within tolerances.  The reference's
  sigmoid uses XLA's own ``exp``, which rounds some inputs an ulp
  otherwise than PyTorch's, and the gradient's sums over rays run
  in another order (the reference scatters hit rows in order, the port
  adds per slot), so a gradient element matches to a relative 1e-4 of
  itself or 1e-6 of the largest element.  The loss is a mean over the same
  squared errors.

The training step end to end is ``tests/test_torch_soft_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
from voxelhex_tpu.render import bitgrid as refbg
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.diff.soft import SoftRenderer
from voxelhex_tpu_torch.render import bitgrid as portbg

RES = (160, 90)
CONST_TARGET = (0.25, 0.5, 0.75)


def _close_grads(got, want):
    """Gradient parity: relative 1e-4 of the element or 1e-6 of the largest
    one, and gradient on exactly the same elements."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.fixture(scope="module")
def bench_pair():
    import bench
    from voxelhex_tpu.render.camera import device_rays as ref_rays
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.scene import build_scene

    ref = RefSoft(flatten(bench.build_scene()), max_hits=2, max_iters=2048)
    port = SoftRenderer(build_scene(), max_hits=2, max_iters=2048, device="cpu")
    o, d = ref_rays(ref_orbit(128.0, yaw_deg=40, resolution=RES))
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    hits_ref = [np.asarray(x) for x in ref.trace_hits_compacted(jnp.asarray(o), jnp.asarray(d))]
    hits_port = port.trace_hits(torch.from_numpy(o.copy()), torch.from_numpy(d.copy()))
    return ref, port, o, d, hits_ref, hits_port


def test_multihit_bench_scene(bench_pair):
    _ref, _port, _o, _d, (c1, v1, d1), (c2, v2, d2) = bench_pair
    assert int((c1 == 2).sum()) > 1000 and int((c1 == 0).sum()) > 1000
    np.testing.assert_array_equal(c2.numpy(), c1)
    np.testing.assert_array_equal(v2.numpy(), v1)
    assert v2.dtype == torch.int32 and d2.dtype == torch.float32
    # the R = 14,400 rays run in the reference's vector loop: exact
    np.testing.assert_array_equal(d2.numpy(), d1)


@pytest.mark.parametrize("size,density", [(16, 0.05), (64, 0.02), (128, 0.01)])
def test_multihit_small_grids(size, density):
    """Grids of 2, 3 and 4 levels, random rays, K = 3."""
    rng = np.random.default_rng(size)
    occ = rng.random((size, size, size)) < density
    ref = RefSoft(refbg.bitgrid_from_occupancy(occ), max_hits=3)
    port = SoftRenderer(portbg.bitgrid_from_occupancy(occ), max_hits=3, device="cpu")
    n = 512
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    c1, v1, d1 = (np.asarray(x) for x in ref.trace_hits_compacted(jnp.asarray(o), jnp.asarray(d)))
    c2, v2, d2 = port.trace_hits(torch.from_numpy(o), torch.from_numpy(d))
    assert int((c1 >= 2).sum()) > 10
    np.testing.assert_array_equal(c2.numpy(), c1)
    np.testing.assert_array_equal(v2.numpy(), v1)
    # dists: an ulp where the reference's remainder loop fuses differently
    np.testing.assert_allclose(d2.numpy(), d1, rtol=2.4e-7, atol=0)


def _perturbed_params(ref, seed):
    rng = np.random.default_rng(seed)
    p = ref.init_params()
    alb = np.asarray(p["albedo"]) + rng.normal(0, 0.05, p["albedo"].shape)
    lg = np.asarray(p["logits"]) + rng.normal(0, 1.0, p["logits"].shape)
    return {"albedo": np.clip(alb, 0, 1).astype(np.float32), "logits": lg.astype(np.float32)}


def test_composite_forward(bench_pair):
    ref, port, _o, _d, (_c1, v1, _d1), (_c2, v2, _d2) = bench_pair
    p = _perturbed_params(ref, 0)
    want = np.asarray(ref.composite({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(v1)))
    got = port.composite(convert.from_jax_soft_params(p, "cpu"), v2).detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(want).max()) > 0.1
    # an ulp of the sigmoid moves an rgb value by about as much
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bg = (0.1, 0.2, 0.3)
    want = np.asarray(ref.composite({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(v1),
                                    bg_color=bg))
    got = port.composite(convert.from_jax_soft_params(p, "cpu"), v2, bg_color=bg).detach()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_grad_on_hits_constant_target(bench_pair):
    ref, port, o, _d, (c1, v1, _d1), (c2, v2, _d2) = bench_pair
    p = _perturbed_params(ref, 1)
    target = np.broadcast_to(np.float32(CONST_TARGET), (o.shape[0], 3)).copy()
    loss_r, g_r = ref.grad_on_hits({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(c1),
                                   jnp.asarray(v1), jnp.asarray(target))
    loss_p, g_p = port.grad_on_hits(convert.from_jax_soft_params(p, "cpu"), c2, v2,
                                    torch.from_numpy(target))
    # the same squared errors summed in another order
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-6)
    for k in ("albedo", "logits"):
        _close_grads(g_p[k].numpy(), np.asarray(g_r[k]))


def test_grad_on_hits_bench_target(bench_pair):
    """The bench's target is the stop-gradient composite of the initial
    params.  In the port the step's composite is the target's, so the loss
    and every gradient are exactly 0.  The reference's step program fuses
    the composite's multiply-adds otherwise than the target's, so its loss
    is only near 0."""
    ref, port, _o, _d, (c1, v1, _d1), (c2, v2, _d2) = bench_pair
    pr = ref.init_params()
    target_r = jax.lax.stop_gradient(ref.composite(pr, jnp.asarray(v1)))
    loss_r, g_r = ref.grad_on_hits(pr, jnp.asarray(c1), jnp.asarray(v1), target_r)
    pp = port.init_params()
    for k in pp:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(pr[k]))
    target_p = port.composite(pp, v2).detach()
    loss_p, g_p = port.grad_on_hits(pp, c2, v2, target_p)
    assert float(loss_p) == 0.0 and 0.0 <= float(loss_r) < 1e-12
    for k in ("albedo", "logits"):
        assert not g_p[k].numpy().any()
        assert float(np.abs(np.asarray(g_r[k])).max()) < 1e-9
