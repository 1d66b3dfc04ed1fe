"""The port's plain tracer against the reference's ``make_bitgrid_tracer``.

Exact on all five outputs.  One caveat is the reference's, and the last
test pins it: XLA:CPU computes a ray's entry point in an 8-wide vector loop
that fuses the multiply-add on x and y but not on z, and the rays of the
scalar remainder loop (the last ``R % 8``) with all three fused.  The port
follows the vector loop, so ``point`` is bit-equal for every ray when R is
a multiple of 8, and for all but the last ``R % 8`` rays otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhex_tpu.render import bitgrid as ref
from voxelhex_tpu_torch.render import bitgrid as port

NAMES = ("hit", "voxel", "hvox", "point", "hnormal")


def _rays(n, size, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    t = rng.uniform(0, size, (n, 3)).astype(np.float32)
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _both(bg_ref, bg_port, o, d, **cfg):
    jt = ref.make_bitgrid_tracer(bg_ref, **cfg)
    a = [np.asarray(x) for x in jax.jit(jt)(ref.device_bitgrid(bg_ref), jnp.asarray(o),
                                             jnp.asarray(d))]
    pt = port.make_bitgrid_tracer(bg_port.n_levels, bg_port.size, **cfg)
    b = [x.numpy() for x in pt(port.device_bitgrid(bg_port, device="cpu"),
                               torch.from_numpy(o), torch.from_numpy(d))]
    return a, b


@pytest.fixture(scope="module")
def grid64():
    occ = np.random.default_rng(0).random((64, 64, 64)) < 0.02
    return ref.bitgrid_from_occupancy(occ), port.bitgrid_from_occupancy(occ)


@pytest.fixture(scope="module")
def bench_scene():
    import bench
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.scene import build_scene

    return ref.build_bitgrid(flatten(bench.build_scene())), build_scene()


@pytest.mark.parametrize("substeps", [2, 4])
@pytest.mark.parametrize("lateral", [True, False])
def test_random_grid_exact(grid64, substeps, lateral):
    o, d = _rays(4000, 64, 1)
    a, b = _both(*grid64, o, d, lateral_step=lateral, advance_substeps=substeps)
    assert a[0].sum() > 1000  # the grid is hit
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("substeps", [2, 4])
@pytest.mark.parametrize("lateral", [True, False])
def test_bench_scene_160x90_exact(bench_scene, substeps, lateral):
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera

    o, d = device_rays(orbit_camera(128.0, resolution=(160, 90)), device="cpu")
    a, b = _both(*bench_scene, o.numpy(), d.numpy(), lateral_step=lateral,
                 advance_substeps=substeps)
    assert a[0].sum() > 2000
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_iteration_cap_and_remainder_rays(grid64):
    """``max_iters`` stops rays mid-march exactly where the reference does;
    with R = 8k + 3 the last 3 entry points are the reference's scalar loop."""
    o, d = _rays(4003, 64, 2)
    a, b = _both(*grid64, o, d, max_iters=7, advance_substeps=4)
    for name, x, y in zip(NAMES, a, b):
        if name == "point":
            np.testing.assert_array_equal(x[:4000], y[:4000], err_msg=name)
            np.testing.assert_allclose(x[4000:], y[4000:], rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)
