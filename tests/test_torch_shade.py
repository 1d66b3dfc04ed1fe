"""The port's plain shading against the reference's ``_shade`` (exact) and
the Pallas shading kernel in interpret mode (float sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhex_tpu.ops.shade_pallas import pallas_shade
from voxelhex_tpu.render.jax_renderer import _shade
from voxelhex_tpu_torch.constants import NO_COLOR_HIT
from voxelhex_tpu_torch.ops.shade import shade, shade_plain
from voxelhex_tpu_torch.render.shade import to_u8

BG = (0.1, 0.2, 0.3)


def _data(R, P, seed):
    """Inputs on which the reference's and the Pallas kernel's color gates
    agree: voxels in [0, P), NO_COLOR_HIT or -1."""
    rng = np.random.default_rng(seed)
    hit = rng.random(R) < 0.6
    voxel = rng.integers(0, P, R).astype(np.int32)
    voxel[rng.random(R) < 0.1] = NO_COLOR_HIT
    voxel[rng.random(R) < 0.05] = -1
    normal = rng.normal(size=(R, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    axis = rng.random(R) < 0.5  # the tracer's normals are mostly axis-aligned
    normal[axis] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, axis.sum())] * rng.choice(
        [-1, 1], (axis.sum(), 1)).astype(np.float32)
    palette = rng.random((P, 4)).astype(np.float32)
    return hit, voxel, normal, palette


def _port(hit, voxel, normal, palette, out_u8):
    return shade(torch.from_numpy(hit), torch.from_numpy(voxel), torch.from_numpy(normal),
                 torch.from_numpy(palette), BG, out_u8=out_u8).numpy()


@pytest.mark.parametrize("R,P", [(3000, 200), (1025, 16425)])
def test_shade_matches_reference_exactly(R, P):
    hit, voxel, normal, palette = _data(R, P, R)
    ref = _shade({"palette": jnp.asarray(palette)}, jnp.asarray(hit), jnp.asarray(voxel),
                 jnp.asarray(normal), jnp.asarray(BG, dtype=jnp.float32))
    ref_u8 = jnp.clip(jnp.round(ref * 255.0), 0.0, 255.0).astype(jnp.uint8)
    np.testing.assert_array_equal(_port(hit, voxel, normal, palette, False), np.asarray(ref))
    np.testing.assert_array_equal(_port(hit, voxel, normal, palette, True), np.asarray(ref_u8))


def test_shade_matches_pallas_kernel():
    hit, voxel, normal, palette = _data(3000, 200, 5)
    ref = pallas_shade(jnp.asarray(hit), jnp.asarray(voxel), jnp.asarray(normal),
                       jnp.asarray(palette), jnp.asarray(BG, dtype=jnp.float32), interpret=True)
    np.testing.assert_allclose(_port(hit, voxel, normal, palette, False), np.asarray(ref),
                               atol=1e-6)


def test_u8_rounds_half_to_even_and_clips():
    rgb = torch.tensor([[0.5 / 255, 1.5 / 255, 2.5 / 255], [-0.2, 1.7, float("nan")]],
                       dtype=torch.float32)
    ref = jnp.clip(jnp.round(jnp.asarray(rgb.numpy()) * 255.0), 0.0, 255.0).astype(jnp.uint8)
    np.testing.assert_array_equal(to_u8(rgb).numpy(), np.asarray(ref))


def test_wrapper_runs_plain_version_on_cpu():
    hit, voxel, normal, palette = _data(500, 30, 9)
    args = [torch.from_numpy(a) for a in (hit, voxel, normal, palette)]
    np.testing.assert_array_equal(shade(*args, BG).numpy(), shade_plain(*args, BG).numpy())
    with pytest.raises(ValueError):
        shade(*[a.to("meta") for a in args], BG)
