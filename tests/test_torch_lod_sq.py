"""The LOD frame kernel's stop table (``render/bitgrid.py`` ``lod_stop_sq``,
``csrc/frame.cu`` ``LodParams.stop_sq``) against the reference's stop level
run by JAX on the CPU: for every f32 squared distance ``s`` tried, the
number of entries at or below ``s`` is the reference's
clip(int(log2(max(fl(sqrt(s)) * lod_scale, 1)) * 0.5), 0, top), at every
entry and its neighbours, on random ``s`` over the whole f32 range, at 0,
+inf and NaN, at top levels 11, 2 and 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

TOP = 11
NEIGHBOURS = 2000

# the reference's stop level (make_bitgrid_tracer's lod branch) of squared
# distances s at an f32 scale, clipped to the deepest top level
_formula = jax.jit(lambda s, scale: jnp.clip(
    (jnp.log2(jnp.maximum(jnp.sqrt(s) * scale, 1.0)) * 0.5).astype(jnp.int32), 0, TOP))

F32_MAX = float(np.finfo(np.float32).max)
F32_TRUE_MIN = float(np.float32(np.finfo(np.float32).smallest_subnormal))


def _tried(stop, rng):
    """Each finite entry and its NEIGHBOURS f32 neighbours on either side
    within [0, inf], 200,000 random bit patterns of [0, inf], 0, +inf, NaN."""
    bits = [np.arange(-NEIGHBOURS, NEIGHBOURS + 1, dtype=np.int64)
            + int(np.float32(t).view(np.uint32)) for t in stop if not np.isnan(t)]
    bits.append(rng.integers(0, 0x7F800001, 200_000, dtype=np.int64))
    b = np.clip(np.concatenate(bits), 0, 0x7F800000).astype(np.uint32)
    edges = np.asarray([0.0, np.inf, np.nan], dtype=np.float32)
    return np.concatenate([b.view(np.float32), edges])


@pytest.mark.parametrize("scale", [0.3, 0.05, 0.04, 2.0, 1e-3, 123.456, float("inf"),
                                   F32_TRUE_MIN, F32_MAX])
def test_stop_table_equals_reference_formula(scale):
    """``s >= stop_sq[k]`` counted over k equals the reference's level on
    every tried ``s``, whatever the top level; at inf and the largest f32
    scale, s = 0 stops nowhere and the least normal s everywhere; the least
    subnormal scale counts as 0 on XLA:CPU, so nothing stops."""
    from voxelhex_tpu_torch.render.bitgrid import lod_stop_sq

    stop = np.asarray(lod_stop_sq(scale, TOP), dtype=np.float32)
    assert stop.shape == (TOP,)
    s = _tried(stop, np.random.default_rng(int(np.float32(scale).view(np.uint32))))
    want = np.asarray(_formula(s, np.float32(scale)))
    for top in (TOP, 2, 0):
        table = np.asarray(lod_stop_sq(scale, top), dtype=np.float32)
        np.testing.assert_array_equal(table, stop[:top])
        got = (s[:, None] >= table[None, :]).sum(axis=1)
        np.testing.assert_array_equal(got, np.minimum(want, top))
    if scale in (float("inf"), F32_MAX):
        assert (stop == np.float32(2.0**-126)).all()
    if scale == F32_TRUE_MIN:
        assert np.isnan(stop).all()


@pytest.mark.parametrize("scale", [0.0, -1.0, -F32_TRUE_MIN, float("nan")])
def test_stop_table_without_a_positive_scale_stops_nowhere(scale):
    """At a scale that is not above 0 the reference takes stop level 0 for
    every ray (its ``lod_scale > 0.0`` is false): every entry is NaN."""
    from voxelhex_tpu_torch.render.bitgrid import lod_stop_sq

    assert np.isnan(np.asarray(lod_stop_sq(scale, TOP))).all()
    assert lod_stop_sq(scale, 0) == ()
