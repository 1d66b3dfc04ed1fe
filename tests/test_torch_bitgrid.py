"""Port BitGrid data (pyramid packing, the benchmark scene, conversion)
against the reference's, bit for bit."""

import numpy as np
import pytest

from voxelhex_tpu.render import bitgrid as ref
from voxelhex_tpu_torch.convert import FIELDS, from_jax_bitgrid
from voxelhex_tpu_torch.render import bitgrid as port


def _occ(size, seed, density=0.05):
    return np.random.default_rng(seed).random((size, size, size)) < density


@pytest.mark.parametrize("size", [16, 64])
def test_pack_pyramid_bit_equal(size):
    occ = _occ(size, size)
    a_lo, a_hi, a_bases = ref._pack_pyramid(occ)
    b_lo, b_hi, b_bases = port._pack_pyramid(occ)
    np.testing.assert_array_equal(a_bases, b_bases)
    assert len(a_lo) == len(b_lo)
    for x, y in zip(a_lo + a_hi, b_lo + b_hi):
        assert x.dtype == y.dtype == np.uint32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("size", [16, 64])
def test_bitgrid_from_occupancy_bit_equal(size):
    occ = _occ(size, size + 1)
    a = ref.bitgrid_from_occupancy(occ)
    b = port.bitgrid_from_occupancy(occ)
    assert (a.size, a.n_levels) == (b.size, b.n_levels)
    for k in ("level_bases", "occ_lo", "occ_hi", "colors", "palette"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert port.level_dims(b.size, b.n_levels) == [
        max((size // 4**(lv + 1)), 1) for lv in range(b.n_levels)
    ]


def test_from_jax_bitgrid_round_trip():
    a = ref.bitgrid_from_occupancy(_occ(64, 3), palette=np.random.default_rng(3).random((5, 4)))
    b = from_jax_bitgrid({k: getattr(a, k) for k in FIELDS})
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
    tree = port.device_bitgrid(b, device="cpu")
    pairs = tree["occ_pairs"].numpy().view(np.uint32)
    np.testing.assert_array_equal(pairs[:, 0], a.occ_lo)
    np.testing.assert_array_equal(pairs[:, 1], a.occ_hi)
    np.testing.assert_array_equal(tree["colors"].numpy().view(np.uint16), a.colors)
    with pytest.raises(KeyError):
        from_jax_bitgrid({"size": 64})


def test_bench_scene_bit_equal():
    """The port paints the benchmark scene straight into the dense grids;
    the reference goes through its boxtree.  Same pyramid, same color
    indices, same palette order."""
    import bench
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.scene import build_scene

    a = ref.build_bitgrid(flatten(bench.build_scene()))
    b = build_scene()
    assert (a.size, a.n_levels) == (b.size, b.n_levels) == (256, 4)
    assert b.palette.shape == (16425, 4)
    for k in ("level_bases", "occ_lo", "occ_hi", "colors", "palette"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
