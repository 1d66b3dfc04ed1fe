"""The port's bulk builder (``voxelhex_tpu_torch.tree.build``) against the
reference's: ``from_voxels`` and ``insert_many`` give the same flat arrays
(duplicates last wins, alpha 0 skipped, simplify on and off, into an
existing tree whose palette keeps its entries first), and the host
library's grouping equals the NumPy grouping, array for array."""

import numpy as np
import pytest
from test_torch_tree import assert_flat_equal, entry_key

from voxelhex_tpu.tree import build as ref_build
from voxelhex_tpu.tree.invariants import verify_invariants as ref_verify_invariants
from voxelhex_tpu_torch import native
from voxelhex_tpu_torch.constants import EMPTY_VOXEL
from voxelhex_tpu_torch.tree import build
from voxelhex_tpu_torch.tree.invariants import verify_invariants

SIZES = {1: 64, 2: 32, 4: 64, 8: 128, 32: 128}


def voxels(rng, size, n, n_colors=5):
    """``n`` random voxels with repeated positions and some alpha-0 colors,
    plus one solid 8^3 block."""
    pts = rng.integers(0, size, (n, 3))
    pts[n // 2:n // 2 + n // 8] = pts[:n // 8]  # duplicates: the later ones win
    cols = (rng.integers(0, n_colors, (n, 4)) * 60).astype(np.uint8)
    cols[rng.random(n) < 0.1, 3] = 0
    block = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([pts, block + size // 2])
    cols = np.concatenate([cols, np.tile(np.array([[7, 8, 9, 255]], np.uint8), (512, 1))])
    return pts, cols


@pytest.mark.parametrize("d", sorted(SIZES))
@pytest.mark.parametrize("simplify", [True, False])
def test_from_voxels_equals_reference(d, simplify):
    size = SIZES[d]
    pts, cols = voxels(np.random.default_rng(d), size, 3000)
    ref = ref_build.from_voxels(pts, cols, size=size, brick_dim=d, simplify=simplify)
    for nat in (True, False):
        port = build.from_voxels(pts, cols, size=size, brick_dim=d, simplify=simplify,
                                 native=nat)
        assert_flat_equal(ref, port)
        assert port.node_count == ref.node_count
        # brick_dim 1 keeps the reference's stale occupancy bits for voxels
        # whose color has alpha 0 (see test_duplicates_and_alpha_zero)
        assert verify_invariants(port) == ref_verify_invariants(ref)
    for p in map(tuple, pts[::7].tolist()):
        assert entry_key(port.get(p)) == entry_key(ref.get(p)), p


def test_duplicates_and_alpha_zero():
    """The last of equal positions wins; an all-zero RGBA is skipped; a color
    with alpha 0 is interned as the reference interns it, transparent, and
    renders empty."""
    from voxelhex_tpu.render.bitgrid import build_bitgrid as ref_build_bitgrid
    from voxelhex_tpu_torch.render.bitgrid import build_bitgrid

    pts = np.array([[1, 1, 1], [1, 1, 1], [2, 2, 2], [9, 9, 9], [2, 2, 2], [3, 3, 3]])
    cols = np.array([[255, 0, 0, 255], [0, 255, 0, 255], [1, 2, 3, 255], [4, 4, 4, 255],
                     [0, 0, 0, 0], [5, 5, 5, 0]], dtype=np.uint8)
    for d in (1, 4):
        ref = ref_build.from_voxels(pts, cols, size=16 * d, brick_dim=d)
        for nat in (True, False):
            port = build.from_voxels(pts, cols, size=16 * d, brick_dim=d, native=nat)
            assert_flat_equal(ref, port)
            got = [entry_key(port.get(tuple(p))) for p in pts]
            assert got == [entry_key(ref.get(tuple(p))) for p in pts]
            assert got[0] == got[1] == ((0, 255, 0, 255), None)
            assert got[2] == ((1, 2, 3, 255), None)  # the all-zero write is skipped
            # interned, transparent, first in the palette's u32 order
            assert (port.color_palette[0].r, port.color_palette[0].a) == (5, 0)
            bg = build_bitgrid(port)
            np.testing.assert_array_equal(bg.colors, ref_build_bitgrid(ref).colors)
            assert bg.colors[3 + 3 * bg.size + 3 * bg.size**2] == 0xFFFF


def test_from_voxels_into_a_tree_keeps_its_palette_first():
    from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo
    from voxelhex_tpu.tree.boxtree import BoxTree as RefTree
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree

    pts, cols = voxels(np.random.default_rng(9), 64, 1000)
    ref, port = RefTree(64, 4), BoxTree(64, 4)
    ref.insert((1, 2, 3), RefAlbedo(250, 1, 1, 255))
    port.insert((1, 2, 3), Albedo(250, 1, 1, 255))
    ref_build.from_voxels(pts, cols, size=64, tree=ref)
    build.from_voxels(pts, cols, size=64, tree=port)
    assert port.color_palette[0] == Albedo(250, 1, 1, 255)
    assert_flat_equal(ref, port)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_insert_many_equals_reference(d):
    size = SIZES[d]
    rng = np.random.default_rng(30 + d)
    pts, cols = voxels(rng, size, 1500)
    ref = ref_build.from_voxels(pts[:700], cols[:700], size=size, brick_dim=d)
    port = build.from_voxels(pts[:700], cols[:700], size=size, brick_dim=d)
    more_pts, more_cols = voxels(rng, size, 800, n_colors=7)
    assert build.insert_many(port, more_pts, more_cols) == ref_build.insert_many(
        ref, more_pts, more_cols)
    assert_flat_equal(ref, port)
    assert verify_invariants(port) == []
    # into an empty tree, into one with a node below brick size (the
    # per-voxel path), and nothing to write
    from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo
    from voxelhex_tpu.tree.boxtree import BoxTree as RefTree
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree

    r, p = RefTree(size, d), BoxTree(size, d)
    assert build.insert_many(p, more_pts, more_cols) == ref_build.insert_many(
        r, more_pts, more_cols)
    assert_flat_equal(r, p)
    r, p = RefTree(size, d, auto_simplify=False), BoxTree(size, d, auto_simplify=False)
    r.insert_at_lod((0, 0, 0), 4 * d, RefAlbedo(9, 9, 9, 255))
    p.insert_at_lod((0, 0, 0), 4 * d, Albedo(9, 9, 9, 255))
    r.insert((1, 0, 0), RefAlbedo(8, 9, 9, 255))
    p.insert((1, 0, 0), Albedo(8, 9, 9, 255))
    assert build.insert_many(p, more_pts, more_cols) == ref_build.insert_many(
        r, more_pts, more_cols)
    assert_flat_equal(r, p)
    assert build.insert_many(p, np.zeros((0, 3)), np.zeros((0, 4))) == 0


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_native_grouping_equals_numpy(d):
    """The library's ``bulk_group`` against the same grouping in NumPy."""
    size = SIZES[d]
    rng = np.random.default_rng(50 + d)
    pts = rng.integers(0, size, (5000, 3))
    pts[2500:3000] = pts[:500]
    packed = rng.integers(0, 6, 5000).astype(np.uint32)
    packed[:64] = 3  # some bricks may fill with one value
    cells, bricks, occ, solid = native.bulk_group(pts, packed, size, d, EMPTY_VOXEL)

    lin = pts[:, 0] + pts[:, 1] * size + pts[:, 2] * size * size
    _, first = np.unique(lin[::-1], return_index=True)
    sel = len(lin) - 1 - first
    p, v = pts[sel], packed[sel]
    cpa = size // d
    cell_id = (p // d) @ np.array([1, cpa, cpa * cpa])
    want_cells, inv = np.unique(cell_id, return_inverse=True)
    want = np.full((len(want_cells), d**3), EMPTY_VOXEL, dtype=np.uint32)
    want[inv, (p % d) @ np.array([1, d, d * d])] = v
    from voxelhex_tpu_torch.spatial.math import brick_occupied_bits_many

    np.testing.assert_array_equal(cells, want_cells)
    np.testing.assert_array_equal(bricks, want)
    np.testing.assert_array_equal(occ, brick_occupied_bits_many(want != EMPTY_VOXEL))
    np.testing.assert_array_equal(solid, (want == want[:, :1]).all(axis=1))
    with pytest.raises(ValueError, match="out of bounds"):
        native.bulk_group(pts + size, packed, size, d, EMPTY_VOXEL)
