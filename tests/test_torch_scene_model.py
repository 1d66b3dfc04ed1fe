"""The scene model into the renderers: the port's ``build_bitgrid`` (the
host library and the NumPy route) from a BoxTree and from a FlatTree
against the reference's, field for field, at worlds of 64, 128 (brick_dim
32) and 256; the tree-built bench scene against the painted one; and
``fastest_renderer`` and ``SoftRenderer`` over a tree (plain versions, on
the CPU) against the reference's frame and hits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhex_tpu.render import bitgrid as ref_bitgrid
from voxelhex_tpu.tree import build as ref_build
from voxelhex_tpu.tree import flat as ref_flat
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.render import bitgrid
from voxelhex_tpu_torch.tree import build, flat

FIELDS = ("size", "n_levels", "level_bases", "occ_lo", "occ_hi", "colors", "palette")
RES = (64, 36)


def content(size, seed):
    """Random voxels of a few colors, a solid block and a sheet."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, size, (3000, 3))
    cols = (rng.integers(1, 5, (3000, 4)) * 50).astype(np.uint8)
    cols[:, 3] = 255
    block = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x, z = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    sheet = np.stack([x.ravel(), np.full(size * size, 2), z.ravel()], axis=1)
    pts = np.concatenate([pts, block + size // 4, sheet])
    cols = np.concatenate([cols, np.tile(np.array([[9, 200, 9, 255]], np.uint8), (4096, 1)),
                           np.tile(np.array([[90, 90, 90, 255]], np.uint8), (size * size, 1))])
    return pts, cols


def assert_bitgrid_equal(got, want):
    for k in FIELDS:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("size,d", [(64, 4), (128, 32), (256, 4)])
def test_build_bitgrid_equals_reference(size, d):
    pts, cols = content(size, size + d)
    ref_tree = ref_build.from_voxels(pts, cols, size=size, brick_dim=d)
    tree = build.from_voxels(pts, cols, size=size, brick_dim=d)
    tree.clear_at_lod((0, 0, 0), d)  # a node that is no longer a whole brick
    ref_tree.clear_at_lod((0, 0, 0), d)
    want = ref_bitgrid.build_bitgrid(ref_tree)
    ref_flat_tree = ref_flat.flatten(ref_tree)
    port_flat = convert.from_jax_flat_tree(
        {k: getattr(ref_flat_tree, k) for k in ("size", "brick_dim") + flat.ARRAYS})
    for source in (tree, flat.flatten(tree), port_flat):
        for native in (True, False):
            if size == 256 and not native and source is not tree:
                continue  # the Python walk at 256 once is enough
            assert_bitgrid_equal(bitgrid.build_bitgrid(source, native=native), want)
    assert want.n_levels == len(bitgrid.level_dims(size, want.n_levels))


def test_bench_tree_equals_the_painted_scene():
    from voxelhex_tpu_torch.scene import build_scene, build_scene_tree

    tree = build_scene_tree(4)
    assert tree.size == 256 and tree.brick_dim == 4
    painted = build_scene()
    assert_bitgrid_equal(bitgrid.build_bitgrid(tree), painted)
    assert_bitgrid_equal(bitgrid.build_bitgrid(tree, native=False), painted)


def test_bench_tree_at_brick_dim_32_is_a_512_world():
    """``build_scene_tree(32)``: the bench content in a 512 world with a
    padded top level (the grids themselves are held on the card, in
    ``chip_smoke.py`` phase 10, where 512^3 fits)."""
    from voxelhex_tpu_torch.scene import build_scene_tree, scene_points

    tree = build_scene_tree(32)
    assert tree.size == 512 and tree.brick_dim == 32
    pts, cols = scene_points()
    ref = ref_build.from_voxels(pts, cols, size=512, brick_dim=32)
    from test_torch_tree import assert_flat_equal

    assert_flat_equal(ref, tree)
    assert bitgrid.level_dims(512, 5) == [128, 32, 8, 2, 1]


def test_flat_tree_fields_are_checked():
    ref_tree = ref_build.from_voxels(*content(64, 1), size=64, brick_dim=4)
    f = ref_flat.flatten(ref_tree)
    fields = {k: getattr(f, k) for k in ("size", "brick_dim") + flat.ARRAYS}
    with pytest.raises(KeyError, match="bricks"):
        convert.from_jax_flat_tree({k: v for k, v in fields.items() if k != "bricks"})
    with pytest.raises(ValueError, match="node_mips"):
        convert.from_jax_flat_tree(dict(fields, node_mips=f.node_mips[:-1]))
    with pytest.raises(TypeError, match="BoxTree or FlatTree"):
        bitgrid.build_bitgrid(fields)


@pytest.mark.parametrize("fault", ["node key", "brick descriptor", "below the voxel level"])
def test_malformed_flat_tree_raises_on_both_routes(fault):
    """A reference FlatTree carried across with a child key or brick index
    out of range, or a cycle of nodes, fails both rasterizers alike, where
    the host library once painted a wrong world."""
    f = ref_flat.flatten(ref_build.from_voxels(*content(64, 1), size=64, brick_dim=4))
    fields = {k: np.array(getattr(f, k)) for k in flat.ARRAYS}
    meta, children = fields["node_meta"], fields["node_children"]
    if fault == "node key":
        key = int(np.nonzero((meta == 0) & (children >= 0).any(axis=1))[0][-1])
        children[key, np.argmax(children[key] >= 0)] = len(meta) + 5
    elif fault == "brick descriptor":
        real = (children >= 0) & (children < flat.SOLID_FLAG) & (meta[:, None] == 1)
        key, s = (int(i[0]) for i in np.nonzero(real))
        children[key, s] = f.bricks.shape[0] + 3
    else:
        children[0, np.argmax(children[0] < 0)] = 0  # the root is its own child
    port_flat = convert.from_jax_flat_tree(dict(fields, size=f.size, brick_dim=f.brick_dim))
    for native in (True, False):
        with pytest.raises(ValueError, match=f"malformed FlatTree: .*{fault}"):
            bitgrid.build_bitgrid(port_flat, native=native)


@pytest.fixture(scope="module")
def trees():
    pts, cols = content(64, 5)
    return (ref_build.from_voxels(pts, cols, size=64, brick_dim=4),
            build.from_voxels(pts, cols, size=64, brick_dim=4))


def test_fastest_renderer_of_a_tree_equals_reference(trees):
    from voxelhex_tpu.render import fastest_renderer as ref_renderer
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    ref_tree, tree = trees
    want = np.asarray(ref_renderer(ref_tree).render(ref_orbit(64.0, resolution=RES),
                                                    out_u8=True))
    assert len(np.unique(want.reshape(-1, 3), axis=0)) > 3
    for source in (tree, flat.flatten(tree)):
        got = fastest_renderer(source, device="cpu").render(orbit_camera(64.0, resolution=RES),
                                                            out_u8=True)
        np.testing.assert_array_equal(got, want)


def test_soft_renderer_of_a_tree_equals_reference(trees):
    from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
    from voxelhex_tpu.render.camera import device_rays as ref_rays
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.diff.soft import SoftRenderer

    ref_tree, tree = trees
    ref = RefSoft(ref_tree, max_hits=2, max_iters=2048)
    port = SoftRenderer(tree, max_hits=2, max_iters=2048, device="cpu")
    o, d = ref_rays(ref_orbit(64.0, resolution=RES))
    o, d = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    c1, v1, _d1 = (np.asarray(x) for x in ref.trace_hits_compacted(jnp.asarray(o),
                                                                    jnp.asarray(d)))
    c2, v2, _d2 = port.trace_hits(torch.from_numpy(o.copy()), torch.from_numpy(d.copy()))
    assert int((c1 == 2).sum()) > 100
    np.testing.assert_array_equal(c2.numpy(), c1)
    np.testing.assert_array_equal(v2.numpy(), v1)


def test_terrain_points_equal_the_example(monkeypatch):
    """``terrain_points`` is ``examples/terrain.py``'s generator: the same
    voxels in the same order, into the same tree (at a 256 world here; the
    1024 world is ``chip_smoke.py`` phase 10's)."""
    import os
    import sys

    from test_torch_tree import assert_flat_equal

    from voxelhex_tpu_torch.scene import terrain_points

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
    try:
        import terrain
    finally:
        sys.path.pop(0)
    got, from_voxels = {}, ref_build.from_voxels

    def capture(pts, cols, **kw):
        got.update(pts=pts, cols=cols)
        return from_voxels(pts, cols, **kw)

    monkeypatch.setattr(ref_build, "from_voxels", capture)
    ref_tree = terrain.build_terrain(256)
    pts, cols = terrain_points(256)
    np.testing.assert_array_equal(pts, got["pts"])
    np.testing.assert_array_equal(cols, got["cols"])
    assert_flat_equal(ref_tree, build.from_voxels(pts, cols, size=256, brick_dim=4))
