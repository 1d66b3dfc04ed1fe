"""The port's boxtree (``voxelhex_tpu_torch.tree``) against the reference's
(``voxelhex_tpu.tree``): seeded random sequences of ``insert``,
``insert_at_lod``, ``update``, ``clear`` and ``clear_at_lod`` run on both
trees, at brick_dim 1, 2, 4, 8 and 32; every ``flatten`` array equal,
``get`` equal at sampled points, and the port's invariants after every step
report what the reference's report on its tree: nothing, except where the
reference itself breaks one (brick_dim 1 without auto-simplify: an
``insert_at_lod`` that covers part of a node marks all of it occupied,
which the port keeps, so that the two trees stay equal).  MIP maps (``enable_mips``, ``recalculate_mips`` and the texels an
edit updates) equal the reference's under each resampling method."""

import numpy as np
import pytest

from voxelhex_tpu.tree import boxtree as ref_bt
from voxelhex_tpu.tree import flat as ref_flat
from voxelhex_tpu.tree import mipmap as ref_mip
from voxelhex_tpu.tree.invariants import verify_invariants as ref_verify_invariants
from voxelhex_tpu_torch.tree import boxtree as bt
from voxelhex_tpu_torch.tree import flat as port_flat
from voxelhex_tpu_torch.tree import mipmap as mip
from voxelhex_tpu_torch.tree.invariants import verify_invariants

# brick_dim -> world size: the smallest brick_dim * 4**k of at least 32
SIZES = {1: 64, 2: 32, 4: 64, 8: 128, 32: 128}
OPS = 40


def assert_flat_equal(ref_tree, port_tree):
    a, b = ref_flat.flatten(ref_tree), port_flat.flatten(port_tree)
    assert (a.size, a.brick_dim) == (b.size, b.brick_dim)
    for k in port_flat.ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def entry_key(e):
    """An Entry of either package as plain values."""
    a = e.albedo
    return (None if a is None else (a.r, a.g, a.b, a.a), e.data)


def random_ops(rng, size, d, n):
    """``n`` edits as ``(method, position, lod, rgba or data)``."""
    lods = sorted({1, 2, 4, d, 2 * d} - {0})
    ops = []
    for _ in range(n):
        kind = ["insert", "insert_at_lod", "update", "clear", "clear_at_lod", "data"][
            int(rng.integers(0, 6))]
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        lod = int(rng.choice(lods))
        value = (int(rng.integers(0, 4)) * 60, int(rng.integers(1, 3)) * 100, 50,
                 int(rng.choice([0, 255, 255, 255])))
        if kind == "data":
            value = int(rng.integers(0, 3))
        ops.append((kind, p, lod, value))
    return ops


def apply(tree, module, op):
    kind, p, lod, value = op
    if kind == "data":
        tree.insert(p, module.Entry(data=value))
    elif kind in ("insert", "update"):
        getattr(tree, kind)(p, module.Albedo(*value))
    elif kind == "insert_at_lod":
        tree.insert_at_lod(p, lod, module.Albedo(*value))
    elif kind == "clear":
        tree.clear(p)
    else:
        tree.clear_at_lod(p, lod)


@pytest.mark.parametrize("d", sorted(SIZES))
@pytest.mark.parametrize("seed", [0, 1])
def test_random_edits_equal_reference(d, seed):
    size = SIZES[d]
    rng = np.random.default_rng(seed * 100 + d)
    simplify = bool(seed == 0)
    ref = ref_bt.BoxTree(size, d, auto_simplify=simplify)
    port = bt.BoxTree(size, d, auto_simplify=simplify)
    broken = 0
    for i, op in enumerate(random_ops(rng, size, d, OPS)):
        apply(ref, ref_bt, op)
        apply(port, bt, op)
        problems = verify_invariants(port)
        assert problems == ref_verify_invariants(ref), (i, op)
        broken += bool(problems)
        if i % 10 == 9:
            assert_flat_equal(ref, port)
    assert_flat_equal(ref, port)
    assert port.node_count == ref.node_count
    assert broken == 0 or (d, simplify) == (1, False)
    pts = rng.integers(0, size, (200, 3))
    for p in map(tuple, pts.tolist()):
        assert entry_key(port.get(p)) == entry_key(ref.get(p)), p
        assert port.get_packed(p) == ref.get_packed(p), p


def test_simplify_collapses_a_filled_node():
    ref = ref_bt.BoxTree(64, 4, auto_simplify=False)
    port = bt.BoxTree(64, 4, auto_simplify=False)
    for tree, m in ((ref, ref_bt), (port, bt)):
        tree.insert_at_lod((0, 0, 0), 16, m.Albedo(10, 20, 30, 255))
        tree.insert((3, 3, 3), m.Albedo(10, 20, 30, 255))
    assert_flat_equal(ref, port)
    assert port.simplify(port.ROOT, recursive=True) == ref.simplify(ref.ROOT, recursive=True)
    assert_flat_equal(ref, port)
    assert verify_invariants(port) == []


def test_update_triggers_see_the_references_paths():
    seen = {"ref": [], "port": []}
    ref, port = ref_bt.BoxTree(64, 4), bt.BoxTree(64, 4)
    ref.update_triggers.append(lambda stack, sects: seen["ref"].append((list(stack), sects)))
    port.update_triggers.append(lambda stack, sects: seen["port"].append((list(stack), sects)))
    for op in random_ops(np.random.default_rng(5), 64, 4, 12):
        apply(ref, ref_bt, op)
        apply(port, bt, op)
    assert seen["port"] == seen["ref"] and seen["port"]


def test_occlusion_bits_equal_reference():
    """Filled neighbours set each other's occlusion bits; a clear drops them."""
    ref, port = ref_bt.BoxTree(64, 4), bt.BoxTree(64, 4)
    for tree, m in ((ref, ref_bt), (port, bt)):
        for x in (0, 16):
            tree.insert_at_lod((x, 0, 0), 16, m.Albedo(200, 10, 10, 255))
    occl = [n.occlusion for n in port._nodes if n is not None]
    assert any(occl)
    assert occl == [n.occlusion for n in ref._nodes if n is not None]
    for tree in (ref, port):
        tree.clear_at_lod((16, 0, 0), 4)
    assert [n.occlusion for n in port._nodes if n is not None] == [
        n.occlusion for n in ref._nodes if n is not None]
    assert verify_invariants(port) == []


METHODS = ["box", "point", "point_bd", "posterize", "posterize_bd"]


@pytest.mark.parametrize("method", METHODS)
def test_mips_equal_reference(method):
    """``enable_mips`` over a built tree, then edits that update texels, and
    ``recalculate_mips``: the same MIP bricks and palette."""
    rng = np.random.default_rng(7)
    size, d = 32, 2
    pts = rng.integers(0, size, (400, 3))
    cols = (rng.integers(1, 5, (400, 4)) * 50).astype(np.uint8)
    cols[:, 3] = 255
    from voxelhex_tpu.tree.build import from_voxels as ref_from_voxels
    from voxelhex_tpu_torch.tree.build import from_voxels

    ref = ref_from_voxels(pts, cols, size=size, brick_dim=d)
    port = from_voxels(pts, cols, size=size, brick_dim=d)
    thr = 0.1 if method.startswith("posterize") else None
    strategies = []
    for m in (ref_mip, mip):
        s = m.MIPStrategy(enabled=True)
        for level in range(1, 5):
            s.set_method(level, method, thr)
        s.set_similarity(1, 0.05)
        strategies.append(s)
    ref_mip.enable_mips(ref, strategies[0])
    mip.enable_mips(port, strategies[1])
    assert_flat_equal(ref, port)
    assert int((port_flat.flatten(port).node_mips >= 0).sum()) > 1
    for op in random_ops(rng, size, d, 8):
        apply(ref, ref_bt, op)
        apply(port, bt, op)
    assert_flat_equal(ref, port)
    ref_mip.recalculate_mips(ref)
    mip.recalculate_mips(port)
    assert_flat_equal(ref, port)
    for s in (0, 5, 64):
        assert entry_key(mip.sample_root_mip(port, s, (1, 0, 1))) == entry_key(
            ref_mip.sample_root_mip(ref, s, (1, 0, 1)))


def test_spatial_helpers_equal_reference():
    from voxelhex_tpu.spatial import luts as ref_luts
    from voxelhex_tpu.spatial import math as ref_math
    from voxelhex_tpu_torch.spatial import luts, math

    rng = np.random.default_rng(3)
    for d in (1, 2, 4, 8, 32):
        masks = rng.random((16, d**3)) < 0.05
        np.testing.assert_array_equal(math.brick_occupied_bits_many(masks),
                                      ref_math.brick_occupied_bits_many(masks))
        for m in masks[:3]:
            assert math.brick_occupied_bits(m) == ref_math.brick_occupied_bits(m)
    for _ in range(50):
        off = rng.random(3) * 64
        size = float(rng.choice([4.0, 16.0, 64.0]))
        s = int(rng.integers(0, 64))
        assert math.offset_sectant(off, size) == ref_math.offset_sectant(off, size)
        np.testing.assert_array_equal(math.sectant_offset(s), ref_math.sectant_offset(s))
        assert math.flat_projection(s, 3, 5, 8) == ref_math.flat_projection(s, 3, 5, 8)
        assert math.cube_contains(off, size, off + 1) == ref_math.cube_contains(
            off, size, off + 1)
        for a, b in zip(math.child_bounds_for(off, size, s),
                        ref_math.child_bounds_for(off, size, s)):
            np.testing.assert_array_equal(a, b)
        pos = rng.integers(0, 64, 3)
        np.testing.assert_array_equal(math.matrix_index_for(off, size, pos, 4),
                                      ref_math.matrix_index_for(off, size, pos, 4))
        bits = int(rng.integers(0, 2**62))
        args = (pos % 8, int(rng.integers(1, 4)), 8, bool(rng.integers(0, 2)), bits)
        assert math.set_occupied_bits(*args) == ref_math.set_occupied_bits(*args)
    for name in ("SECTANT_OFFSET_LUT", "SECTANT_STEP_RESULT_LUT",
                 "RAY_TO_NODE_OCCUPANCY_BITMASK_LUT"):
        np.testing.assert_array_equal(getattr(luts, name), getattr(ref_luts, name))
    for a, b in zip(luts.ray_occupancy_masks_u32(), ref_luts.ray_occupancy_masks_u32()):
        np.testing.assert_array_equal(a, b)
