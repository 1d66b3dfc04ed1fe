"""The port's native (C++) edit engine against the port's Python BoxTree.

The port's ``NativeEditTree`` (``voxelhex_tpu_torch/tree/native_edit.py``
over ``voxelhex_tpu_torch/host/tree_edit.cpp``) must match the port's
BoxTree voxel for voxel and structurally (node types, occupancy,
occlusion, brick contents) over randomized op sequences, as the reference's
``tests/test_native_edit.py`` holds the reference's engine to its tree;
and it must equal the reference's engine after the same ops.  The library
builds with g++ at first use; a failed build raises, so nothing here
skips.
"""

import os
import shutil

import numpy as np
import pytest

from voxelhex_tpu_torch import native
from voxelhex_tpu_torch.tree.boxtree import INTERNAL, LEAF, UNIFORM, Albedo, BoxTree, Entry
from voxelhex_tpu_torch.tree.native_edit import NativeEditTree


def _random_entry(rng):
    c = rng.integers(0, 256, 4)
    if rng.random() < 0.15:
        c[3] = 0  # a transparent color exercises the emptiness semantics
    return Albedo(*(int(v) for v in c))


def _random_ops(rng, n_ops, size, with_lod=True):
    """``n_ops`` seeded edits as ``(method, args)``, the reference test's mix."""
    ops = []
    for _ in range(n_ops):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        r = rng.random()
        if r < 0.45:
            ops.append(("insert", (p, _random_entry(rng))))
        elif r < 0.6:
            ops.append(("update", (p, _random_entry(rng))))
        elif r < 0.8 or not with_lod:
            ops.append(("clear", (p,)))
        elif r < 0.9:
            s = int(rng.choice([2, 4, 8]))
            ops.append(("insert_at_lod", (p, s, _random_entry(rng))))
        else:
            s = int(rng.choice([2, 4, 8]))
            ops.append(("clear_at_lod", (p, s)))
    return ops


def _apply_random_ops(rng, trees, n_ops, size, with_lod=True):
    for name, args in _random_ops(rng, n_ops, size, with_lod):
        for t in trees:
            getattr(t, name)(*args)


def _dense(tree, size):
    out = np.empty((size, size, size), dtype=np.uint32)
    for z in range(size):
        for y in range(size):
            for x in range(size):
                out[z, y, x] = tree.get_packed((x, y, z))
    return out


def _walk_compare(py, nat, py_key=0, nat_key=0, path=""):
    """Compare the two trees structurally from the root down."""
    pn = py.node(py_key)
    info = nat.node_info(nat_key)
    assert info is not None, f"native node missing at {path}"
    ntype, occupied, occlusion, children = info
    assert pn.ntype == ntype, (path, pn.ntype, ntype)
    assert pn.occupied == occupied, (path, hex(pn.occupied), hex(occupied))
    assert pn.occlusion == occlusion, (path, pn.occlusion, occlusion)
    if pn.ntype == INTERNAL:
        for s in range(64):
            pc = pn.child(s)
            nc = int(children[s])
            pv = py.key_is_valid(pc)
            nv = nc >= 0 and nat.node_info(nc) is not None
            assert pv == nv, (path, s, pc, nc)
            if pv:
                _walk_compare(py, nat, pc, nc, f"{path}/{s}")
    elif pn.ntype == LEAF:
        for s in range(64):
            _compare_brick(pn.bricks[s], nat.node_brick(nat_key, s), f"{path}[{s}]")
    elif pn.ntype == UNIFORM:
        _compare_brick(pn.bricks, nat.node_brick(nat_key, -1), f"{path}[U]")


def _compare_brick(pb, nb, path):
    if pb is None:
        assert nb is None, (path, nb)
    elif isinstance(pb, (int, np.integer)):
        assert isinstance(nb, int) and int(pb) == nb, (path, pb, nb)
    else:
        assert isinstance(nb, np.ndarray), (path, type(nb))
        np.testing.assert_array_equal(np.asarray(pb, dtype=np.uint32), nb, err_msg=path)


@pytest.mark.parametrize("size,brick,simplify", [
    (16, 4, False),
    (16, 4, True),
    (64, 4, True),
    (64, 16, True),
    (8, 2, True),
])
def test_differential_random_ops(size, brick, simplify):
    rng = np.random.default_rng(size * 31 + brick + simplify)
    py = BoxTree(size, brick, auto_simplify=simplify)
    nat = NativeEditTree(size, brick, auto_simplify=simplify)
    for _ in range(4 if size <= 16 else 2):
        _apply_random_ops(rng, (py, nat), 120, size)
        if size <= 16:
            np.testing.assert_array_equal(_dense(py, size), _dense(nat, size))
        else:
            for p in rng.integers(0, size, (400, 3)):
                pp = tuple(int(v) for v in p)
                assert py.get_packed(pp) == nat.get_packed(pp), pp
        assert py.node_count == nat.node_count
        _walk_compare(py, nat)


def test_differential_dense_fill_then_carve():
    """Solid fills and carving take the whole-node paths and simplify's
    collapse chains."""
    rng = np.random.default_rng(3)
    py = BoxTree(16, 4, auto_simplify=True)
    nat = NativeEditTree(16, 4, auto_simplify=True)
    red = Albedo(255, 0, 0, 255)
    py.insert_at_lod((0, 0, 0), 16, red)
    nat.insert_at_lod((0, 0, 0), 16, red)
    np.testing.assert_array_equal(_dense(py, 16), _dense(nat, 16))
    _walk_compare(py, nat)
    for _ in range(60):
        p = tuple(int(v) for v in rng.integers(0, 16, 3))
        py.clear(p)
        nat.clear(p)
    np.testing.assert_array_equal(_dense(py, 16), _dense(nat, 16))
    assert py.node_count == nat.node_count
    _walk_compare(py, nat)
    py.clear_at_lod((0, 0, 0), 16)
    nat.clear_at_lod((0, 0, 0), 16)
    np.testing.assert_array_equal(_dense(py, 16), _dense(nat, 16))
    _walk_compare(py, nat)


def test_update_merge_semantics():
    """update() keeps the entry components it is not given."""
    py = BoxTree(16, 4)
    nat = NativeEditTree(16, 4)
    for t in (py, nat):
        t.insert((3, 3, 3), Albedo(255, 0, 0, 255))
        t.update((3, 3, 3), Albedo(0, 0, 255, 255))
    assert py.get((3, 3, 3)).albedo == nat.get((3, 3, 3)).albedo
    np.testing.assert_array_equal(_dense(py, 16), _dense(nat, 16))


def test_last_access_matches_python_trigger_payload():
    """The engine reports the access stack depth and modified sectants that
    the Python tree hands to its update triggers."""
    py = BoxTree(64, 4)
    nat = NativeEditTree(64, 4)
    payloads = []
    py.update_triggers.append(lambda stack, sect: payloads.append((stack, sect)))
    red = Albedo(255, 0, 0, 255)
    py.insert((10, 20, 30), red)
    nat.insert((10, 20, 30), red)
    stack, sect = nat.last_access()
    assert len(payloads) == 1
    assert len(stack) == len([k for k, _s in payloads[0][0]])
    assert sorted(sect) == sorted(payloads[0][1])


def test_to_boxtree_round_trip_renders():
    """A natively edited tree converts to a BoxTree that flattens and
    renders as the same edits applied in Python do."""
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.tree.flat import flatten

    rng = np.random.default_rng(21)
    py = BoxTree(16, 4, auto_simplify=True)
    nat = NativeEditTree(16, 4, auto_simplify=True)
    _apply_random_ops(rng, (py, nat), 200, 16)
    conv = nat.to_boxtree()
    np.testing.assert_array_equal(_dense(py, 16), _dense(conv, 16))
    assert conv.node_count == py.node_count
    cam = orbit_camera(16.0, resolution=(32, 24))
    a, b = (fastest_renderer(flatten(t), device="cpu").render(cam, compact=False)
            for t in (py, conv))
    np.testing.assert_array_equal(a, b)
    assert (a != 0).any()


def test_from_boxtree_mirror_then_edit():
    """A Python tree mirrors into the engine (the same structure), and
    further edits stay in lockstep."""
    rng = np.random.default_rng(33)
    py = BoxTree(64, 4, auto_simplify=True)
    for _ in range(300):
        p = tuple(int(v) for v in rng.integers(0, 64, 3))
        py.insert(p, _random_entry(rng))
    nat = NativeEditTree.from_boxtree(py)
    assert nat.node_count == py.node_count
    _walk_compare(py, nat)
    _apply_random_ops(rng, (py, nat), 150, 64)
    assert nat.node_count == py.node_count
    _walk_compare(py, nat)
    for p in rng.integers(0, 64, (300, 3)):
        pp = tuple(int(v) for v in p)
        assert py.get_packed(pp) == nat.get_packed(pp)


def test_batch_ops_match_per_op():
    """Batched edits give the tree that per-op edits give."""
    rng = np.random.default_rng(44)
    n = 500
    pts = rng.integers(0, 64, (n, 3))
    cols = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    cols[rng.random(n) < 0.1, 3] = 0  # transparent: no-op inserts
    a = NativeEditTree(64, 4)
    b = NativeEditTree(64, 4)
    a.insert_batch(pts, cols)
    for p, c in zip(pts, cols):
        b.insert(tuple(int(v) for v in p), Albedo(*(int(v) for v in c)))
    assert a.node_count == b.node_count
    qry = rng.integers(0, 64, (800, 3))
    got = a.get_packed_batch(qry)
    for i, p in enumerate(qry):
        assert int(got[i]) == b.get_packed(tuple(int(v) for v in p))
    cpts = pts[: n // 2]
    a.clear_batch(cpts)
    for p in cpts:
        b.clear(tuple(int(v) for v in p))
    assert a.node_count == b.node_count
    got = a.get_packed_batch(qry)
    for i, p in enumerate(qry):
        assert int(got[i]) == b.get_packed(tuple(int(v) for v in p))


def test_batch_matches_python_tree():
    rng = np.random.default_rng(45)
    pts = rng.integers(0, 64, (400, 3))
    cols = rng.integers(1, 256, (400, 4)).astype(np.uint8)
    cols[:, 3] = 255
    nat = NativeEditTree(64, 4)
    nat.insert_batch(pts, cols)
    py = BoxTree(64, 4)
    for p, c in zip(pts, cols):
        py.insert(tuple(int(v) for v in p), Albedo(*(int(v) for v in c)))
    _walk_compare(py, nat)


def test_differential_with_user_data_entries():
    """Informative and complex voxels (the user-data palette) stay in
    lockstep: packed values carry a data index and emptiness consults the
    data table."""
    rng = np.random.default_rng(77)
    py = BoxTree(16, 4)
    nat = NativeEditTree(16, 4)
    for _ in range(200):
        p = tuple(int(v) for v in rng.integers(0, 16, 3))
        r = rng.random()
        if r < 0.3:
            e = Entry(albedo=_random_entry(rng), data=int(rng.integers(1, 50)))
        elif r < 0.6:
            e = Entry(data=int(rng.integers(1, 50)))
        elif r < 0.8:
            e = Entry(albedo=_random_entry(rng))
        else:
            py.clear(p)
            nat.clear(p)
            continue
        py.insert(p, e)
        nat.insert(p, e)
    np.testing.assert_array_equal(_dense(py, 16), _dense(nat, 16))
    _walk_compare(py, nat)
    for _ in range(50):
        p = tuple(int(v) for v in rng.integers(0, 16, 3))
        a, b = py.get(p), nat.get(p)
        assert a.albedo == b.albedo and a.data == b.data, p


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's engine module, its library built once into a
    directory of this module's own, so that no other process meets a
    half-written one."""
    from voxelhex_tpu.tree import native_edit

    mp = pytest.MonkeyPatch()
    mp.setattr(native_edit, "_SO", str(tmp_path_factory.mktemp("ref") / "libtree_edit.so"))
    mp.setattr(native_edit, "_LIB", None)
    mp.setattr(native_edit, "_TRIED", False)
    assert native_edit.available()
    yield native_edit
    mp.undo()


@pytest.mark.parametrize("size,brick,simplify", [(16, 4, False), (64, 4, True), (8, 2, True)])
def test_engine_equals_the_references_engine(size, brick, simplify, ref_native):
    """After the same ops, the port's engine and the reference's hold the
    same node infos and bricks in every slot, and report the same last
    access, op by op."""
    from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo

    rng = np.random.default_rng(size + brick * 7 + simplify)
    port = NativeEditTree(size, brick, auto_simplify=simplify)
    ref = ref_native.NativeEditTree(size, brick, auto_simplify=simplify)
    for name, args in _random_ops(rng, 300, size):
        getattr(port, name)(*args)
        getattr(ref, name)(*(RefAlbedo(a.r, a.g, a.b, a.a) if isinstance(a, Albedo) else a
                             for a in args))
        assert port.last_access() == ref.last_access(), (name, args)
    assert port.slot_count == ref.slot_count and port.node_count == ref.node_count
    for key in range(port.slot_count):
        a, b = port.node_info(key), ref.node_info(key)
        assert (a is None) == (b is None), key
        if a is None:
            continue
        assert a[:3] == b[:3], key
        np.testing.assert_array_equal(a[3], b[3])
        for s in range(-1, 64):
            pb, rb = port.node_brick(key, s), ref.node_brick(key, s)
            if isinstance(pb, np.ndarray):
                np.testing.assert_array_equal(pb, rb)
            else:
                assert pb == rb, (key, s)
    assert [(c.r, c.g, c.b, c.a) for c in port.color_palette] == \
        [(c.r, c.g, c.b, c.a) for c in ref.color_palette]


def test_a_broken_source_fails_the_build(monkeypatch, tmp_path):
    """A copy of ``tree_edit.cpp`` that does not compile fails the build with
    g++'s message, leaves no library behind, and no engine is made."""
    src = tmp_path / "tree_edit.cpp"
    shutil.copy(native.EDIT_SOURCE, src)
    with open(src, "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "EDIT_SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_edit_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ tree_edit.cpp failed"):
        NativeEditTree(16, 4)
    assert not os.listdir(os.path.dirname(native.library_path(str(src))))
