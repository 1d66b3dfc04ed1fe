"""The port's counterparts of the reference's smaller public names against
the reference: ``Camera.view_matrix`` / ``projection_matrix``,
``Viewport.left_brick_slot`` / ``update_matrices``, ``CubeSides``,
``brick_slot_for`` and ``BitGridRenderer.resolve_entries``.
(``FarField.cells`` / ``renderer`` are in ``test_torch_far_field.py``.)"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

POSES = [((80.0, 60.0, -40.0), (32.0, 32.0, 32.0), 50.0, (64, 48)),
         ((3.5, 200.0, 7.25), (3.5, 0.0, 7.0), 70.0, (1920, 1080)),
         ((-10.0, 5.0, 300.0), (100.0, 5.0, 0.0), 35.0, (33, 77))]


def camera_pair(eye, target, fov, res):
    from voxelhex_tpu.render.camera import Camera as RefCamera
    from voxelhex_tpu_torch.render.camera import Camera

    eye, target = np.asarray(eye), np.asarray(target)
    return (RefCamera(origin=eye, target=target, fov_y_deg=fov, resolution=res),
            Camera(origin=eye, target=target, fov_y_deg=fov, resolution=res))


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_camera_matrices_equal_reference(pose):
    ref, cam = camera_pair(*POSES[pose])
    for a, b in ((ref.view_matrix(), cam.view_matrix()),
                 (ref.projection_matrix(), cam.projection_matrix()),
                 (ref.projection_matrix(0.5, 100.0), cam.projection_matrix(0.5, 100.0))):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_viewport_equals_reference(pose):
    """``left_brick_slot`` after each of a walk of moves (with the origin
    taken between some), and ``update_matrices`` at each step."""
    from voxelhex_tpu.render.camera import Viewport as RefViewport
    from voxelhex_tpu_torch.render.camera import Viewport

    ref_cam, cam = camera_pair(*POSES[pose])
    ref, port = RefViewport(ref_cam), Viewport(cam)
    rng = np.random.default_rng(pose)
    answers = []
    for step in range(24):
        delta = (rng.normal(size=3) * 1.5).astype(np.float32)
        for v in (ref, port):
            v.move_viewport(delta)
        if step % 5 == 4:
            for v in (ref, port):
                v.set_viewport_origin(v.origin + np.float32(0.5))
        for brick_dim in (1, 4, 32):
            a, b = ref.left_brick_slot(brick_dim), port.left_brick_slot(brick_dim)
            assert a == b
            answers.append(a)
        for a, b in zip(ref.update_matrices(), port.update_matrices()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if step % 3 == 2:
            assert np.array_equal(ref.take_origin_delta(), port.take_origin_delta())
    assert any(answers) and not all(answers)


def test_spatial_names_equal_reference():
    from voxelhex_tpu.spatial import math as ref_math
    from voxelhex_tpu_torch.spatial import math

    for side in ("BACK", "FRONT", "TOP", "BOTTOM", "LEFT", "RIGHT"):
        assert getattr(math.CubeSides, side) == getattr(ref_math.CubeSides, side)
    rng = np.random.default_rng(4)
    for p in list(rng.normal(size=(40, 3)) * 50) + [np.zeros(3), np.array([-4.0, 4.0, -0.5])]:
        for brick_dim in (1, 4, 32):
            (a, sa), (b, sb) = ref_math.brick_slot_for(p, brick_dim), math.brick_slot_for(p,
                                                                                           brick_dim)
            assert sa == sb and a.dtype == b.dtype and np.array_equal(a, b)


def test_resolve_entries_equals_reference():
    """Hits resolved to the host tree's entries (color and user data), a
    colorless data voxel and a miss included, from the port's trace on
    the CPU, as the reference resolves its own trace's."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer as RefRenderer
    from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo
    from voxelhex_tpu.tree.boxtree import BoxTree as RefBoxTree
    from voxelhex_tpu.tree.boxtree import Entry as RefEntry
    from voxelhex_tpu_torch.render.renderer import BitGridRenderer
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree, Entry

    trees = []
    for tree_cls, entry, albedo in ((RefBoxTree, RefEntry, RefAlbedo), (BoxTree, Entry, Albedo)):
        tree = tree_cls(16, 4, auto_simplify=False)
        tree.insert((2, 3, 4), entry(albedo=albedo.from_u32(0xFF0000FF), data=42))
        tree.insert((5, 3, 4), entry(data=7))
        tree.insert((9, 3, 4), albedo.from_u32(0x00FF00FF))
        trees.append(tree)
    o = np.array([[2.5, 3.5, -3.0], [5.5, 3.5, -3.0], [9.5, 3.5, -3.0], [12.5, 3.5, -3.0],
                  [2.5, 3.5, 20.0], [5.5, 3.5, 20.0], [9.5, 13.5, -3.0], [9.5, 3.5, 20.0]],
                 dtype=np.float32)
    d = np.tile(np.array([[0, 0, 1.0]], dtype=np.float32), (8, 1))
    d[4:6, 2] = -1.0
    d[7, 2] = -1.0
    ref = RefRenderer(trees[0])
    hit, _v, hvox, _p, _n = ref.trace(o, d)
    want = ref.resolve_entries(trees[0], hit, hvox)
    port = BitGridRenderer(trees[1], device="cpu")
    hit, _v, hvox, _p, _n = port.trace(torch.from_numpy(o), torch.from_numpy(d))
    got = port.resolve_entries(trees[1], hit, hvox)
    assert [e is None for e in got] == [e is None for e in want] == [False] * 3 + [True] + \
        [False] * 2 + [True, False]
    for a, b in zip(want, got):
        if a is not None:
            assert a.data == b.data
            assert (a.albedo is None) == (b.albedo is None)
            if a.albedo is not None:
                assert (a.albedo.r, a.albedo.g, a.albedo.b, a.albedo.a) == \
                    (b.albedo.r, b.albedo.g, b.albedo.b, b.albedo.a)
