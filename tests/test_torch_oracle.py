"""The port's scalar ground-truth tracer (``render/oracle.py``), its ray
helpers (``spatial/math.py``) and frame meters (``utils/profiling.py``)
against the reference's, on the CPU: ``get_by_ray`` bit for bit (hit,
voxel, point, normal) on random rays of ``tests/test_oracle.py``'s scenes
built in both packages, and against the stored hits of
``tests/goldens/bench_rays.npz`` (400 rays of the bench scene, points
within the goldens' 1e-4); each helper on random inputs; ``FrameStats``
and ``timed_frame``."""

import os
import time
import zlib

import numpy as np
import pytest

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "bench_rays.npz")


def _scenes(package):
    """``test_oracle.py``'s trees in ``package``: the random scenes of
    brick_dim 1, 2 and 4, the solid uniform tree, the parted brick in a
    uniform leaf and the multi-level tree."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    flat = importlib.import_module(f"{package}.tree.flat")
    red, green, blue = (boxtree.Albedo.from_u32(c) for c in (0xFF0000FF, 0x00FF00FF,
                                                            0x0000FFFF))
    out = []
    for dim in (1, 2, 4):
        size = 4 * dim
        rng = np.random.default_rng(7 + dim)
        tree = boxtree.BoxTree(size, dim, auto_simplify=False)
        for _ in range(size**2):
            p = tuple(int(v) for v in rng.integers(0, size, 3))
            tree.insert(p, (red, green, blue)[rng.integers(0, 3)])
        out.append(tree)
    tree = boxtree.BoxTree(16, 4, auto_simplify=False)
    tree.insert_at_lod((0, 0, 0), 16, green)
    out.append(tree)
    tree = boxtree.BoxTree(16, 4, auto_simplify=True)
    tree.insert_at_lod((0, 0, 0), 8, blue)
    tree.insert((9, 9, 9), red)
    out.append(tree)
    tree = boxtree.BoxTree(16, 4, auto_simplify=False)
    tree.insert_at_lod((0, 0, 0), 4, red)
    tree.insert((9, 1, 1), green)
    out.append(tree)
    return [flat.flatten(t) for t in out]


def _rays(size, n, rng):
    """Rays aimed at random points of the world from outside it, and from
    inside it."""
    target = rng.random((n, 3)) * size
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    start = np.where(rng.random((n, 1)) < 0.8, target - d * (2.0 * size), rng.random((n, 3))
                     * size)
    return start.astype(np.float32), d.astype(np.float32)


def _same(a, b):
    """Two oracle results equal: both None, or the same voxel and the same
    point and normal bits."""
    if a is None or b is None:
        return a is None and b is None
    return (a.voxel == b.voxel and np.array_equal(a.point, b.point)
            and np.array_equal(a.normal, b.normal))


def test_get_by_ray_equals_reference():
    from voxelhex_tpu.render.oracle import get_by_ray as ref_get
    from voxelhex_tpu_torch.render.oracle import get_by_ray

    rng = np.random.default_rng(31)
    n_hit = 0
    for ref_flat, flat in zip(_scenes("voxelhex_tpu"), _scenes("voxelhex_tpu_torch")):
        origins, dirs = _rays(flat.size, 150, rng)
        for o, d in zip(origins, dirs):
            want, got = ref_get(ref_flat, o, d), get_by_ray(flat, o, d)
            assert _same(got, want), (o, d)
            n_hit += got is not None
            if got is not None:
                np.testing.assert_array_equal(got.albedo(flat), want.albedo(ref_flat))
                assert got.has_color == want.has_color
    assert n_hit > 300


def test_get_by_ray_bench_goldens():
    """The bench tree (the port's ``build_scene_tree(4)``, the reference's
    bench tree) against the stored hits of 400 rays: hit and voxel exact,
    the point within the goldens' 1e-4."""
    from voxelhex_tpu_torch.render.oracle import get_by_ray
    from voxelhex_tpu_torch.scene import build_scene_tree
    from voxelhex_tpu_torch.tree.flat import flatten

    flat = flatten(build_scene_tree(4))
    g = np.load(GOLD)
    assert int(g["hit"].sum()) > 100
    for i, (o, d) in enumerate(zip(g["origins"], g["dirs"])):
        h = get_by_ray(flat, o, d)
        assert (h is not None) == bool(g["hit"][i]), i
        if h is not None:
            assert h.voxel == int(g["voxel"][i]), i
            np.testing.assert_allclose(h.point, g["point"][i], atol=1e-4, err_msg=str(i))


@pytest.mark.parametrize("name", ["step_sectant", "hash_direction", "octant_in_sectant",
                                  "intersect_ray_aabb", "cube_impact_normal",
                                  "dda_scale_factors", "dda_step_to_next_sibling",
                                  "convert_coordinate", "plane_line_intersection"])
def test_ray_helpers_equal_reference(name):
    """Each helper on 300 random inputs (axis-parallel directions, zero
    components and points on faces among them) returns the reference's
    values, bit for bit."""
    from voxelhex_tpu.spatial import math as ref_math
    from voxelhex_tpu_torch.spatial import math as port_math

    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def vec():
        v = rng.normal(size=3).astype(np.float32)
        zero = rng.random(3) < 0.2
        zero[rng.integers(0, 3)] = False  # not all three
        v[zero] = 0.0
        return v

    systems = ("Lzup", "Lyup", "Rzup", "Ryup")
    for _ in range(300):
        d, p = vec(), (rng.random(3) * 16).astype(np.float32)
        args = {
            "step_sectant": (int(rng.integers(0, 64)), np.sign(vec())),
            "hash_direction": (d,),
            "octant_in_sectant": (int(rng.integers(0, 64)),),
            "intersect_ray_aabb": (p - 8 * d, d, np.zeros(3, np.float32), 16.0),
            "cube_impact_normal": (np.floor(p), 1.0, p),
            "dda_scale_factors": (d,),
            "dda_step_to_next_sibling": (d, p, np.floor(p), 1.0,
                                         ref_math.dda_scale_factors(d)),
            "convert_coordinate": (rng.normal(size=(4, 3)), systems[rng.integers(0, 4)],
                                   systems[rng.integers(0, 4)]),
            "plane_line_intersection": (p, d, np.zeros(3, np.float32), vec()),
        }[name]
        with np.errstate(all="ignore"):
            want = getattr(ref_math, name)(*args)
            got = getattr(port_math, name)(*args)
        if isinstance(want, tuple):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="coordinate system"):
        port_math.convert_coordinate(np.zeros(3), "Xyup", "Lyup")


def test_frame_stats_and_timed_frame(tmp_path):
    """The meters keep the reference's rolling window and its summary;
    ``device_trace`` writes a Chrome trace of the block."""
    import torch
    from voxelhex_tpu.utils.profiling import FrameStats as RefStats
    from voxelhex_tpu_torch.utils.profiling import FrameStats, device_trace, timed_frame

    stats, ref = FrameStats(window=3), RefStats(window=3)
    assert stats.summary() == "no frames recorded" and stats.fps == 0.0
    for s, n in [(0.5, 100), (0.25, 200), (0.125, 300), (0.5, 400)]:
        stats.record(s, n)
        ref.record(s, n)
        assert (stats.fps, stats.rays_per_sec, stats.summary()) == (ref.fps, ref.rays_per_sec,
                                                                    ref.summary())
    assert stats.times == [0.25, 0.125, 0.5] and stats.rays == [200, 300, 400]
    with timed_frame(stats, 7):
        time.sleep(0.01)
    assert stats.rays[-1] == 7 and stats.times[-1] >= 0.01 and len(stats.times) == 3
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert prof.key_averages() is not None
