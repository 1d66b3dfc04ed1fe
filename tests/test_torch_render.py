"""The port's frames (plain versions, on the CPU) against the reference
renderer's, bit for bit, and the reference's keywords and defaults of
``fastest_renderer`` and ``render``."""

import numpy as np
import pytest

RES = (160, 90)


@pytest.fixture(scope="module")
def renderers():
    import bench
    from voxelhex_tpu.render import fastest_renderer as ref_renderer
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.scene import build_scene

    return (ref_renderer(flatten(bench.build_scene()), fuse_plan=True),
            fastest_renderer(build_scene(), device="cpu"))


@pytest.mark.parametrize("yaw", [40.0, 130.0, 250.0])
def test_render_u8_bit_identical(renderers, yaw):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    ref, port = renderers
    a = np.asarray(ref.render(ref_orbit(128.0, yaw_deg=yaw, resolution=RES), out_u8=True))
    b = port.render(orbit_camera(128.0, yaw_deg=yaw, resolution=RES), out_u8=True)
    assert b.dtype == np.uint8 and b.shape == (RES[1], RES[0], 3)
    assert len(np.unique(b.reshape(-1, 3), axis=0)) > 50  # a real picture
    np.testing.assert_array_equal(a, b)


def test_render_f32_matches_reference(renderers):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    ref, port = renderers
    a = np.asarray(ref.render(ref_orbit(128.0, resolution=RES), compact=False))
    b = port.render(orbit_camera(128.0, resolution=RES), bg=(0.0, 0.0, 0.0),
                    out_u8=False)
    assert b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _small():
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy

    return bitgrid_from_occupancy(np.random.default_rng(0).random((32, 32, 32)) < 0.05)


def test_render_defaults_are_the_references():
    """f32 and a NumPy array by default; u8 and the device tensor on request;
    ``compact`` and ``defer_validation`` change nothing."""
    import torch

    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    r = fastest_renderer(_small(), device="cpu", fuse_plan=True)
    cam = orbit_camera(32.0, resolution=(40, 24))
    f = r.render(cam)
    assert isinstance(f, np.ndarray) and f.dtype == np.float32 and f.shape == (24, 40, 3)
    t = r.render(cam, out_u8=True, out_device=True)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), r.render(cam, out_u8=True, compact=False,
                                                      defer_validation=True))
    assert len(np.unique(f.reshape(-1, 3), axis=0)) > 2
    for kw in ({"beam_prepass": True}, {"splat_prepass": True}):
        with pytest.raises(NotImplementedError, match="queue 1 items 3 and 11"):
            r.render(cam, **kw)


def test_fastest_renderer_takes_the_references_keywords():
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    bg = _small()
    cam = orbit_camera(32.0, resolution=(40, 24))
    want = fastest_renderer(bg, device="cpu").render(cam)
    neutral = dict(fuse_plan=True, auto_plan=True, prepass=False, lateral_step=True,
                   advance_substeps=4, tracer="stack", parent_skip=False, color_u8=False,
                   prepass_levels=2, skip_substeps=3)
    np.testing.assert_array_equal(fastest_renderer(bg, device="cpu", **neutral).render(cam), want)
    # max_iters is the kernels' step limit: one step reaches no voxel
    short = fastest_renderer(bg, device="cpu", max_iters=1).render(cam)
    assert not short.any() and want.any()
    for kw in ({"prepass": True}, {"lateral_step": False}, {"advance_substeps": 2},
               {"tracer": "skip"}, {"parent_skip": True}, {"color_u8": True}):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            fastest_renderer(bg, device="cpu", **kw)
    with pytest.raises(TypeError, match="unexpected keyword"):
        fastest_renderer(bg, device="cpu", lod_bias=1)


def test_fastest_renderer_rejects_trees():
    """The reference package's trees are not the port's: they cross by
    bencode bytes or ``convert.from_jax_flat_tree`` (the port's own trees
    render, ``test_torch_scene_model.py``)."""
    from voxelhex_tpu.tree.boxtree import BoxTree
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.render import fastest_renderer

    tree = BoxTree(16, 4)
    for source in (tree, flatten(tree)):
        with pytest.raises(TypeError, match="BitGrid, BoxTree or FlatTree"):
            fastest_renderer(source, device="cpu")
