"""The port's splat prepass where it departs from a straight splat frame:
at an odd resolution (the plain frame, as the reference's), and after an
edit, where the reference's stale-centers trap shows (its splat prepass
starts rays from the old surface).  On one wall in a 64 world, apart from
``test_torch_splat.py``'s scene, so that each file stays cheap."""

import numpy as np
import pytest

from test_torch_splat import RES, one_thread  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")


def wall_scene(package):
    """A 64 world holding one wall (z in [48, 52)), in the reference's
    (``voxelhex_tpu``) or the port's (``voxelhex_tpu_torch``) BoxTree."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    tree = boxtree.BoxTree(64, 4, auto_simplify=False)
    for x in range(0, 64, 4):
        for y in range(0, 64, 4):
            tree.insert_at_lod((x, y, 48), 4, boxtree.Albedo(200, 200, 200, 255))
    return tree


def test_splat_needs_an_even_resolution():
    """At an odd resolution ``render`` gives the plain frame, as the
    reference's; ``splat_start`` raises."""
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    port = fastest_renderer(wall_scene("voxelhex_tpu_torch"), device="cpu")
    cam = orbit_camera(64.0, resolution=(63, 48))
    frame = port.render(cam, out_u8=True, splat_prepass=True)
    assert port.last_stats["prepass"] is None
    np.testing.assert_array_equal(frame, port.render(cam, out_u8=True))
    assert (frame > 0).any()  # the wall shows
    with pytest.raises(ValueError, match="even resolution"):
        port.splat_start(cam)


def edit(renderer, tree, build_bitgrid, device_bitgrid, **kw):
    """The reference's edit pattern: swap the BitGrid and its device tree in,
    then ``invalidate_beam``."""
    renderer.bitgrid = build_bitgrid(tree)
    renderer.tree = device_bitgrid(renderer.bitgrid, **kw)
    renderer.invalidate_beam()


def test_splat_after_an_edit():
    """A splat frame of the wall, then a block inserted in front of it and
    the splat frame again: the reference's ``invalidate_beam`` keeps its
    splat centers, so its rays start at the old wall and the block does not
    show; the port drops them with the content, and its splat frame is the
    plain frame, the block in it."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer, build_bitgrid, device_bitgrid
    from voxelhex_tpu.render.camera import Camera as RefCamera
    from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo
    from voxelhex_tpu_torch.render import bitgrid as port_bitgrid
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import Camera
    from voxelhex_tpu_torch.tree.boxtree import Albedo

    ref_tree, tree = wall_scene("voxelhex_tpu"), wall_scene("voxelhex_tpu_torch")
    ref, port = BitGridRenderer(ref_tree), fastest_renderer(tree, device="cpu")
    eye, target = np.array([32.0, 32.0, -40.0]), np.array([32.0, 32.0, 32.0])
    ref_cam = RefCamera(origin=eye, target=target, resolution=RES)
    cam = Camera(origin=eye, target=target, resolution=RES)
    wall = port.render(cam, out_u8=True, splat_prepass=True)
    np.testing.assert_array_equal(
        wall, np.asarray(ref.render(ref_cam, out_u8=True, splat_prepass=True)))
    ref_tree.insert_at_lod((24, 24, 8), 8, RefAlbedo(0, 0, 255, 255))
    tree.insert_at_lod((24, 24, 8), 8, Albedo(0, 0, 255, 255))
    edit(ref, ref_tree, build_bitgrid, device_bitgrid)
    edit(port, tree, port_bitgrid.build_bitgrid, port_bitgrid.device_bitgrid, device="cpu")
    ref_splat = np.asarray(ref.render(ref_cam, out_u8=True, splat_prepass=True))
    got = port.render(cam, out_u8=True, splat_prepass=True)
    plain = port.render(cam, out_u8=True)
    np.testing.assert_array_equal(got, plain)
    blue = (plain[..., 2] > 0) & (plain[..., 0] == 0)
    assert blue.sum() > 16  # the block shows in the plain frame
    # and not in the reference's splat frame, which is the wall's there
    assert ((ref_splat != plain).any(axis=-1) & blue).sum() == blue.sum()
    np.testing.assert_array_equal(ref_splat[blue], wall[blue])
