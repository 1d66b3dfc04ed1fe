"""The port's splat prepass (plain versions, on the CPU) against the
reference renderer's, bit for bit: ``splat_start`` and the splat frames in
u8 (and f32 on one orbit) on the cases of the reference's
``test_splat_prepass_exact`` (an orbit, a close-up and cameras inside the
scene) and a distant camera whose splats are reliable.  Odd resolutions
and the reference's stale-centers trap are in ``test_torch_splat_edit.py``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

RES = (64, 48)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the plain renderers: their many small ops run
    faster so, and do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_scene(package, size=64, seed=9):
    """The reference's ``tests/test_bitgrid.py`` ``make_scene(64, 4)`` in
    the reference's (``voxelhex_tpu``) or the port's (``voxelhex_tpu_torch``)
    BoxTree."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    red, green = boxtree.Albedo(255, 0, 0, 255), boxtree.Albedo(0, 255, 0, 255)
    tree = boxtree.BoxTree(size, 4, auto_simplify=False)
    rng = np.random.default_rng(seed)
    for _ in range(size * size):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        tree.insert(p, red if rng.random() < 0.5 else green)
    tree.insert_at_lod((8, 8, 8), 4, green)
    return tree


def camera_pairs():
    """The same cameras in both packages: ``test_splat_prepass_exact``'s
    orbit, close-up and four cameras inside the scene, and an orbit at 3
    times the distance."""
    from voxelhex_tpu.render.camera import Camera as RefCamera
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import Camera, orbit_camera

    out = [(ref_orbit(64.0, distance_factor=f, resolution=RES),
            orbit_camera(64.0, distance_factor=f, resolution=RES)) for f in (1.8, 0.5, 3.0)]
    rng = np.random.default_rng(5)
    for _ in range(4):
        o, t = rng.random(3) * 64.0, rng.random(3) * 64.0
        out.append((RefCamera(origin=o, target=t, resolution=RES),
                    Camera(origin=o, target=t, resolution=RES)))
    return out


@pytest.fixture(scope="module")
def renderers():
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    return (BitGridRenderer(make_scene("voxelhex_tpu")),
            fastest_renderer(make_scene("voxelhex_tpu_torch"), device="cpu"))


def test_splat_points_equal_reference(renderers):
    ref, port = renderers
    np.testing.assert_array_equal(port._splat_points().numpy(), np.asarray(ref._splat_points()))


@pytest.mark.parametrize("case", range(7))
def test_splat_start_and_frames_equal_reference(renderers, case):
    """``splat_start`` bit for bit, and the frames in u8 (and f32 for the
    first orbit)."""
    ref, port = renderers
    ref_cam, cam = camera_pairs()[case]
    want = np.asarray(ref.splat_start(ref_cam))
    got = port.splat_start(cam)
    assert got.dtype == torch.float32 and got.shape == (RES[0] * RES[1],)
    np.testing.assert_array_equal(got.numpy(), want)
    if case in (0, 2):  # texels that splats reached, and texels that they did not
        assert (want > 0).any() and (want == 0).any()
    for out_u8 in (True, False) if case == 0 else (True,):
        frame = port.render(cam, out_u8=out_u8, splat_prepass=True)
        assert port.last_stats["prepass"] == "splat"
        np.testing.assert_array_equal(
            frame, np.asarray(ref.render(ref_cam, out_u8=out_u8, splat_prepass=True)))
