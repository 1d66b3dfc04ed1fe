"""The port's frames (plain versions, on the CPU) against the reference
renderer's, bit for bit."""

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
    b = port.render(orbit_camera(128.0, yaw_deg=yaw, resolution=RES), out_u8=True).numpy()
    assert b.dtype == np.uint8 and b.shape == (RES[1], RES[0], 3)
    assert len(np.unique(b.reshape(-1, 3), axis=0)) > 50  # a real picture
    np.testing.assert_array_equal(a, b)


def test_render_f32_matches_reference(renderers):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    ref, port = renderers
    a = np.asarray(ref.render(ref_orbit(128.0, resolution=RES), compact=False))
    b = port.render(orbit_camera(128.0, resolution=RES), bg=(0.0, 0.0, 0.0),
                    out_u8=False).numpy()
    assert b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
