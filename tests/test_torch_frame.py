"""The frame kernel's launch parameters, and the renderer's path through
``render_frame``, on the CPU: the parameters carry the camera params bit for
bit, and the frame equals the reference package's one-dispatch u8 frame."""

import numpy as np
import pytest

RES = (160, 90)  # R % 8 == 0, see ROADMAP.md queue 3


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("yaw,res", [(40.0, (1920, 1080)), (130.0, (333, 187)),
                                     (250.0, (160, 90))])
def test_frame_params_carry_camera_params(yaw, res):
    from voxelhex_tpu_torch.ops.frame import frame_params
    from voxelhex_tpu_torch.ops.traverse import MAX_ITERS, trace_params
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.camera import camera_params, orbit_camera, pixel_steps

    occ = np.random.default_rng(0).random((64, 64, 64)) < 0.02
    tree = device_bitgrid(bitgrid_from_occupancy(occ), "cpu")
    cam = orbit_camera(128.0, yaw_deg=yaw, resolution=res)
    bg = (0.1, 0.2, 0.3)
    p = frame_params(tree, cam, bg)
    origin, right, up, forward, scale = camera_params(cam)
    for name, want in (("origin", origin), ("right", right), ("up", up),
                       ("forward", forward), ("scale", scale)):
        np.testing.assert_array_equal(_bits(list(getattr(p, name))), _bits(want), err_msg=name)
    np.testing.assert_array_equal(_bits([p.cw, p.ch]), _bits(pixel_steps(*res)))
    np.testing.assert_array_equal(_bits(list(p.bg)), _bits(bg))
    assert (p.w, p.h) == res
    assert bytes(p.trace) == bytes(trace_params(tree, MAX_ITERS))
    assert p.trace.n_levels == 3 and list(p.trace.dims)[:3] == tree["dims"]


def test_render_goes_through_render_frame(monkeypatch):
    import bench
    from voxelhex_tpu.render import fastest_renderer as ref_renderer
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render import renderer as renderer_module
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    calls = []
    real = renderer_module.render_frame

    def spy(tree, camera, *args):
        calls.append(camera.resolution)
        return real(tree, camera, *args)

    monkeypatch.setattr(renderer_module, "render_frame", spy)
    port = fastest_renderer(build_scene(), device="cpu")
    b = port.render(orbit_camera(128.0, resolution=RES), out_u8=True).numpy()
    assert calls == [RES]
    ref = ref_renderer(flatten(bench.build_scene()), fuse_plan=True)
    a = np.asarray(ref.render(ref_orbit(128.0, resolution=RES), out_u8=True))
    assert b.dtype == np.uint8 and b.shape == (RES[1], RES[0], 3)
    np.testing.assert_array_equal(a, b)
