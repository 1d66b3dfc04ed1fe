"""The port's beam prepass (plain versions, on the CPU) against the
reference renderer's, bit for bit: ``beam_start`` at beam levels 1 and 2,
the beam frames of ``render``, ``render_many`` and ``render_delta_many``
in u8 and f32, and the cameras with no beam level.  The reference's batch
trap (one beam level for every camera of a batch) is in
``test_torch_beam_batch.py``.

Both packages render the same seeded 64^3 scene at 160 x 120 (20 x 15
beam tiles): a camera inside the world takes level 1, one orbiting it
level 2, a distant one no level."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

RES = (160, 120)
INSIDE = ([32.0, 30.0, 20.0], [40.0, 20.0, 60.0])  # beam level 1
ORBIT = 1.8  # orbit_camera's distance factor: level 2
FAR = 4.0  # level 2; level 1 breaks the bound (the batch trap)
NO_LEVEL = 5.0  # no level keeps the bound in a 64 world


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the plain renderers: their many small ops run
    faster so, and do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_scene(package, size=64, seed=9, n_voxels=40):
    """A ``size``^3 world of ``n_voxels`` random voxels of two colors and a
    4^3 block, in the reference's (``voxelhex_tpu``) or the port's
    (``voxelhex_tpu_torch``) BoxTree."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    red, green = boxtree.Albedo(255, 0, 0, 255), boxtree.Albedo(0, 255, 0, 255)
    tree = boxtree.BoxTree(size, 4, auto_simplify=False)
    rng = np.random.default_rng(seed)
    for _ in range(n_voxels):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        tree.insert(p, red if rng.random() < 0.5 else green)
    tree.insert_at_lod((8, 8, 8), 4, green)
    return tree


def camera_pair(kind, res=RES, yaw=100.0):
    """The same camera in both packages: ``"inside"``, or an orbit at the
    distance factor ``kind``."""
    from voxelhex_tpu.render.camera import Camera as RefCamera
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import Camera, orbit_camera

    if kind == "inside":
        o, t = (np.asarray(v) for v in INSIDE)
        return (RefCamera(origin=o, target=t, resolution=res),
                Camera(origin=o, target=t, resolution=res))
    return (ref_orbit(64.0, yaw_deg=yaw, distance_factor=kind, resolution=res),
            orbit_camera(64.0, yaw_deg=yaw, distance_factor=kind, resolution=res))


@pytest.fixture(scope="module")
def renderers():
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    return (BitGridRenderer(make_scene("voxelhex_tpu")),
            fastest_renderer(make_scene("voxelhex_tpu_torch"), device="cpu"))


@pytest.mark.parametrize("kind,level", [("inside", 1), (ORBIT, 2)])
def test_beam_start_equals_reference(renderers, kind, level):
    from voxelhex_tpu_torch.render.starts import beam_level

    ref, port = renderers
    ref_cam, cam = camera_pair(kind)
    assert ref._beam_level(ref_cam, 8) == beam_level(64, cam) == level
    want = np.asarray(ref.beam_start(ref_cam))
    got = port.beam_start(cam)
    assert got.dtype == torch.float32 and got.shape == (RES[0] * RES[1],)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want < 1e8).any()
    if kind == ORBIT:  # tiles beside the world are dead
        assert (want == 1e8).any()


@pytest.mark.parametrize("out_u8", [True, False])
def test_beam_frames_equal_reference(renderers, out_u8):
    """``render(beam_prepass=True)`` at both levels, and (u8) with no level
    (the plain frame, ``last_stats`` saying so), equal to the reference's."""
    ref, port = renderers
    cases = [("inside", "beam"), (ORBIT, "beam")] + ([(NO_LEVEL, None)] if out_u8 else [])
    for kind, ran in cases:
        ref_cam, cam = camera_pair(kind)
        want = np.asarray(ref.render(ref_cam, out_u8=out_u8, beam_prepass=True))
        got = port.render(cam, out_u8=out_u8, beam_prepass=True)
        assert got.dtype == (np.uint8 if out_u8 else np.float32)
        np.testing.assert_array_equal(got, want)
        assert port.last_stats["prepass"] == ran and port.last_stats["beam_fused"] == bool(ran)
        if ran is None:
            assert port.beam_start(cam) is None
            np.testing.assert_array_equal(got, port.render(cam, out_u8=out_u8))


def test_beam_batches_equal_reference_frames(renderers):
    """``render_many`` and ``render_delta_many`` with the beam: each frame
    equals the reference's ``render(cam, beam_prepass=True)``, a camera
    with no level included (its plain frame); ``None`` when ``cameras[0]``
    has no level, as the reference's."""
    ref, port = renderers
    pairs = [camera_pair("inside"), camera_pair(NO_LEVEL), camera_pair(ORBIT, yaw=200.0)]
    want = np.stack([np.asarray(ref.render(r, out_u8=True, beam_prepass=True))
                     for r, _c in pairs])
    cams = [c for _r, c in pairs]
    got = port.render_many(cams, out_u8=True, beam_prepass=True)
    np.testing.assert_array_equal(got, want)
    assert port.last_stats["beam_fused"]
    delta = port.render_delta_many(cams, beam_prepass=True)
    np.testing.assert_array_equal(np.stack(delta), want)
    assert port.last_stats["beam_fused"] and not port.last_stats["pose_validated"]
    # the beam is part of the pose token
    port.render_delta_many(cams[2:], beam_prepass=True)
    for kw, validated in (({"beam_prepass": True}, True), ({}, False)):
        port.render_delta_many(cams[2:], **kw)
        assert port.last_stats["pose_validated"] == validated
    no_level = [cams[1], cams[0]]
    assert port.render_many(no_level, beam_prepass=True) is None
    assert port.render_delta_many(no_level, beam_prepass=True) is None


def test_beam_spec_gates(renderers):
    """No beam where the tile does not divide the resolution, as the
    reference; the beam grids are built once a level and dropped by
    ``invalidate_beam``."""
    ref, port = renderers
    ref_cam, cam = camera_pair("inside", res=(164, 120))
    assert ref._beam_spec(ref_cam) is None and port.beam_start(cam) is None
    port.beam_start(camera_pair("inside")[1])
    grid = port._beam_grids[1]
    port.beam_start(camera_pair("inside")[1])
    assert port._beam_grids[1] is grid
    port.invalidate_beam()
    assert not port._beam_grids
