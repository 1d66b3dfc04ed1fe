"""The port's depth prepass (plain versions, on the CPU) against the
reference renderer's, bit for bit: frames of ``BitGridRenderer(prepass=True,
prepass_levels=k)`` at k = 1 and 2 in u8 and f32; resolutions that force
the levels down; ``FramePipeline`` passing the prepass keywords through.
``compact=False`` and the prepasses' precedence are in
``test_torch_prepass_uncompacted.py``, whose reference program
(``_prepass_fn``) compiles apart."""

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
    """``size`` * 8 random voxels of two colors, a 16^3 solid block and a
    4^3 one, in the reference's (``voxelhex_tpu``) or the port's
    (``voxelhex_tpu_torch``) BoxTree: surfaces the coarse levels see, and
    single voxels they miss."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    red, green = boxtree.Albedo(255, 0, 0, 255), boxtree.Albedo(0, 255, 0, 255)
    tree = boxtree.BoxTree(size, 4, auto_simplify=False)
    rng = np.random.default_rng(seed)
    for _ in range(size * 8):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        tree.insert(p, red if rng.random() < 0.5 else green)
    tree.insert_at_lod((32, 0, 32), 16, red)
    tree.insert_at_lod((8, 8, 8), 4, green)
    return tree


def camera_pair(res=RES, yaw=40.0):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    return (ref_orbit(64.0, yaw_deg=yaw, distance_factor=1.2, resolution=res),
            orbit_camera(64.0, yaw_deg=yaw, distance_factor=1.2, resolution=res))


@pytest.fixture(scope="module")
def scenes():
    return make_scene("voxelhex_tpu"), make_scene("voxelhex_tpu_torch")


def renderer_pair(scenes, **kw):
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    return BitGridRenderer(scenes[0], **kw), fastest_renderer(scenes[1], device="cpu", **kw)


@pytest.fixture(scope="module")
def deep(scenes):
    """``(reference, port)`` renderers with the depth prepass, one pair of
    instances (so that the reference compiles its programs once): each test
    sets ``prepass_levels``, which both read at each frame."""
    return renderer_pair(scenes, prepass=True)


def with_levels(pair, levels):
    for r in pair:
        r.prepass_levels = levels
    return pair


@pytest.mark.parametrize("levels", [1, 2])
def test_prepass_frames_equal_reference(scenes, deep, levels):
    """u8 and f32 frames at 64 x 48, equal to the reference's.  With two
    levels also: at 66 x 48 the frame of one level (4 does not divide 66),
    at 65 x 48 the plain frame (2 does not divide 65), and at 64 x 48 a
    frame that differs from the plain one, as the reference's does (the
    starts are not conservative)."""
    ref, port = with_levels(deep, levels)
    ref_cam, cam = camera_pair()
    for out_u8 in (False, True):
        want = np.asarray(ref.render(ref_cam, out_u8=out_u8))
        got = port.render(cam, out_u8=out_u8)
        np.testing.assert_array_equal(got, want)
        assert port.last_stats["prepass"] == "depth"
    if levels == 2:
        from voxelhex_tpu_torch.render import fastest_renderer

        plain = fastest_renderer(scenes[1], device="cpu")
        one = fastest_renderer(scenes[1], device="cpu", prepass=True, prepass_levels=1)
        for res, other in (((66, 48), one), ((65, 48), plain)):
            c = camera_pair(res)[1]
            np.testing.assert_array_equal(port.render(c, out_u8=True), other.render(c, out_u8=True))
        assert port.last_stats["prepass"] is None
        assert (plain.render(cam, out_u8=True) != got).any()


def test_frame_pipeline_passes_the_prepass_keywords(scenes):
    from voxelhex_tpu_torch.render.pipeline import FramePipeline

    from voxelhex_tpu_torch.render import fastest_renderer

    port = fastest_renderer(scenes[1], device="cpu")
    cam = camera_pair((96, 72), yaw=250.0)[1]  # a beam level at this resolution
    pipe = FramePipeline(port)
    for kw, ran in (({"beam_prepass": True}, "beam"), ({"splat_prepass": True}, "splat")):
        got = pipe.render(cam, out_u8=True, **kw).result()
        assert port.last_stats["prepass"] == ran
        np.testing.assert_array_equal(got, port.render(cam, out_u8=True, **kw))
