"""The port's depth prepass without compaction, against the reference
renderer's: ``render(compact=False)`` at ``prepass_levels`` 1 and 2 in u8
and f32, where the reference runs its one-program level loop
(``_prepass_fn``) and not the compacted rounds of ``test_torch_prepass.py``
(the two programs compile the entry point and the depth's norm apart, so
each is held to the port on its own); and the prepasses' precedence (the
reference's ``_render_impl``).  The scene and cameras are that file's."""

import numpy as np
import pytest

from test_torch_prepass import (camera_pair, deep, one_thread, scenes,  # noqa: F401
                                with_levels)

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("levels", [1, 2])
def test_prepass_without_compaction(deep, levels):  # noqa: F811
    """``compact=False``: the depth prepass runs and the beam keyword
    changes nothing, in both renderers; the frames are equal."""
    ref, port = with_levels(deep, levels)
    ref_cam, cam = camera_pair((96, 72), yaw=130.0)  # a beam level at this resolution
    for out_u8 in (True, False):
        want = np.asarray(ref.render(ref_cam, out_u8=out_u8, compact=False, beam_prepass=out_u8))
        got = port.render(cam, out_u8=out_u8, compact=False, beam_prepass=out_u8)
        np.testing.assert_array_equal(got, want)
        assert port.last_stats["prepass"] == "depth"


def test_prepass_precedence(scenes, deep):  # noqa: F811
    """The reference's order: the depth prepass when it has levels (the beam
    and splat keywords then change nothing); else the beam when the camera
    has a level; else the splat at an even resolution; ``compact=False``
    runs neither the beam nor the splat."""
    from voxelhex_tpu_torch.render import fastest_renderer

    _ref, one = with_levels(deep, 1)
    port = fastest_renderer(scenes[1], device="cpu")
    cam = camera_pair((96, 72))[1]  # a beam level at this resolution
    depth = one.render(cam, out_u8=True)
    np.testing.assert_array_equal(one.render(cam, out_u8=True, beam_prepass=True,
                                             splat_prepass=True), depth)
    assert one.last_stats["prepass"] == "depth"
    for kw, ran in (({"beam_prepass": True, "splat_prepass": True}, "beam"),
                    ({"splat_prepass": True}, "splat")):
        port.render(cam, out_u8=True, **kw)
        assert port.last_stats["prepass"] == ran
    port.render(cam, out_u8=True, compact=False, beam_prepass=True, splat_prepass=True)
    assert port.last_stats["prepass"] is None
