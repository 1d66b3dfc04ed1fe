"""The port's batch paths and depth prepass under ``tracer="skip"`` (plain
versions, on the CPU) against the reference's skip renderer, bit for bit:
``render_many`` and ``render_delta_many`` with and without the beam
prepass, each frame equal to the reference's ``render`` of its camera, and
``prepass=True`` at one level, whose coarse depths come from the skip
tracer's hit points.  The scene and cameras are ``test_torch_skip.py``'s;
the reference's programs compile apart from that file's, so that each file
stays cheap."""

import numpy as np
import pytest

from test_torch_skip import camera_pair, one_thread, scenes  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

YAWS = (100.0, 220.0)


def test_skip_batches_equal_reference_frames(scenes):
    """Two orbit poses and a repeat of the first: ``render_many`` (f32) and
    ``render_delta_many`` (u8), plain and with the beam prepass (each camera
    at its own beam level)."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    ref = BitGridRenderer(scenes[0], tracer="skip")
    port = fastest_renderer(scenes[1], device="cpu", tracer="skip")
    pairs = [camera_pair(distance_factor=1.8, yaw_deg=y) for y in YAWS]
    pairs.append(pairs[0])
    cams = [c for _r, c in pairs]
    for beam in (False, True):
        want = {u8: np.stack([np.asarray(ref.render(r, out_u8=u8, beam_prepass=beam))
                              for r, _c in pairs]) for u8 in (True, False)}
        got = port.render_many(cams, out_u8=False, beam_prepass=beam)
        np.testing.assert_array_equal(got, want[False])
        delta = port.render_delta_many(cams, beam_prepass=beam)
        np.testing.assert_array_equal(np.stack(delta), want[True])
        assert port.last_stats["beam_fused"] == beam
    assert (want[True][0] != want[True][1]).any()


def test_skip_depth_prepass_equals_reference(scenes):
    """``prepass=True, prepass_levels=1``: the u8 frame equal to the
    reference's skip renderer's, whose prepass level marches the skip
    tracer."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    kw = dict(tracer="skip", prepass=True, prepass_levels=1)
    ref = BitGridRenderer(scenes[0], **kw)
    port = fastest_renderer(scenes[1], device="cpu", **kw)
    ref_cam, cam = camera_pair(distance_factor=1.2, yaw_deg=40.0)
    want = np.asarray(ref.render(ref_cam, out_u8=True))
    np.testing.assert_array_equal(port.render(cam, out_u8=True), want)
    assert port.last_stats["prepass"] == "depth"
