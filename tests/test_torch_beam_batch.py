"""The reference's beam batch trap: its batch programs trace the beam of
``cameras[0]``'s level for every camera of the batch (``_fused_batch_fn``,
``_fused_delta_fn`` alike), where the port marches each camera's own level.

The reference's ``render_many`` runs once its renderer has a stable plan
(``fuse_plan=True``, two frames that recorded the same plan), and compiles
a program of its own: apart from ``test_torch_beam.py``, so that each file
stays cheap.  The scene and cameras are that file's."""

import numpy as np
import pytest

from test_torch_beam import FAR, camera_pair, make_scene, one_thread  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")


def test_reference_batch_takes_one_beam_level():
    """A batch of a level-1 camera and a camera that needs level 2: the
    reference's ``render_many`` draws the second frame with a level-1 beam,
    which breaks the bound that ``_beam_level`` keeps, so the frame loses
    pixels that the reference's ``render(beam_prepass=True)`` of the camera
    keeps.  The port's batch frame is its ``render``'s, and that one the
    reference's."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    ref = BitGridRenderer(make_scene("voxelhex_tpu"), fuse_plan=True)
    port = fastest_renderer(make_scene("voxelhex_tpu_torch"), device="cpu")
    (ref0, cam0), (ref1, cam1) = camera_pair("inside"), camera_pair(FAR)
    assert (ref._beam_spec(ref0)["key"][0], ref._beam_spec(ref1)["key"][0]) == (1, 2)
    # two frames that record one plan make it stable; neither is the fused
    # frame of a stable plan
    want = np.asarray(ref.render(ref1, out_u8=True, beam_prepass=True))
    again = np.asarray(ref.render(ref1, out_u8=True, beam_prepass=True))
    assert not ref.last_stats.get("frame_fused")
    np.testing.assert_array_equal(again, want)
    batch = ref.render_many([ref0, ref1], out_u8=True, beam_prepass=True)
    assert batch is not None and ref.last_stats["beam_fused"]
    lost = (np.asarray(batch)[1] != want).any(axis=-1)
    assert lost.sum() > 0
    assert (want[lost] > 0).any(axis=-1).all()  # each was a hit in the camera's render
    got = port.render_many([cam0, cam1], out_u8=True, beam_prepass=True)
    np.testing.assert_array_equal(got[1], want)
    np.testing.assert_array_equal(got[1], port.render(cam1, out_u8=True, beam_prepass=True))
