"""The depth prepass past the levels of one launch of ``prepass.cu``: on
the CPU route, ``BitGridRenderer(prepass=True, prepass_levels=9)`` at 512 x
512 against the reference renderer's one-program level loop
(``_prepass_fn``, ``render(compact=False)``), bit for bit; the card
chains launches for it (``prepass_chunks``), which
``tests/test_torch_kernels_host_lod_skip.py`` and the ``gpu`` tests hold
to these plain versions."""

import numpy as np
import pytest

from test_torch_prepass import camera_pair, one_thread, scenes  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")


def test_nine_level_prepass_equals_reference(scenes):  # noqa: F811
    """Nine levels (1 x 1 up to 256 x 256) before a 512 x 512 frame, the
    levels that the card runs as two launches, one level and then eight."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.ops.prepass import prepass_chunks
    from voxelhex_tpu_torch.render import fastest_renderer

    assert prepass_chunks(9) == [(9, 1), (1, 8)]
    ref = BitGridRenderer(scenes[0], prepass=True, prepass_levels=9)
    port = fastest_renderer(scenes[1], device="cpu", prepass=True, prepass_levels=9)
    ref_cam, cam = camera_pair((512, 512), yaw=130.0)
    want = np.asarray(ref.render(ref_cam, out_u8=True, compact=False))
    got = port.render(cam, out_u8=True, compact=False)
    assert port.last_stats["prepass"] == "depth"
    np.testing.assert_array_equal(got, want)
