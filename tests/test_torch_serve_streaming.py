"""The port's render service through a streaming window on the CPU, against
the reference's.

The streaming half of ``tests/test_serve.py``: a windowed scene with an
edit and the idle-pose cache, each frame that does not wait on a worker
thread held bit for bit to the reference's ``RenderService`` (JAX on the
CPU, ``async_far=True`` in both): the first frame of a view, the first
frame after an edit, and every frame once the view has settled.  The
view-distance switches are ``tests/test_torch_serve_view.py``.
"""

import numpy as np
import pytest
from test_torch_serve import _scene, one_thread  # noqa: F401

from voxelhex_tpu_torch.serve import RenderService

POSE = ([-30, 60, -30], [32, 16, 32], (48, 36))
MOVED = ([-28, 60, -30], [32, 16, 32], (48, 36))
YELLOW = {"op": "insert", "pos": [32, 30, 32], "color": [255, 255, 0, 255], "size": 4}
MAGENTA = {"op": "insert", "pos": [30, 30, 30], "color": [255, 0, 255, 255], "size": 4}


def _settle(service, pose, max_renders=50):
    for _ in range(max_renders):
        frame = service.render(*pose)
        if service.view.settled():
            return frame
        if service.view.far is not None and service.view.far._job is not None:
            service.view.far._job[0].result()  # wait for the worker's ring build
    raise AssertionError("the view did not settle")


@pytest.fixture(scope="module")
def ref():
    """The reference service's frames of the scenarios below, once."""
    from voxelhex_tpu.serve import RenderService as RefService
    from voxelhex_tpu.tree import boxtree as ref_boxtree

    out = {}
    svc = RefService(_scene(ref_boxtree), view_size=32)
    out["windowed"] = svc.render(*POSE)
    svc.apply_edits(YELLOW)
    out["yellow"] = svc.render(*POSE)
    svc = RefService(_scene(ref_boxtree), view_size=32)
    out["settled"] = _settle(svc, POSE)
    out["moved"] = svc.render(*MOVED)
    svc.apply_edits(MAGENTA)
    out["magenta"] = svc.render(*POSE)
    return out


def test_streaming_service_serves_windowed_scene(ref):
    service = RenderService(_scene(size=64), view_size=32, device="cpu")
    assert service.view is not None and service.renderer is None
    rgb = service.render(*POSE)
    assert rgb.shape == (36, 48, 3)
    np.testing.assert_array_equal(rgb, ref["windowed"])
    # edits reach the streaming view through its tree trigger
    service.apply_edits(YELLOW)
    rgb2 = service.render(*POSE)
    assert not np.array_equal(rgb, rgb2)
    np.testing.assert_array_equal(rgb2, ref["yellow"])


def test_streaming_idle_pose_cache(ref):
    """Once the view settles, a repeated pose at the same content version
    is served from the idle-pose cache with no launch; a moved pose and an
    edit miss it."""
    service = RenderService(_scene(size=64), view_size=32, device="cpu")
    f1 = _settle(service, POSE)
    np.testing.assert_array_equal(f1, ref["settled"])
    f1 = service.render(*POSE)
    base = service.stream_cache_hits
    f2 = service.render(*POSE)
    assert service.stream_cache_hits == base + 1
    assert service.pose_validated_frames >= service.stream_cache_hits
    np.testing.assert_array_equal(f1, f2)
    f2[:] = 0  # served frames are copies: the cache stays as it was
    np.testing.assert_array_equal(service.render(*POSE), f1)
    base = service.stream_cache_hits
    f3 = service.render(*MOVED)
    assert service.stream_cache_hits == base
    np.testing.assert_array_equal(f3, ref["moved"])
    service.apply_edits(MAGENTA)
    f4 = service.render(*POSE)
    assert not np.array_equal(f4, f1)
    np.testing.assert_array_equal(f4, ref["magenta"])
    assert service.stream_cache_hits == base
