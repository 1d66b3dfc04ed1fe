"""The port's view-distance switches on the CPU, against the reference's.

``POST /view`` of ``tests/test_serve.py``, its streamed frame held bit for
bit to the reference's ``RenderService`` (JAX on the CPU); then the
switches themselves: each closes the view it replaces, which leaves the
tree's triggers and is freed (the reference keeps every replaced view
alive through its tree trigger).
"""

import gc
import json
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
from test_torch_serve import _scene, _serve, one_thread  # noqa: F401

from voxelhex_tpu_torch.serve import RenderService

POSE = ([-30, 60, -30], [32, 16, 32], (48, 36))


@pytest.fixture(scope="module")
def ref():
    """The reference service's frame through a 64 window, once."""
    from voxelhex_tpu.serve import RenderService as RefService
    from voxelhex_tpu.tree import boxtree as ref_boxtree

    svc = RefService(_scene(ref_boxtree, size=256))
    svc.set_view_size(64)
    return {"view64": svc.render(*POSE)}


def test_view_distance_endpoint(ref):
    """POST /view switches the live scene between dense rendering and
    streaming windows; /stats reports the window and its far-field rings."""
    service = RenderService(_scene(size=256), device="cpu")
    srv, base = _serve(service)
    try:
        def post_view(n):
            req = urllib.request.Request(f"{base}/view",
                                         data=json.dumps({"view_size": n}).encode(),
                                         method="POST")
            return json.load(urllib.request.urlopen(req, timeout=60))

        assert service.view is None  # starts dense
        stats = post_view(64)
        assert stats["streaming"] and stats["view_size"] == 64
        assert service.view is not None and service.view.view_size == 64
        rgb = service.render(*POSE)
        assert rgb.shape == (36, 48, 3)
        np.testing.assert_array_equal(rgb, ref["view64"])
        stats = json.load(urllib.request.urlopen(f"{base}/stats", timeout=60))
        assert stats["far_tiers"] == [{"factor": 4, "cells": 64}]
        stats = post_view(0)  # the largest view distance: dense again
        assert not stats["streaming"] and stats["view_size"] is None
        assert service.view is None
        req = urllib.request.Request(f"{base}/view",
                                     data=json.dumps({"view_size": 100}).encode(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 500
        assert b"multiple of 16" in err.value.read()
        assert service.view is None and service.renderer is not None
    finally:
        srv.shutdown()


def test_view_switches_close_the_views_they_replace():
    """Every switch closes the view it replaces: the tree keeps one trigger
    (the live view's), the old view's workers stop, its trigger sees no
    later edit, and nothing keeps it alive."""
    tree = _scene(size=128, brick=2)
    n0 = len(tree.update_triggers)
    service = RenderService(tree, device="cpu")
    gone = []
    for size in (32, 64, 0, 32, 32, None):
        old = service.view
        service.set_view_size(size)
        streaming = size not in (0, None)
        assert len(tree.update_triggers) == n0 + streaming
        if streaming:
            assert tree.update_triggers[-1] == service.view._on_tree_update
            service.render(*POSE)
        if old is not None:
            assert old._far_pool._shutdown and old._on_tree_update not in tree.update_triggers
            gen = old._gen
            service.apply_edits({"op": "clear", "pos": [1, 1, 1]})
            assert old._gen == gen
            gone.append(weakref.ref(old))
        del old
    gc.collect()
    assert len(gone) == 4 and all(r() is None for r in gone)
    service.set_view_size(16)
    view = service.view
    view.close()
    view.close()  # a second close does nothing
    assert len(tree.update_triggers) == n0
