"""The port's render/edit server on the CPU, against the reference's.

``voxelhex_tpu_torch.serve`` mirrors ``tests/test_serve.py``: frames over
HTTP, live edits, stats, the viewer page, scene loads and delta serving,
each frame held bit for bit to the reference's ``RenderService`` (JAX on
the CPU) on the same scene, poses and edits at the reference tests' sizes.
PNGs are decoded with PIL.  Delta serving, the CLI and the PNG encoder are
``tests/test_torch_serve_delta.py``; streaming is
``tests/test_torch_serve_streaming.py``.
"""

import io
import json
import os
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from voxelhex_tpu_torch.serve import RenderService, make_server
from voxelhex_tpu_torch.tree import boxtree as port_boxtree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAME = ([-20, 40, -20], [16, 16, 16], (64, 48))
EDIT_POSE = ([20, 30, -6], [8, 12, 8], (48, 36))
EDIT_OPS = [{"op": "insert", "pos": [8, 12, 8], "color": [255, 0, 0, 255], "size": 4}]
CLEAR_OPS = [{"op": "clear", "pos": [8, 12, 8], "size": 4}]
LOAD_POSE = ([-10, 20, -10], [8, 4, 8], (32, 24))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the plain renderers: their many small ops run
    faster so, and do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(boxtree=port_boxtree, size=64, brick=4):
    tree = boxtree.BoxTree(size, brick, auto_simplify=False)
    rng = np.random.default_rng(4)
    for _ in range(200):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        tree.insert(p, boxtree.Albedo(*(int(v) for v in rng.integers(64, 255, 3)), 255))
    return tree


def _tiny_vox_bytes():
    """A minimal .vox: one 8^3 model with a few voxels."""
    import struct

    def chunk(cid, content, children=b""):
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    size = chunk(b"SIZE", struct.pack("<iii", 8, 8, 8))
    voxels = [(1, 1, 1, 1), (2, 1, 1, 2), (1, 2, 1, 3), (4, 4, 4, 4)]
    xyzi = chunk(b"XYZI", struct.pack("<i", len(voxels))
                 + b"".join(struct.pack("<4B", *v) for v in voxels))
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", size + xyzi)


@pytest.fixture(scope="module")
def ref():
    """The reference service's frames of the scenarios below, once."""
    from voxelhex_tpu.serve import RenderService as RefService
    from voxelhex_tpu.tree import boxtree as ref_boxtree

    out = {}
    svc = RefService(_scene(ref_boxtree))
    out["frame"] = svc.render(*FRAME)
    out["before"] = svc.render(*EDIT_POSE)
    svc.apply_edits(EDIT_OPS)
    out["after"] = svc.render(*EDIT_POSE)
    svc.apply_edits(CLEAR_OPS)
    out["cleared"] = svc.render(*EDIT_POSE)
    with tempfile.TemporaryDirectory() as tmp:
        svc.load_vox_bytes(_tiny_vox_bytes(), name="tiny.vox", cache_dir=tmp)
    out["load"] = svc.render(*LOAD_POSE)
    return out


def _serve(service):
    srv = make_server(service, port=0)  # an ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _png(url):
    return np.asarray(Image.open(io.BytesIO(urllib.request.urlopen(url, timeout=60).read())))


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    return json.load(urllib.request.urlopen(req, timeout=60))


def _frame_url(base, pose):
    (ox, oy, oz), (tx, ty, tz), (w, h) = pose
    return f"{base}/frame?ox={ox}&oy={oy}&oz={oz}&tx={tx}&ty={ty}&tz={tz}&w={w}&h={h}"


@pytest.fixture(scope="module")
def server():
    service = RenderService(_scene(), device="cpu")
    srv, base = _serve(service)
    yield service, base
    srv.shutdown()


def test_frame_endpoint_matches_direct_render(server, ref):
    service, base = server
    img = _png(_frame_url(base, FRAME))
    assert img.shape == (48, 64, 3)
    direct = service.render(*FRAME)
    np.testing.assert_array_equal(img, direct)
    np.testing.assert_array_equal(img, ref["frame"])


def test_edit_endpoint_changes_frames(server, ref):
    service, base = server
    before = _png(_frame_url(base, EDIT_POSE))
    resp = _post(f"{base}/edit", json.dumps(EDIT_OPS).encode())
    assert resp["applied"] == 1
    after = _png(_frame_url(base, EDIT_POSE))
    assert not np.array_equal(before, after)
    _post(f"{base}/edit", json.dumps(CLEAR_OPS).encode())
    assert service.tree.get((8, 12, 8)).albedo is None
    cleared = _png(_frame_url(base, EDIT_POSE))
    for got, key in ((before, "before"), (after, "after"), (cleared, "cleared")):
        np.testing.assert_array_equal(got, ref[key])


def test_stats_endpoint(server):
    service, base = server
    stats = json.load(urllib.request.urlopen(f"{base}/stats", timeout=30))
    assert stats["size"] == 64 and stats["brick_dim"] == 4
    assert stats["frames_served"] >= 1
    assert stats["node_count"] == service.tree.node_count
    assert not stats["streaming"] and stats["view_size"] is None
    assert stats["last_trace"]["batched_frames"] == 1 and stats["last_trace"]["delta"]


def test_viewer_page_has_view_distance_control(server):
    _service, base = server
    html = urllib.request.urlopen(f"{base}/", timeout=30).read().decode()
    assert "view distance" in html and "/view" in html


def test_viewer_page_served(server):
    _service, base = server
    html = urllib.request.urlopen(f"{base}/", timeout=30).read().decode()
    assert "voxelhex-tpu" in html and "/frame?" in html and "/load" in html
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/nowhere", timeout=30)
    assert err.value.code == 404


def test_load_endpoint_swaps_scene(ref, monkeypatch, tmp_path):
    """POST /load with .vox bytes swaps the served scene; a second identical
    upload reads the bencode cache and parses nothing; a damaged cache is
    parsed again from the source."""
    from voxelhex_tpu_torch.io import vox

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the cache's directory
    parsed = []
    load_vox_tree = vox.load_vox_tree
    monkeypatch.setattr(vox, "load_vox_tree", lambda *a, **k: parsed.append(a) or
                        load_vox_tree(*a, **k))
    service = RenderService(_scene(), device="cpu")
    srv, base = _serve(service)
    try:
        data = _tiny_vox_bytes()
        resp = _post(f"{base}/load?name=tiny.vox", data)
        assert resp["loaded"] and resp["size"] == 16  # an 8^3 model -> a 16 tree
        assert service.tree.size == 16 and service.tree.node_count >= 1
        assert len(parsed) == 1
        img = _png(_frame_url(base, LOAD_POSE))
        np.testing.assert_array_equal(img, ref["load"])
        (cache,) = [p for p in os.listdir(tmp_path) if p.startswith(".vhx_cache_tiny.vox_")]
        assert _post(f"{base}/load?name=tiny.vox", data)["loaded"]
        assert len(parsed) == 1  # the cache, not the source
        np.testing.assert_array_equal(_png(_frame_url(base, LOAD_POSE)), ref["load"])
        with open(tmp_path / cache, "r+b") as f:
            f.truncate(40)
        assert _post(f"{base}/load?name=tiny.vox", data)["loaded"]
        assert len(parsed) == 2
        np.testing.assert_array_equal(_png(_frame_url(base, LOAD_POSE)), ref["load"])
    finally:
        srv.shutdown()
