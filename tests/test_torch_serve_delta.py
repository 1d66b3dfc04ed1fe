"""The port's delta serving, CLI and PNG encoder on the CPU, against the
reference's.

The dense half of ``tests/test_serve.py`` that needs no HTTP: an idle
viewer's repeated pose and an edit between frames, each frame held bit for
bit to the reference's ``RenderService`` (JAX on the CPU).
``pose_validated_frames`` follows the port's rule
(``BitGridRenderer.render_delta_many``): a batch is pose-validated when its
token (the delta key, the device tree's identity and content version, the
cameras) equals the batch before's, not the reference's count, which
follows its plan recording.  Then the service's device default, the PNG
encoder and the CLI.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_serve import ROOT, _scene, one_thread  # noqa: F401

from voxelhex_tpu_torch import serve
from voxelhex_tpu_torch.serve import RenderService
from voxelhex_tpu_torch.tree import boxtree as port_boxtree

IDLE_POSE = ([96.0, 72.0, 96.0], [32.0, 24.0, 32.0], (96, 72))
OTHER_POSE = ([80.0, 60.0, 80.0], [32.0, 24.0, 32.0], (96, 72))
EDIT_POSE = ([20, 30, -6], [8, 12, 8], (48, 36))
BLUE_OPS = [{"op": "insert", "pos": [28, 28, 28], "size": 8, "color": [0, 0, 255, 255]}]


@pytest.fixture(scope="module")
def ref():
    """The reference service's frames of an idle pose, another pose and
    the idle pose after an edit, once."""
    from voxelhex_tpu.serve import RenderService as RefService
    from voxelhex_tpu.tree import boxtree as ref_boxtree

    svc = RefService(_scene(ref_boxtree))
    out = {"idle": svc.render(*IDLE_POSE), "other": svc.render(*OTHER_POSE)}
    svc.apply_edits(BLUE_OPS)
    out["blue"] = svc.render(*IDLE_POSE)
    return out


def test_pose_validated_counter_and_delta_serving(ref):
    """An idle viewer re-requesting the same pose: every frame after the
    first is pose-validated (the port's rule) and fetched as a digest
    only, and frames stay bit-identical to the reference's."""
    service = RenderService(_scene(), fuse_plan=True, device="cpu")
    frames = [service.render(*IDLE_POSE) for _ in range(6)]
    for f in frames:
        np.testing.assert_array_equal(f, ref["idle"])
    stats = service.stats()
    assert stats["frames_served"] == 6
    assert stats["pose_validated_frames"] == 5
    assert stats["last_trace"]["delta_fetched"] == 0
    f2 = service.render(*OTHER_POSE)  # another pose renders, not validated
    np.testing.assert_array_equal(f2, ref["other"])
    assert service.stats()["pose_validated_frames"] == 5
    assert service.renderer.last_stats["delta_fetched"] == 1


def test_edit_keeps_renderer_and_delta_recovers(ref):
    """Dense edits refresh the device content in place: the renderer and
    its delta baseline survive, the edit shows at once and its frame
    fetches only the rows it moved, and the same pose is pose-validated
    again from the frame after."""
    service = RenderService(_scene(), fuse_plan=True, device="cpu")
    for _ in range(5):
        before = service.render(*IDLE_POSE)
    r_obj = service.renderer
    key = r_obj._delta_state[0]
    assert service.apply_edits(BLUE_OPS) == 1
    assert service.renderer is r_obj and r_obj._delta_state[0] == key
    validated = service.pose_validated_frames
    after = service.render(*IDLE_POSE)
    np.testing.assert_array_equal(after, ref["blue"])
    assert not np.array_equal(after, before)
    assert (after[..., 2].astype(int) > after[..., 0].astype(int)).any()
    st = r_obj.last_stats
    assert not st["pose_validated"] and st["delta_fetched"] == 1
    assert 0 < st["delta_rows_fetched"] < 72 // 2  # one band of rows
    a2 = service.render(*IDLE_POSE)
    a3 = service.render(*IDLE_POSE)
    np.testing.assert_array_equal(a2, after)
    np.testing.assert_array_equal(a3, after)
    assert service.pose_validated_frames == validated + 2
    assert r_obj.last_stats["delta_fetched"] == 0


def test_served_frames_are_copies():
    service = RenderService(_scene(), device="cpu")
    a = service.render(*EDIT_POSE)
    a[:] = 0
    b = service.render(*EDIT_POSE)
    assert b.any() and b is not service.renderer._delta_state[2]


def test_service_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RenderService(_scene())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RenderService(_scene(), view_size=32)
    assert RenderService(_scene(), device="cpu").renderer.device.type == "cpu"


def test_encode_png_round_trips_and_write_png_matches_the_reference(tmp_path):
    from voxelhex_tpu.utils.png import write_png as ref_write_png
    from voxelhex_tpu_torch.utils.png import encode_png, write_png

    rng = np.random.default_rng(7)
    for shape in ((48, 64, 3), (1, 1, 3), (5, 3, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        got = np.asarray(Image.open(io.BytesIO(encode_png(img))))
        np.testing.assert_array_equal(got, img)
    for img in (rng.integers(0, 256, (9, 7, 3)).astype(np.uint8),
                rng.random((6, 5, 4)).astype(np.float32) * 1.2 - 0.1,
                rng.integers(0, 256, (4, 6)).astype(np.uint8)):
        write_png(tmp_path / "port.png", img)
        ref_write_png(tmp_path / "ref.png", img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                      np.asarray(Image.open(tmp_path / "ref.png")))
    for bad in (np.zeros((4, 4, 3), dtype=np.float32), np.zeros((4, 4), dtype=np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            encode_png(bad)


def test_cli_help_loads_no_jax_and_no_reference():
    code = ("import runpy, sys\n"
            "sys.argv = ['serve', '--help']\n"
            "try:\n"
            "    runpy.run_module('voxelhex_tpu_torch.serve', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'voxelhex_tpu', 'PIL'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--port", "--host", "--view", "--terrain", "--brick", "--cpu", "--fuse-plan"):
        assert flag in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_trees_equal_the_references():
    """The CLI's demo scene and ``--terrain 64`` are the reference's trees."""
    import importlib.util

    from voxelhex_tpu.tree import boxtree as ref_boxtree
    from voxelhex_tpu.tree.flat import flatten as ref_flatten
    from voxelhex_tpu_torch.tree.flat import flatten

    demo = ref_boxtree.BoxTree(64, 4)
    rng = np.random.default_rng(0)
    for _ in range(500):
        p = tuple(int(v) for v in rng.integers(0, 64, 3))
        demo.insert(p, ref_boxtree.Albedo(*(int(v) for v in rng.integers(64, 255, 3)), 255))
    spec = importlib.util.spec_from_file_location(
        "terrain_example", os.path.join(ROOT, "examples", "terrain.py"))
    terrain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(terrain)
    for port_tree, ref_tree in ((serve.demo_tree(), demo),
                                (serve.terrain_tree(64), terrain.build_terrain(64))):
        a, b = flatten(port_tree), ref_flatten(ref_tree)
        assert (a.size, a.brick_dim) == (b.size, b.brick_dim)
        for name in ("node_meta", "node_children", "bricks"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert port_tree.color_palette == [port_boxtree.Albedo(c.r, c.g, c.b, c.a)
                                           for c in ref_tree.color_palette]


def test_pose_token_follows_the_content_version():
    """The port's pose token keys on the device tree's content version as
    well as its tensors' identity: the content-change hook alone ends
    pose validation, as a new background or camera does."""
    from voxelhex_tpu_torch.render.camera import Camera

    r = RenderService(_scene(), device="cpu").renderer
    cam = Camera(origin=np.array(EDIT_POSE[0], dtype=np.float64),
                 target=np.array(EDIT_POSE[1], dtype=np.float64), resolution=EDIT_POSE[2])
    red = (0.5, 0.0, 0.0)
    steps = [("first", None, False), ("again", None, True),
             ("hook", r.invalidate_beam, False), ("again", None, True),
             ("bg", None, False), ("again", None, True),
             ("fov", lambda: setattr(cam, "fov_y_deg", 40.0), False), ("again", None, True)]
    bg = (0.0, 0.0, 0.0)
    for name, before, validated in steps:
        if before is not None:
            before()  # the hook keeps the tree's tensors; the version moves on
        if name == "bg":
            bg = red
        r.render_delta_many([cam], bg=bg)
        assert r.last_stats["pose_validated"] == validated, name
