"""The port stands alone: no JAX, no reference package, no CPU fallback on
the card, and a smoke run that fails without a GPU."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "voxelhex_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "voxelhex_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_scene_model_stands_alone():
    """The scene model's modules are the port's own: they import no JAX and
    nothing of the reference (the package-wide check above), no port file
    names the repo's ``native/`` directory or its library, and the host
    library's wrapper has no ``try`` that could route a failed build to
    NumPy."""
    files = _port_files()
    for mod in ("constants.py", "native.py", os.path.join("spatial", "math.py"),
                os.path.join("spatial", "luts.py"), os.path.join("tree", "boxtree.py"),
                os.path.join("tree", "mipmap.py"), os.path.join("tree", "build.py"),
                os.path.join("tree", "flat.py"), os.path.join("tree", "invariants.py"),
                os.path.join("io", "vox.py"), os.path.join("io", "bencode.py")):
        assert os.path.join(PKG, mod) in files, mod
    sources = files + [os.path.join(PKG, "host", "rasterize.cpp")]
    for path in sources:
        with open(path) as f:
            text = f.read()
        for needle in ("native/", "tree_edit"):
            assert needle not in text, (path, needle)
        if path.endswith(".py"):
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, ast.Constant) and node.value == "native":
                    raise AssertionError(f"{path} names a directory 'native'")
    with open(os.path.join(PKG, "native.py")) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    from voxelhex_tpu_torch import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-DVHX_NOT_A_FLAG", "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ rasterize.cpp failed"):
        native.library()
    assert not os.listdir(os.path.dirname(native.library_path()))


def test_check_source_takes_the_three_source_types():
    from voxelhex_tpu_torch.render.bitgrid import BitGrid, bitgrid_from_occupancy
    from voxelhex_tpu_torch.render.renderer import check_source
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree
    from voxelhex_tpu_torch.tree.flat import flatten

    tree = BoxTree(16, 4)
    tree.insert((1, 2, 3), Albedo(10, 20, 30, 255))
    bg = bitgrid_from_occupancy(np.zeros((16, 16, 16), dtype=bool))
    assert check_source(bg) is bg
    for source in (tree, flatten(tree)):
        got = check_source(source)
        assert isinstance(got, BitGrid) and got.size == 16
        assert (got.colors != 0xFFFF).sum() == 1
    for other in (None, np.zeros((16, 16, 16), dtype=bool), {"size": 16}):
        with pytest.raises(TypeError, match="BitGrid, BoxTree or FlatTree"):
            check_source(other)


def test_wrappers_have_no_fallback():
    """A CUDA tensor launches the kernel or raises: the wrappers catch
    nothing that could route it to the plain version."""
    for name in ("traverse.py", "shade.py", "frame.py", "frames.py", "multihit.py",
                 "composite.py", "adam.py"):
        with open(os.path.join(PKG, "ops", name)) as f:
            tree = ast.parse(f.read())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name


def test_default_device_needs_cuda(monkeypatch):
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bg = bitgrid_from_occupancy(torch.zeros((16, 16, 16), dtype=torch.bool).numpy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fastest_renderer(bg)
    assert fastest_renderer(bg, device="cpu").device.type == "cpu"


def test_import_builds_nothing():
    from voxelhex_tpu_torch.diff import optim, soft  # noqa: F401
    from voxelhex_tpu_torch.ops import (_build, adam, composite, frame, frames, multihit, shade,
                                        traverse)
    from voxelhex_tpu_torch.render import pipeline  # noqa: F401

    assert _build._lib is None or torch.cuda.is_available()
    assert frames.render_frames.launches >= 0
    assert traverse.traverse.launches >= 0 and shade.shade.launches >= 0
    assert frame.render_frame.launches >= 0 and multihit.multihit.launches >= 0
    assert composite.composite_forward.launches >= 0
    assert composite.composite_backward.launches >= 0 and adam.adam_update.launches >= 0


def test_batched_paths_raise_on_the_card_path_without_a_fallback(monkeypatch):
    """A tree that is not on the CPU never reaches the plain version: the
    batched wrappers launch the kernel or raise."""
    from voxelhex_tpu_torch.ops import frames
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = device_bitgrid(bitgrid_from_occupancy(torch.ones((16, 16, 16), dtype=torch.bool)
                                                 .numpy()), "cpu")
    meta = dict(tree, occ_pairs=tree["occ_pairs"].to("meta"))
    monkeypatch.setattr(frames, "render_frames_plain", None)
    cams = [orbit_camera(16.0, resolution=(8, 8))]
    for call in (lambda: frames.render_frames(meta, cams),
                 lambda: frames.render_frames_digest(meta, cams)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


def test_frame_pipeline_needs_no_card_for_a_cpu_renderer():
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy
    from voxelhex_tpu_torch.render.pipeline import FramePipeline

    r = fastest_renderer(bitgrid_from_occupancy(torch.zeros((16, 16, 16), dtype=torch.bool)
                                                .numpy()), device="cpu")
    pipe = FramePipeline(r)
    assert pipe._copy_stream is None
    pipe.close()
    with pytest.raises(ValueError, match="max_in_flight"):
        FramePipeline(r, max_in_flight=0)


def test_soft_renderer_needs_cuda_by_default(monkeypatch):
    from voxelhex_tpu_torch.diff.soft import SoftRenderer
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bg = bitgrid_from_occupancy(torch.zeros((16, 16, 16), dtype=torch.bool).numpy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SoftRenderer(bg)
    assert SoftRenderer(bg, device="cpu").device.type == "cpu"
    for kw in ({"tracer": "skip"}, {"flat_params": False}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            SoftRenderer(bg, device="cpu", **kw)


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
