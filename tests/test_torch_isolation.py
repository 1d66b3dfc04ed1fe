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
    """The scene model's, the server's and the edit engine's modules are the
    port's own: they import no JAX and nothing of the reference (the
    package-wide check above), no port file names the repo's ``native/``
    directory, the edit engine builds and loads the port's own
    ``host/tree_edit.cpp``, and the host libraries' wrapper has no ``try``
    that could route a failed build to NumPy."""
    files = _port_files()
    for mod in ("constants.py", "native.py", os.path.join("spatial", "math.py"),
                os.path.join("spatial", "luts.py"), os.path.join("tree", "boxtree.py"),
                os.path.join("tree", "mipmap.py"), os.path.join("tree", "build.py"),
                os.path.join("tree", "flat.py"), os.path.join("tree", "invariants.py"),
                os.path.join("io", "vox.py"), os.path.join("io", "bencode.py"), "serve.py",
                os.path.join("utils", "png.py"), os.path.join("tree", "native_edit.py")):
        assert os.path.join(PKG, mod) in files, mod
    sources = files + [os.path.join(PKG, "host", name)
                       for name in ("rasterize.cpp", "tree_edit.cpp")]
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "native/" not in text, path
        if path.endswith(".py"):
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, ast.Constant) and node.value == "native":
                    raise AssertionError(f"{path} names a directory 'native'")
    with open(os.path.join(PKG, "native.py")) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]

    from voxelhex_tpu_torch import native
    from voxelhex_tpu_torch.tree.native_edit import NativeEditTree

    assert native.EDIT_SOURCE == os.path.join(PKG, "host", "tree_edit.cpp")
    NativeEditTree(16, 4)
    loaded = native.edit_library()._name
    assert loaded == native.library_path(native.EDIT_SOURCE)
    assert loaded.startswith(os.path.join(ROOT, "build", "voxelhex_tpu_torch", "host-"))


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
                 "composite.py", "adam.py", "albedo.py", "stream.py", "far.py"):
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
    from voxelhex_tpu_torch.diff import fit, optim, render, soft  # noqa: F401
    from voxelhex_tpu_torch.io import checkpoint  # noqa: F401
    from voxelhex_tpu_torch.ops import (_build, adam, albedo, composite, far, frame, frames,
                                        multihit, shade, stream, traverse)
    from voxelhex_tpu_torch.render import pipeline, streaming  # noqa: F401

    assert _build._lib is None or torch.cuda.is_available()
    assert frames.render_frames.launches >= 0
    assert traverse.traverse.launches >= 0 and shade.shade.launches >= 0
    assert frame.render_frame.launches >= 0 and multihit.multihit.launches >= 0
    assert composite.composite_forward.launches >= 0
    assert composite.composite_backward.launches >= 0 and adam.adam_update.launches >= 0
    assert albedo.albedo_forward.launches >= 0 and albedo.albedo_backward.launches >= 0
    assert stream.region_scatter.launches >= 0 and stream.coarse_rebuild.launches >= 0
    assert stream.window_shift.launches >= 0 and far.render_far.launches >= 0
    from voxelhex_tpu_torch import native

    built = native._edit_lib
    from voxelhex_tpu_torch import serve  # noqa: F401
    from voxelhex_tpu_torch.tree import native_edit  # noqa: F401
    from voxelhex_tpu_torch.utils import png  # noqa: F401

    assert native._edit_lib is built


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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SoftRenderer(bg, device="cpu", tracer="skip")
    assert not SoftRenderer(bg, device="cpu", flat_params=False).flat_params  # ported now


def test_offline_trainers_need_cuda_by_default(monkeypatch):
    """DiffRenderer and with_candidates (and so fit_albedo and fit_soft,
    which run on their renderer's device) need the card unless the caller
    asks for the CPU."""
    from voxelhex_tpu_torch.diff.render import DiffRenderer
    from voxelhex_tpu_torch.diff.soft import with_candidates
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree
    from voxelhex_tpu_torch.tree.flat import flatten

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = BoxTree(16, 4)
    tree.insert((1, 2, 3), Albedo(10, 20, 30, 255))
    flat = flatten(tree)
    for make in (lambda **kw: DiffRenderer(flat, **kw), lambda **kw: with_candidates(tree, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert DiffRenderer(flat, device="cpu").device.type == "cpu"
    assert with_candidates(tree, device="cpu")[0].device.type == "cpu"


def test_offline_slice_stands_alone():
    """The slice's modules are the port's own (the package-wide import check
    above covers them), the package's top-level names load lazily, and
    every name of the reference's ``__all__`` resolves in the port, from
    the port's own modules."""
    import voxelhex_tpu as ref
    import voxelhex_tpu_torch as vt

    files = _port_files()
    for mod in (os.path.join("io", "checkpoint.py"), os.path.join("diff", "render.py"),
                os.path.join("diff", "fit.py"), os.path.join("ops", "albedo.py")):
        assert os.path.join(PKG, mod) in files, mod
    assert os.path.exists(os.path.join(PKG, "csrc", "albedo.cu"))
    from voxelhex_tpu_torch.io import checkpoint
    from voxelhex_tpu_torch.tree.boxtree import BoxTree

    assert vt.BoxTree is BoxTree and vt.save_tree is checkpoint.save_tree
    for name in ("Albedo", "Entry", "flatten", "fastest_renderer", "Camera", "orbit_camera",
                 "load_vox_tree", "load_vox_tree_cached", "load_vox_scene", "load_tree",
                 "save_flat", "load_flat", "bencode", "SoftRenderer", "StreamingView"):
        assert getattr(vt, name) is not None, name
    from voxelhex_tpu_torch.render.streaming import StreamingView

    assert vt.StreamingView is StreamingView
    from voxelhex_tpu_torch.serve import RenderService
    from voxelhex_tpu_torch.tree.native_edit import NativeEditTree

    assert vt.RenderService is RenderService and vt.NativeEditTree is NativeEditTree
    assert vt.__all__ == ref.__all__
    for name in ref.__all__:
        got = getattr(vt, name)
        assert got is not None, name
        home = getattr(got, "__module__", None) or getattr(got, "__name__", None)
        assert home is None or home.startswith("voxelhex_tpu_torch"), (name, home)
    with pytest.raises(AttributeError):
        vt.no_such_name  # noqa: B018


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
