"""The port stands alone: no JAX, no reference package, no CPU fallback on
the card, and a smoke run that fails without a GPU."""

import ast
import os
import shutil
import subprocess
import sys

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
