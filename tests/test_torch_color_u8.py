"""The renderer's ``color_u8`` (the reference's u8 device color grid), on
the CPU, against the reference's ``BitGridRenderer(color_u8=True)``: the
grid's dtype and bytes (u8 where every real palette index is at most 253,
u16 where the palette is larger), the colorless voxel resolved through the
u8 grid by ``trace`` of the stack and the skip tracer, the frames of
``render``, ``tracer="skip"`` and ``render_lod`` over the u8 grid, a tree
swapped in with the other storage, and ``RenderService``'s edit keeping
u8.  The scenes are ``test_bitgrid.py``'s ``test_color_u8_grid_bit_exact``
ones."""

import numpy as np
import pytest
import torch
from test_torch_skip import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

RES = (48, 32)


def small_palette_tree(package):
    """300 random voxels of colors from 220 values of red (the palette fits
    a byte) and a colorless voxel at (1, 1, 1)."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    tree = boxtree.BoxTree(64, 4, auto_simplify=False)
    rng = np.random.default_rng(9)
    for _ in range(300):
        p = tuple(int(v) for v in rng.integers(0, 64, 3))
        tree.insert(p, boxtree.Albedo(int(rng.integers(30, 250)), 90, 120, 255))
    tree.insert((1, 1, 1), boxtree.Entry(data=5))
    return tree


def big_palette_tree(package):
    """272 voxels of distinct colors: the palette does not fit a byte."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    big = boxtree.BoxTree(64, 4, auto_simplify=False)
    for r in range(16):
        for g in range(17):
            big.insert((r, g, 1), boxtree.Albedo(50 + r * 10 % 200, 30 + g * 9 % 200,
                                                 (r * 17 + g) % 255, 255))
    return big


@pytest.fixture(scope="module")
def small():
    return small_palette_tree("voxelhex_tpu"), small_palette_tree("voxelhex_tpu_torch")


def test_color_grid_dtype_and_bytes_equal_reference(small):
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    for ref_tree, tree, dtype in ((*small, torch.uint8),
                                  (big_palette_tree("voxelhex_tpu"),
                                   big_palette_tree("voxelhex_tpu_torch"), torch.int16)):
        want = np.asarray(BitGridRenderer(ref_tree, color_u8=True).tree["colors"])
        port = fastest_renderer(tree, device="cpu", color_u8=True)
        got = port.tree["colors"]
        assert got.dtype == dtype and port.color_u8
        np.testing.assert_array_equal(got.numpy().view(want.dtype), want)
        assert fastest_renderer(tree, device="cpu").tree["colors"].dtype == torch.int16


def test_u8_trace_and_frames_equal_reference(small):
    """The colorless voxel through ``trace`` of both tracers is
    ``0x3FFFFFFE``; the stack tracer's trace and its u8 and f32 frames
    equal the reference's (without compaction, one program to compile; the
    same frames); the trace and frames of both tracers equal the u16
    grid's (``test_torch_skip.py`` holds the skip tracer's u16 route to the
    reference); a u16 tree swapped into a u8 renderer (and back) renders
    the same frame."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera

    o = torch.tensor([[1.5, 1.5, -3.0], [30.5, 20.5, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.0, 0.995]])
    d = d / d.norm(dim=1, keepdim=True)
    cam, ref_cam = orbit_camera(64.0, resolution=RES), ref_orbit(64.0, resolution=RES)
    ref = BitGridRenderer(small[0], color_u8=True)
    for tracer in ("stack", "skip"):
        port = fastest_renderer(small[1], device="cpu", color_u8=True, tracer=tracer)
        u16 = fastest_renderer(small[1], device="cpu", tracer=tracer)
        assert port.tree["colors"].dtype == torch.uint8
        got = port.trace(o, d)
        assert bool(got[0][0]) and int(got[1][0]) == 0x3FFFFFFE
        for g, h in zip(got, u16.trace(o, d)):
            np.testing.assert_array_equal(g.numpy(), h.numpy())
        if tracer == "stack":
            for g, w in zip(got, ref.trace(o.numpy(), d.numpy())):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for u8 in (True, False):
            frame = port.render(cam, out_u8=u8)
            np.testing.assert_array_equal(frame, u16.render(cam, out_u8=u8))
            if tracer == "stack":
                want = np.asarray(ref.render(ref_cam, out_u8=u8, compact=False))
                np.testing.assert_array_equal(frame, want)
    port.tree = device_bitgrid(port.bitgrid, "cpu", skip_rows=True)
    port.invalidate_beam()
    np.testing.assert_array_equal(port.render(cam), u16.render(cam))
    port.tree = device_bitgrid(port.bitgrid, "cpu", skip_rows=True, color_u8=port.color_u8)
    port.invalidate_beam()
    assert port.tree["colors"].dtype == torch.uint8
    np.testing.assert_array_equal(port.render(cam), u16.render(cam))


def test_u8_render_lod_equals_reference(small):
    """``render_lod`` over the u8 grid: the reference's frame at a scale
    where rays stop at level 0 and above it, shading from the MIP levels;
    the MIP grids sit beside the u8 colors."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    ref = BitGridRenderer(small[0], color_u8=True)
    port = fastest_renderer(small[1], device="cpu", color_u8=True)
    cam, ref_cam = (f(64.0, resolution=RES, distance_factor=1.2) for f in (orbit_camera,
                                                                           ref_orbit))
    want = np.asarray(ref.render_lod(ref_cam, 0.3))
    np.testing.assert_array_equal(port.render_lod(cam, 0.3), want)
    assert port.tree["colors"].dtype == torch.uint8 and "mip_rgb_0" in port.tree


def test_render_service_edit_keeps_u8(small):
    """``RenderService``'s edit re-upload keeps the renderer's u8 storage, as
    the reference's does; the next frame equals a fresh u8 renderer's."""
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.serve import RenderService
    from voxelhex_tpu_torch.tree.flat import flatten

    tree = small_palette_tree("voxelhex_tpu_torch")
    svc = RenderService(tree, device="cpu")
    svc.renderer = fastest_renderer(flatten(tree), device="cpu", color_u8=True)
    pose = dict(origin=(80.0, 70.0, 90.0), target=(32.0, 8.0, 32.0), resolution=RES)
    before = svc.render(**pose)
    assert svc.apply_edits({"op": "insert", "pos": [30, 4, 30], "size": 4,
                            "color": [200, 40, 40, 255]}) == 1
    assert svc.renderer.tree["colors"].dtype == torch.uint8
    after = svc.render(**pose)
    fresh = RenderService(tree, device="cpu")
    fresh.renderer = fastest_renderer(flatten(tree), device="cpu", color_u8=True)
    np.testing.assert_array_equal(after, fresh.render(**pose))
    assert (after != before).any()
