"""The port's distance LOD (plain versions, on the CPU) against the
reference renderer's, bit for bit: ``build_mip_colors``, the stop levels'
threshold table against the reference's ``log2`` formula, and
``BitGridRenderer.render_lod`` at ``lod_scale`` 0, 0.3 and 0.05; and the
reference's two traps around it, which the port does not copy (ROADMAP.md
queue 3): a skip renderer loses its rows to ``render_lod``, and an edit
made in place keeps the MIP colors of the content before it."""

import numpy as np
import pytest
import torch

from test_torch_prepass import camera_pair, make_scene, one_thread  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

RES = (64, 48)


@pytest.fixture(scope="module")
def scenes():
    return make_scene("voxelhex_tpu"), make_scene("voxelhex_tpu_torch")


@pytest.fixture(scope="module")
def renderers(scenes):
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    return BitGridRenderer(scenes[0]), fastest_renderer(scenes[1], device="cpu")


@pytest.mark.parametrize("size", [64, 48, 20])
def test_build_mip_colors_equals_reference(size):
    """Every level's MIP colors, bit for bit, on random grids whose side is
    a power of 4, and is not (48: levels of 12, 3, 1 cells; 20: 5, 1)."""
    from voxelhex_tpu.render import bitgrid as ref_bg
    from voxelhex_tpu_torch.render import bitgrid as bg

    rng = np.random.default_rng(size)
    occ = rng.random((size, size, size)) < 0.1
    colors = np.where(occ, rng.integers(0, 9, occ.shape), 0xFFFF).astype(np.uint16)
    colors[occ & (rng.random(occ.shape) < 0.1)] = 0xFFFE
    colors = np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel()
    pal = rng.random((9, 4)).astype(np.float32)
    ref = ref_bg.bitgrid_from_occupancy(occ, palette=pal)
    ref.colors = colors
    port = bg.bitgrid_from_grids(occ, colors, pal)
    ref_bg.build_mip_colors(ref)
    assert bg.build_mip_colors(port) is port
    assert len(port.mip_rgb) == len(ref.mip_rgb) >= 2
    for a, b in zip(port.mip_rgb, ref.mip_rgb):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    tree = bg.device_bitgrid(port, "cpu")
    assert [tuple(tree[f"mip_rgb_{l}"].shape) for l in range(len(port.mip_rgb))] == \
        [m.shape for m in ref.mip_rgb]


def test_lod_thresholds_equal_reference_formula():
    """The stop level through LOD_THRESHOLDS equals the reference's
    clip(int(log2(max(x, 1)) * 0.5), 0, top) under XLA:CPU: at each
    threshold and the f32 just below it, at the powers of 4 and their
    neighbours, on random values, at 0, below 1, inf and NaN."""
    from voxelhex_tpu_torch.render.bitgrid import LOD_THRESHOLDS, lod_stop_level

    top = len(LOD_THRESHOLDS)
    formula = jax.jit(lambda x: jnp.clip(
        (jnp.log2(jnp.maximum(x, 1.0)) * 0.5).astype(jnp.int32), 0, top))
    t = np.asarray(LOD_THRESHOLDS, dtype=np.float32)
    assert np.array_equal(t.astype(np.float64), np.asarray(LOD_THRESHOLDS))  # f32 values
    below = np.nextafter(t, np.float32(0))
    np.testing.assert_array_equal(np.asarray(formula(t)), np.arange(1, top + 1))
    np.testing.assert_array_equal(np.asarray(formula(below)), np.arange(0, top))
    pow4 = np.float32(4.0) ** np.arange(1, top + 2, dtype=np.float32)
    rng = np.random.default_rng(0)
    x = np.concatenate([
        t, below, np.nextafter(t, np.float32(np.inf)), pow4, np.nextafter(pow4, np.float32(0)),
        np.nextafter(pow4, np.float32(np.inf)),
        rng.uniform(0.0, 4.0**(top + 1), 200_000).astype(np.float32),
        np.exp2(rng.uniform(0.0, 2 * top + 2, 200_000)).astype(np.float32),
        np.asarray([0.0, 0.5, 1.0, np.inf, np.nan, -3.0], dtype=np.float32)])
    want = np.asarray(formula(x))
    for clip in (top, 2, 0):
        got = lod_stop_level(torch.from_numpy(x), clip).numpy()
        np.testing.assert_array_equal(got, np.minimum(want, clip))


@pytest.mark.parametrize("scale", [0.0, 0.3, 0.05])
@pytest.mark.parametrize("yaw", [40.0, 130.0])
def test_render_lod_equals_reference(renderers, scale, yaw):
    """``render_lod`` f32 frames at 64 x 48 with a background, equal to the
    reference's; at 0 the frame is ``render``'s, at the positive scales
    some rays stop above level 0."""
    from voxelhex_tpu_torch.ops.frame import lod_tracer
    from voxelhex_tpu_torch.render.camera import device_rays

    ref, port = renderers
    ref_cam, cam = camera_pair(RES, yaw=yaw)
    want = np.asarray(ref.render_lod(ref_cam, lod_scale=scale, bg=(0.1, 0.2, 0.3)))
    got = port.render_lod(cam, lod_scale=scale, bg=(0.1, 0.2, 0.3))
    assert got.dtype == np.float32 and got.shape == (RES[1], RES[0], 3)
    np.testing.assert_array_equal(got, want)
    if scale == 0.0:
        np.testing.assert_array_equal(got, port.render(cam, bg=(0.1, 0.2, 0.3)))
    else:
        trace = lod_tracer(port.tree, scale)
        o, d = device_rays(cam, "cpu")
        st = trace.run(port.tree, trace.init(port.tree, o, d), port.max_iters)
        assert bool((st["hlev"][st["hit"]] > 0).any())


def test_reference_trap_skip_renderer_loses_its_rows(scenes):
    """The reference's ``render_lod`` re-uploads its tree without the skip
    rows, so a skip renderer's next ``render`` raises ``KeyError``; the
    port's adds the MIP grids beside them and renders on."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    ref = BitGridRenderer(scenes[0], tracer="skip")
    port = fastest_renderer(scenes[1], device="cpu", tracer="skip")
    ref_cam, cam = camera_pair((32, 24))
    before = port.render(cam, out_u8=True)
    np.testing.assert_array_equal(before, np.asarray(ref.render(ref_cam, out_u8=True)))
    np.testing.assert_array_equal(port.render_lod(cam, 0.3),
                                  np.asarray(ref.render_lod(ref_cam, 0.3)))
    with pytest.raises(KeyError, match="skip_rows"):
        ref.render(ref_cam, out_u8=True)
    assert "skip_rows" in port.tree and "mip_rgb_0" in port.tree
    np.testing.assert_array_equal(port.render(cam, out_u8=True), before)


def test_reference_trap_in_place_edit_keeps_old_mip_colors(scenes):
    """An edit made in place (the BitGrid's colors repainted, the tree
    re-uploaded, ``invalidate_beam``): the reference's ``render_lod`` goes
    on from the MIP colors of the content before; the port's drops them
    with the content and equals a new reference renderer's."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer, device_bitgrid as ref_device
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    ref = BitGridRenderer(scenes[0])
    port = fastest_renderer(scenes[1], device="cpu")
    ref_cam, cam = camera_pair((32, 24))
    np.testing.assert_array_equal(port.render_lod(cam, 0.3),
                                  np.asarray(ref.render_lod(ref_cam, 0.3)))
    for r, upload in ((ref, ref_device), (port, lambda b: device_bitgrid(b, "cpu"))):
        cols = np.asarray(r.bitgrid.colors)
        r.bitgrid.colors = np.where(cols < 0xFFFE, 1, cols).astype(np.uint16)  # repaint
        r.tree = upload(r.bitgrid)
        r.invalidate_beam()
    assert ref.bitgrid.mip_rgb is not None and port.bitgrid.mip_rgb is None
    fresh = BitGridRenderer(ref.bitgrid.__class__(**{**ref.bitgrid.__dict__, "mip_rgb": None}))
    want = np.asarray(fresh.render_lod(ref_cam, 0.3))
    stale = np.asarray(ref.render_lod(ref_cam, 0.3))
    assert not np.array_equal(stale, want)
    np.testing.assert_array_equal(port.render_lod(cam, 0.3), want)
