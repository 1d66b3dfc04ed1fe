"""The port's skip tracer (plain versions, on the CPU) against the
reference's ``make_skip_tracer`` and its renderer under ``tracer="skip"``,
bit for bit: the skip rows and their index, ``trace()``, frames in u8 and
f32 at ``skip_substeps`` 1 and 3, with the splat prepass at 3 (and their
equality to the stack frames, which the reference's own test shows), and
a beam frame.  The batch paths and the depth prepass are in
``test_torch_skip_batch.py``.

Both packages hold the reference test's 64^3 scene (``test_bitgrid.py``
``make_scene(64, 4)``): 4096 random voxels and a 4^3 block."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

RES = (96, 64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the plain renderers: their many small ops run
    faster so, and do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_scene(package, size=64, seed=9):
    """``test_bitgrid.py``'s ``make_scene(size, 4)`` in the reference's
    (``voxelhex_tpu``) or the port's (``voxelhex_tpu_torch``) BoxTree."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    red = boxtree.Albedo.from_u32(0xFF0000FF)
    green = boxtree.Albedo.from_u32(0x00FF00FF)
    tree = boxtree.BoxTree(size, 4, auto_simplify=False)
    rng = np.random.default_rng(seed)
    for _ in range(size * size):
        p = tuple(int(v) for v in rng.integers(0, size, 3))
        tree.insert(p, red if rng.random() < 0.5 else green)
    tree.insert_at_lod((8, 8, 8), 4, green)
    return tree


@pytest.fixture(scope="module")
def scenes():
    return make_scene("voxelhex_tpu"), make_scene("voxelhex_tpu_torch")


def camera_pair(res=RES, **kw):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    return ref_orbit(64.0, resolution=res, **kw), orbit_camera(64.0, resolution=res, **kw)


def test_skip_rows_equal_reference(scenes):
    """``build_skip_rows`` and ``skip_row_index`` give the reference's
    arrays, and the device tree carries the rows only when asked."""
    from voxelhex_tpu.render import bitgrid as ref_bg
    from voxelhex_tpu.tree.flat import flatten as ref_flatten
    from voxelhex_tpu_torch.render import bitgrid as bgmod

    ref_grid = ref_bg.build_bitgrid(ref_flatten(scenes[0]))
    grid = bgmod.build_bitgrid(scenes[1])
    rows = bgmod.build_skip_rows(grid)
    assert rows.dtype == np.uint32 and rows.shape == (16**3, 2 * grid.n_levels)
    np.testing.assert_array_equal(rows, np.asarray(ref_bg.build_skip_rows(ref_grid)))
    np.testing.assert_array_equal(bgmod.skip_row_index(grid), ref_bg.skip_row_index(ref_grid))
    tree = bgmod.device_bitgrid(grid, "cpu", skip_rows=True)
    np.testing.assert_array_equal(tree["skip_rows"].numpy().view(np.uint32), rows)
    assert "skip_rows" not in bgmod.device_bitgrid(grid, "cpu")


def test_skip_trace_equals_reference(scenes):
    """``trace()`` on the reference test's 3000 rays (``test_skip_tracer_
    matches_stack``): every output exact.  (On the last ``R % 8`` rays of a
    batch, which XLA:CPU computes in its scalar remainder loop with one more
    multiply-add fused, a point may differ in its last bits, as for the
    stack tracer: ROADMAP.md queue 3.)"""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    n = 3000
    rng = np.random.default_rng(23)
    targets = rng.random((n, 3)) * 64
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (targets - dirs * 200).astype(np.float32)
    dirs = dirs.astype(np.float32)
    ref = BitGridRenderer(scenes[0], tracer="skip")
    port = fastest_renderer(scenes[1], device="cpu", tracer="skip")
    want = [np.asarray(x) for x in ref.trace(origins, dirs)]
    got = [x.numpy() for x in port.trace(torch.from_numpy(origins), torch.from_numpy(dirs))]
    assert want[0].sum() > n // 3  # a real share of the rays hit
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("substeps", [1, 3])
def test_skip_frames_equal_reference(scenes, substeps):
    """``render`` in u8 and f32, equal to the reference's skip renderer,
    also with the splat prepass at 3 substeps; the u8 frames also equal the
    stack frame (the reference's
    ``test_skip_tracer_compacted_frame_bit_exact``)."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    ref = BitGridRenderer(scenes[0], tracer="skip", skip_substeps=substeps)
    port = fastest_renderer(scenes[1], device="cpu", tracer="skip", skip_substeps=substeps)
    ref_cam, cam = camera_pair()
    stack = fastest_renderer(scenes[1], device="cpu").render(cam, out_u8=True)
    for out_u8 in (True, False):
        for splat in (False, True) if substeps == 3 else (False,):
            want = np.asarray(ref.render(ref_cam, out_u8=out_u8, splat_prepass=splat))
            got = port.render(cam, out_u8=out_u8, splat_prepass=splat)
            np.testing.assert_array_equal(got, want)
            assert port.last_stats["prepass"] == ("splat" if splat else None)
            if out_u8:
                np.testing.assert_array_equal(got, stack)
    assert stack.any()


def test_skip_beam_frame_equals_reference(scenes):
    """``render(beam_prepass=True)`` under the skip tracer: the beam marches
    the stack automaton on its dilated grid, the frame the skip tracer from
    the beam's starts, as the reference's; ``FramePipeline`` passes the
    keyword through to the skip renderer."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.pipeline import FramePipeline

    ref = BitGridRenderer(scenes[0], tracer="skip")
    port = fastest_renderer(scenes[1], device="cpu", tracer="skip")
    ref_cam, cam = camera_pair(distance_factor=1.8, yaw_deg=100.0)
    assert ref._beam_spec(ref_cam) is not None
    want = np.asarray(ref.render(ref_cam, out_u8=True, beam_prepass=True))
    got = port.render(cam, out_u8=True, beam_prepass=True)
    np.testing.assert_array_equal(got, want)
    assert port.last_stats["prepass"] == "beam"
    pipe = FramePipeline(port)
    np.testing.assert_array_equal(pipe.render(cam, out_u8=True, beam_prepass=True).result(),
                                  want)
    pipe.close()


def test_skip_substeps_and_rows_checks(scenes):
    """``skip_substeps`` below 1 raises; a tree without skip rows cannot
    march the skip tracer; ``invalidate_beam`` derives the rows of a
    re-uploaded tree."""
    from voxelhex_tpu_torch.ops.skip import trace_skip
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import build_skip_rows, device_bitgrid

    with pytest.raises(ValueError, match="skip_substeps"):
        fastest_renderer(scenes[1], device="cpu", tracer="skip", skip_substeps=0)
    port = fastest_renderer(scenes[1], device="cpu", tracer="skip")
    o = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="skip rows"):
        trace_skip(device_bitgrid(port.bitgrid, "cpu"), o, o)
    port.tree = device_bitgrid(port.bitgrid, "cpu")
    port.invalidate_beam()
    np.testing.assert_array_equal(port.tree["skip_rows"].numpy().view(np.uint32),
                                  build_skip_rows(port.bitgrid))
