"""The port's streaming view against the reference's, on the CPU.

Trees are built in both packages from the same seeded NumPy inputs; views
of both run the same scripted updates.  After each update the port's view
state (mirrors, region sets, uploads, origin, the window's host BitGrid
and its device grids) equals the reference's, and frames equal the
reference's bit for bit, f32 and u8.  The window's device updates (the
region scatter, the coarse rebuild, the window shift) are the plain
versions of ``csrc/stream.cu``, held to the reference's XLA programs.
"""

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from voxelhex_tpu.render import streaming as ref_streaming  # noqa: E402
from voxelhex_tpu.render.camera import Camera as RefCamera  # noqa: E402
from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo  # noqa: E402
from voxelhex_tpu.tree.boxtree import BoxTree as RefBoxTree  # noqa: E402
from voxelhex_tpu.tree.build import from_voxels as ref_from_voxels  # noqa: E402
from voxelhex_tpu_torch.render import streaming  # noqa: E402
from voxelhex_tpu_torch.render.camera import Camera  # noqa: E402
from voxelhex_tpu_torch.scene import terrain_points  # noqa: E402
from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree  # noqa: E402
from voxelhex_tpu_torch.tree.build import from_voxels  # noqa: E402

WORLD, VIEW = 256, 64
RES = (64, 48)


def cameras(eye, target, res=RES, fov=55.0):
    """The same camera in both packages."""
    eye, target = np.asarray(eye, dtype=np.float64), np.asarray(target, dtype=np.float64)
    return (RefCamera(origin=eye, target=target, resolution=res, fov_y_deg=fov),
            Camera(origin=eye, target=target, resolution=res, fov_y_deg=fov))


def terrain_trees(world=WORLD):
    pts, cols = terrain_points(world)
    return (ref_from_voxels(pts, cols, size=world, brick_dim=4),
            from_voxels(pts, cols, size=world, brick_dim=4))


def views(trees, **kw):
    ref_tree, tree = trees
    return (ref_streaming.StreamingView(ref_tree, **kw),
            streaming.StreamingView(tree, **kw, device="cpu"))


def state(view, ref):
    """The view's state as NumPy, the device grids as their u16 / u32 bits."""
    r = view.renderer
    colors, pairs = r.tree["colors"], r.tree["occ_pairs"]
    if ref:
        colors, pairs = np.asarray(colors), np.asarray(pairs)
    else:
        colors, pairs = colors.numpy().view(np.uint16), pairs.numpy().view(np.uint32)
    return {"occ": view._occ.copy(), "col": view._col.copy(), "dirty": set(view._dirty),
            "resident": set(view._resident), "placeholder": set(view._placeholder),
            "occluded": set(view._occluded), "uploads": view.uploads,
            "origin": tuple(int(v) for v in view.origin),
            "occ_lo": r.bitgrid.occ_lo.copy(), "occ_hi": r.bitgrid.occ_hi.copy(),
            "colors": np.asarray(r.bitgrid.colors).copy(),
            "dev_colors": np.asarray(colors, dtype=np.uint16).reshape(-1).copy(),
            "dev_pairs": np.asarray(pairs, dtype=np.uint32).reshape(-1, 2).copy()}


def assert_state_equal(a, b):
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def render_both(ref_view, view, cams, out_u8):
    a = np.asarray(ref_view.render(cams[0], out_u8=out_u8))
    b = view.render(cams[1], out_u8=out_u8)
    return a, b


def assert_frames_equal(ref_view, view, cams, formats=(True, False)):
    """The pose's frame in each format (u8: True, f32: False), equal to the
    reference's."""
    for out_u8 in formats:
        a, b = render_both(ref_view, view, cams, out_u8)
        assert b.dtype == (np.uint8 if out_u8 else np.float32) and np.array_equal(a, b)


# ---- the device updates' plain versions against the reference's programs

@pytest.mark.parametrize("wide", [False, True])
def test_region_scatter_plain_equals_reference(wide):
    from voxelhex_tpu_torch.ops.stream import region_scatter_plain

    S, K = 64, 7
    rng = np.random.default_rng(1 + wide)
    colors = rng.integers(0, 2**16, S**3).astype(np.uint16)
    pairs = rng.integers(0, 2**32, ((S // 4) ** 3 + 65, 2), dtype=np.uint64).astype(np.uint32)
    n = S // 16
    picks = rng.choice(n**3, K, replace=False)
    corners = (np.stack([picks % n, picks // n % n, picks // (n * n)], 1) * 16).astype(np.int32)
    vals = (rng.integers(0, 2**16, (K, 4096)).astype(np.uint16) if wide
            else rng.integers(0, 256, (K, 4096)).astype(np.uint8))
    blk = rng.integers(0, 2**32, (K, 64, 2), dtype=np.uint64).astype(np.uint32)
    want = ref_streaming._make_region_scatter(S)(jnp.asarray(colors), jnp.asarray(pairs),
                                                 jnp.asarray(corners), jnp.asarray(vals),
                                                 jnp.asarray(blk))
    got_c = torch.from_numpy(colors.view(np.int16).copy())
    got_p = torch.from_numpy(pairs.view(np.int32).copy())
    v = torch.from_numpy(vals.view(np.int16) if wide else vals)
    region_scatter_plain(got_c, got_p, torch.from_numpy(corners), v,
                         torch.from_numpy(blk.view(np.int32)), S)
    assert np.array_equal(got_c.numpy().view(np.uint16), np.asarray(want[0]))
    assert np.array_equal(got_p.numpy().view(np.uint32), np.asarray(want[1]))


@pytest.mark.parametrize("corner", [(8, 0, 0), (0, -16, 0), (0, 0, 64), (48, 48, 52),
                                    (64, 64, 64)])
def test_region_corners_off_the_contract_raise(corner):
    """A corner that is not a multiple of 16 in [0, S - 16] raises
    ``ValueError`` on the CPU route and in ``StreamingView``'s partial
    update, before anything is written (the reference's scatter would drop
    such writes, PyTorch's indexing wrap or raise, the kernel write outside
    the window)."""
    from voxelhex_tpu_torch.ops.stream import region_scatter

    S = 64
    tree = BoxTree(S, 4)
    tree.insert_at_lod((3, 4, 5), 1, Albedo(200, 10, 10, 255))
    view = streaming.StreamingView(tree, view_size=S, device="cpu")
    view.render(cameras((-20.0, 30.0, -25.0), (32.0, 32.0, 32.0), res=(16, 12))[1])
    window = view.renderer.tree
    before = {k: window[k].clone() for k in ("colors", "occ_pairs")}
    host = (view.renderer.bitgrid.colors.copy(), view.renderer.bitgrid.occ_lo.copy())
    good = [16, 32, 0]
    corners = torch.tensor([good, list(corner)], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 16 in \\[0, 48\\]"):
        region_scatter(window, corners, torch.zeros((2, 4096), dtype=torch.uint8),
                       torch.zeros((2, 64, 2), dtype=torch.int32))
    if all(c % 16 == 0 for c in corner):
        with pytest.raises(ValueError, match="multiples of 16"):
            view._update_device_partial([tuple(c // 16 for c in good),
                                         tuple(c // 16 for c in corner)])
    assert all(torch.equal(window[k], before[k]) for k in before)
    assert np.array_equal(view.renderer.bitgrid.colors, host[0])
    assert np.array_equal(view.renderer.bitgrid.occ_lo, host[1])


@pytest.mark.parametrize("S", [48, 64, 128])
def test_coarse_rebuild_plain_equals_reference(S):
    """At 48 and 128 a level's blocks an axis are not a multiple of 4."""
    from voxelhex_tpu_torch.ops.stream import coarse_rebuild_plain
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, level_dims

    bg = bitgrid_from_occupancy(np.zeros((S, S, S), dtype=bool))
    nb = S // 4
    rng = np.random.default_rng(S)
    pairs = np.zeros((bg.occ_lo.shape[0], 2), dtype=np.uint32)
    pairs[: nb**3] = (rng.random((nb**3, 2)) < 0.03) * rng.integers(1, 2**32, (nb**3, 2))
    want = np.asarray(ref_streaming._make_coarse_rebuild(S)(jnp.asarray(pairs)))
    got = coarse_rebuild_plain(torch.from_numpy(pairs.view(np.int32).copy()),
                               [int(b) for b in bg.level_bases], level_dims(S, bg.n_levels))
    assert np.array_equal(got.numpy().view(np.uint32), want)


# ---- a scripted flight over the terrain: state after each update, frames

# the window's targets: moves of one region (the partial path), of three
# (a full rebuild), back, and along y and z
FLIGHT = [(60.0, 13.0, 100.0), (76.0, 13.0, 100.0), (124.0, 13.0, 116.0),
          (92.0, 13.0, 116.0), (92.0, 70.0, 100.0), (108.0, 40.0, 84.0)]


def flight_camera(i, res=RES):
    t = np.asarray(FLIGHT[i])
    return cameras(t + np.array([-20.0, 18.0, -30.0]), t, res)


@pytest.fixture(scope="module")
def flight():
    """The flight through both packages' views (one ring at factor 4): each
    step's state after the frame's update and its u8 frame, and the last
    pose's f32 frame.  Later tests go on with the two views (each test sets
    what it needs, and both views see the same calls, so they stay equal
    whatever ran before)."""
    ref_view, view = views(terrain_trees(), view_size=VIEW, regions_per_update=8192)
    steps = []
    for i in range(len(FLIGHT)):
        frames = render_both(ref_view, view, flight_camera(i), True)
        steps.append((state(ref_view, True), state(view, False), frames))
    f32 = render_both(ref_view, view, flight_camera(len(FLIGHT) - 1), False)
    return ref_view, view, steps, f32


@pytest.mark.parametrize("step", range(len(FLIGHT)))
def test_flight_state_equals_reference(flight, step):
    ref_state, port_state, _frames = flight[2][step]
    assert_state_equal(ref_state, port_state)


@pytest.mark.parametrize("step", range(len(FLIGHT)))
def test_flight_frames_equal_reference(flight, step):
    a, b = flight[2][step][2]
    assert b.dtype == np.uint8 and b.shape == (RES[1], RES[0], 3)
    assert (a.sum(-1) > 0).sum() > RES[0] * RES[1] // 4  # the terrain fills the frame
    assert np.array_equal(a, b)


def test_flight_f32_frame_equals_reference(flight):
    a, b = flight[3]
    assert b.dtype == np.float32 and np.array_equal(a, b)


def test_flight_took_both_device_paths(flight):
    """A move of one region pages 16 of the window's 64 regions (the partial
    path); a move of three regions along x and one along z pages 52 (more
    than half: a full rebuild)."""
    uploads = [s[1]["uploads"] for s in flight[2]]
    assert uploads[1] - uploads[0] == 16 and uploads[2] - uploads[1] == 52


def test_window_shift_plain_equals_reference(flight):
    """The plain shift against the reference's ``roll_zero`` (the JAX view's
    own, after its flight's moves)."""
    from voxelhex_tpu_torch.ops.stream import window_shift_plain

    ref_view = flight[0]
    S = 64
    rng = np.random.default_rng(9)
    colors = rng.integers(0, 2**16, S**3).astype(np.uint16)
    pairs = rng.integers(0, 2**32, ((S // 4) ** 3, 2), dtype=np.uint64).astype(np.uint32)
    for shift in [(16, 0, 32), (-16, -48, 0), (32, -16, 16), (64, 0, 0)]:
        s = jnp.asarray(np.asarray(shift, dtype=np.int32))
        want_c = ref_view._roll_fn(jnp.asarray(colors).reshape(S, S, S), s,
                                   jnp.asarray(0xFFFF, jnp.uint16))
        want_p = ref_view._roll_fn(jnp.asarray(pairs).reshape(S // 4, S // 4, S // 4, 2), s // 4,
                                   jnp.asarray(0, jnp.uint32))
        got_c, got_p = window_shift_plain(torch.from_numpy(colors.view(np.int16)),
                                          torch.from_numpy(pairs.view(np.int32)), S, shift)
        assert np.array_equal(got_c.numpy().view(np.uint16), np.asarray(want_c).reshape(-1))
        assert np.array_equal(got_p.numpy().view(np.uint32), np.asarray(want_p).reshape(-1, 2))


# ---- the window without a far field, budgets, occlusion, edits, palettes


def test_window_only_frames_equal_reference():
    ref_view, view = views(terrain_trees(), view_size=VIEW, regions_per_update=8192,
                           far_field=False)
    for i in (0, 1):
        for out_u8 in (True, False):
            a, b = render_both(ref_view, view, flight_camera(i), out_u8)
            assert view.far is None and np.array_equal(a, b)


@pytest.mark.parametrize("far_field", [True, False])
def test_beam_prepass_frames_equal_reference(far_field):
    """``StreamingView(beam_prepass=True)`` over a short flight, with its
    far field and without: the window's rays start from the window
    renderer's beam (re-derived after each update), frames equal to the
    reference's: u8 at the first pose, then u8 with the rings and f32
    without them at the second."""
    ref_view, view = views(terrain_trees(), view_size=VIEW, regions_per_update=8192,
                           far_field=far_field, beam_prepass=True)
    for i in (0, 1):
        a, b = render_both(ref_view, view, flight_camera(i), far_field or i == 0)
        assert np.array_equal(a, b)
        cam_local = view.layers(flight_camera(i)[1])[0][1]
        assert view.renderer._beam_spec(cam_local) is not None
        assert (view.far is not None) == far_field
    assert view.renderer._beam_grids  # the beam ran on the window's content


def test_update_rebuilds_the_levels_once(monkeypatch):
    """An update that shifts the window and pages the exposed regions
    through the partial scatter writes level 0 twice and rebuilds the
    levels above once, after both; the full upload of the first update
    rebuilds none.  Each update's state equals the reference's."""
    ref_view, view = views(terrain_trees(), view_size=VIEW, regions_per_update=8192,
                           far_field=False)
    calls = {"coarse_rebuild": 0, "window_shift": 0, "region_scatter": 0}

    def counted(name):
        fn = getattr(streaming, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(streaming, name, counted(name))
    for i, want in ((0, (0, 0, 0)), (1, (1, 1, 1))):
        before = dict(calls)
        render_both(ref_view, view, flight_camera(i), True)
        assert tuple(calls[k] - before[k] for k in calls) == want
        assert_state_equal(state(ref_view, True), state(view, False))


def test_budgeted_paging_with_placeholders_equals_reference(flight):
    """Eight regions an update with the camera's frustum order, after a
    jump that leaves the whole window to page: placeholder content where
    regions wait, each frame and state equal to the reference's, until
    settled."""
    ref_view, view = flight[0], flight[1]
    cams = cameras((160.0, 31.0, 170.0), (180.0, 13.0, 200.0))
    try:
        ref_view.regions_per_update = view.regions_per_update = 8
        for _ in range(12):
            a, b = render_both(ref_view, view, cams, True)
            assert np.array_equal(a, b)
            assert_state_equal(state(ref_view, True), state(view, False))
            if view.settled():
                break
    finally:
        ref_view.regions_per_update = view.regions_per_update = 8192
    assert view.settled() and ref_view.settled() and view._placeholder == set()
    assert_frames_equal(ref_view, view, cams, formats=(False,))


def _solid_cube_trees():
    """A 64^3 solid cube of 16^3 cells, whose 2^3 interior nodes end up
    occluded (the reference's test_occlusion_prune tree)."""
    trees = (RefBoxTree(256, 4, auto_simplify=True), BoxTree(256, 4, auto_simplify=True))
    cells = [(x, y, z) for x in range(0, 64, 16) for y in range(0, 64, 16)
             for z in range(0, 64, 16)]
    for t, albedo in zip(trees, (RefAlbedo, Albedo)):
        for p in cells:
            t.insert_at_lod(p, 4, albedo(180, 140, 90, 255))
        for p in cells:
            t.insert_at_lod(p, 16, albedo(180, 140, 90, 255))
    return trees


def test_occlusion_pruning_equals_reference():
    ref_view, view = views(_solid_cube_trees(), view_size=64, regions_per_update=16)
    cams = cameras((90.0, 80.0, -40.0), (32.0, 32.0, 32.0))
    for _ in range(8):
        a, b = render_both(ref_view, view, cams, True)
        assert np.array_equal(a, b)
        assert_state_equal(state(ref_view, True), state(view, False))
    assert len(view._occluded) == 8 and not view._dirty
    assert_frames_equal(ref_view, view, cams, formats=(False,))


def test_edits_equal_reference(flight):
    """An insert_at_lod inside the window takes the partial scatter; one
    that adds colors past the palette's padded rows rebuilds in full."""
    ref_view, view = flight[0], flight[1]
    cams = flight_camera(0)
    render_both(ref_view, view, cams, True)
    for t, albedo in ((ref_view.tree, RefAlbedo), (view.tree, Albedo)):
        t.insert_at_lod((64, 16, 100), 4, albedo(250, 20, 20, 255))
    assert 0 < len(view._dirty) <= 8 and view._dirty == ref_view._dirty
    a, b = render_both(ref_view, view, cams, True)
    assert np.array_equal(a, b)
    assert_state_equal(state(ref_view, True), state(view, False))
    rows = view.renderer.bitgrid.palette.shape[0]
    n = len(view.tree.color_palette)
    for k in range(rows - n + 2):
        for t, albedo in ((ref_view.tree, RefAlbedo), (view.tree, Albedo)):
            t.insert((70 + k % 8, 20, 96 + k // 8), albedo(k * 3 % 256, 200, 9, 255))
    a, b = render_both(ref_view, view, cams, True)
    assert view.renderer.bitgrid.palette.shape[0] == 2 * rows
    assert np.array_equal(a, b)
    assert_state_equal(state(ref_view, True), state(view, False))
    assert_frames_equal(ref_view, view, cams, formats=(False,))


def test_large_palette_u16_wire_equals_reference():
    """Past 254 colors regions travel on the u16 wire."""
    trees = (RefBoxTree(256, 4, auto_simplify=False), BoxTree(256, 4, auto_simplify=False))
    for t, albedo in zip(trees, (RefAlbedo, Albedo)):
        for r in range(16):
            for g in range(17):
                t.insert((r, g, 1), albedo(50 + r * 10 % 200, 30 + g * 9 % 200,
                                           (r * 17 + g) % 255, 255))
    assert len(trees[1].color_palette) > 254
    ref_view, view = views(trees, view_size=64, regions_per_update=4096)
    cams = cameras((8.0, 8.0, -30.0), (8.0, 8.0, 1.0), res=(32, 32), fov=30.0)
    render_both(ref_view, view, cams, False)
    for t, albedo in zip(trees, (RefAlbedo, Albedo)):
        t.insert((8, 8, 1), albedo(1, 2, 3, 255))
    assert 0 < len(view._dirty) <= 8
    a, b = render_both(ref_view, view, cams, False)
    assert np.array_equal(a, b) and (b.sum(-1) > 0).sum() > 50
    assert_state_equal(state(ref_view, True), state(view, False))
    assert_frames_equal(ref_view, view, cams, formats=(True,))


def test_async_uploads_converge_to_the_reference(flight):
    """Worker-thread paging, with an edit in between, settles on the sync
    reference's mirrors and frame."""
    ref_view = flight[0]
    tree = flight[1].tree
    view = streaming.StreamingView(tree, view_size=VIEW, regions_per_update=16,
                                   async_uploads=True, device="cpu")
    cams = flight_camera(3)
    target = np.asarray(cams[1].target, dtype=np.float64)
    view.update(target)  # jobs in flight, then an edit drops them
    for t, albedo in ((ref_view.tree, RefAlbedo), (tree, Albedo)):
        t.insert_at_lod((96, 8, 120), 4, albedo(20, 20, 250, 255))
    for _ in range(2000):
        if view.update(target, camera=cams[1]) == 0 and not view._inflight:
            break
        time.sleep(0.002)
    assert_frames_equal(ref_view, view, cams)
    assert view.settled()
    assert np.array_equal(view._occ, ref_view._occ) and np.array_equal(view._col, ref_view._col)
    view.close()


def test_numpy_route_equals_host_library():
    """``native=False`` fills regions one voxel at a time and packs them in
    NumPy: the same state as the host library's route."""
    tree = terrain_trees(64)[1]
    a = streaming.StreamingView(tree, view_size=32, regions_per_update=3, device="cpu")
    b = streaming.StreamingView(tree, view_size=32, regions_per_update=3, device="cpu",
                                native=False)
    for target in ((16.0, 8.0, 16.0), (16.0, 8.0, 16.0), (32.0, 8.0, 16.0)):
        a.update(np.asarray(target))
        b.update(np.asarray(target))
        assert_state_equal(state(a, False), state(b, False))


def test_rasterize_window_and_regions_equal_numpy():
    from voxelhex_tpu_torch import native
    from voxelhex_tpu_torch.render.bitgrid import _dense_from_flat, _pack_bits_batch
    from voxelhex_tpu_torch.tree.flat import flatten

    flat = flatten(terrain_trees(64)[1])
    occ, col = _dense_from_flat(flat)
    for x, y, z, n in ((0, 0, 0, 16), (16, 0, 32, 16), (40, 4, 8, 24), (48, 48, 48, 32)):
        o, c = native.rasterize_window(flat, x, y, z, n)
        want_o = np.zeros((n, n, n), dtype=bool)
        want_c = np.full((n, n, n), 0xFFFF, dtype=np.uint16)
        inner = occ[x:x + n, y:y + n, z:z + n]
        want_o[: inner.shape[0], : inner.shape[1], : inner.shape[2]] = inner
        want_c[: inner.shape[0], : inner.shape[1], : inner.shape[2]] = col[x:x + n, y:y + n,
                                                                           z:z + n]
        assert np.array_equal(o.reshape(n, n, n).transpose(2, 1, 0) != 0, want_o)
        assert np.array_equal(c.reshape(n, n, n).transpose(2, 1, 0), want_c)
    corners = np.array([[0, 0, 0], [16, 0, 48], [48, 0, 32], [64, 0, 0]], dtype=np.int32)
    o, c, lo, hi = native.rasterize_regions(flat, corners, 16)
    grids = np.zeros((4, 16, 16, 16), dtype=bool)
    for k, (x, y, z) in enumerate(corners):
        grids[k] = np.pad(occ, ((0, 16),) * 3)[x:x + 16, y:y + 16, z:z + 16]
        assert np.array_equal(o[k].reshape(16, 16, 16).transpose(2, 1, 0) != 0, grids[k])
    assert grids[:3].any(axis=(1, 2, 3)).all() and not grids[3].any()
    want_lo, want_hi = _pack_bits_batch(grids)
    assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)


def test_options_and_device(monkeypatch):
    tree = BoxTree(64, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.StreamingView(tree, view_size=32)
    # the skip tracer runs (tests/test_torch_streaming_skip.py); other
    # tracers raise
    assert streaming.StreamingView(tree, view_size=32, tracer="skip", device="cpu").tracer == \
        "skip"
    with pytest.raises(NotImplementedError, match="tracer"):
        streaming.StreamingView(tree, view_size=32, tracer="flat", device="cpu")
    # the reference's view keeps `prepass` and never reads it; the beam
    # prepass runs (test_beam_prepass_frames_equal_reference)
    assert streaming.StreamingView(tree, view_size=32, prepass=True, device="cpu")
    assert streaming.StreamingView(tree, view_size=32, beam_prepass=True,
                                   device="cpu").beam_prepass
    view = streaming.StreamingView(tree, 32, 64, False, True, fuse_plan=True, device="cpu")
    assert view.regions_per_update == 64 and not view._async and view.placeholder_lod


def test_viewport_equals_reference():
    from voxelhex_tpu.render.camera import Viewport as RefViewport
    from voxelhex_tpu_torch.render.camera import Viewport

    ref_cam, cam = cameras((3.0, 4.0, -20.0), (5.0, 1.0, 9.0))
    ref, port = RefViewport(ref_cam), Viewport(cam)
    for v in (ref, port):
        v.move_viewport((1.5, -2.0, 0.25))
        v.set_viewport_origin((10.0, 12.0, -3.0))
        v.move_viewport((0.5, 0.5, 0.5))
    assert np.array_equal(ref.origin, port.origin) and np.array_equal(ref.direction,
                                                                      port.direction)
    assert np.array_equal(ref.frustum, port.frustum)
    assert np.array_equal(ref.take_origin_delta(), port.take_origin_delta())
    assert not port.take_origin_delta().any()
    assert np.array_equal(ref.camera.target, port.camera.target)
