"""The port's far field against the reference's, on the CPU: the coarse
samples of the tree, the rings (one whole-world ring, and the ladder of
anchored rings past 4 windows), their frames through the far-frame
kernel's plain version, the tracer's ``start_t`` at its clip, and the
worker-thread refresh.  Bit-exact throughout.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from voxelhex_tpu.render import streaming as ref_streaming  # noqa: E402
from voxelhex_tpu.render.bitgrid import BitGridRenderer as RefRenderer  # noqa: E402
from voxelhex_tpu.render.bitgrid import bitgrid_from_occupancy as ref_from_occupancy  # noqa: E402
from voxelhex_tpu.tree import flat as ref_flat  # noqa: E402
from voxelhex_tpu.tree import mipmap as ref_mip  # noqa: E402
from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo  # noqa: E402
from voxelhex_tpu.tree.build import from_voxels as ref_from_voxels  # noqa: E402
from voxelhex_tpu_torch.ops.far import far_frame_plain, hit_dist  # noqa: E402
from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG, MAX_ITERS  # noqa: E402
from voxelhex_tpu_torch.render import streaming  # noqa: E402
from voxelhex_tpu_torch.render.bitgrid import device_bitgrid, make_bitgrid_tracer  # noqa: E402
from voxelhex_tpu_torch.tree import flat as port_flat  # noqa: E402
from voxelhex_tpu_torch.tree import mipmap as port_mip  # noqa: E402
from voxelhex_tpu_torch.tree.boxtree import Albedo  # noqa: E402
from voxelhex_tpu_torch.tree.build import from_voxels  # noqa: E402

from test_torch_streaming import (  # noqa: E402
    assert_state_equal,
    cameras,
    render_both,
    state,
    terrain_trees,
    views,
)


# ---- the coarse samples of the tree

@pytest.fixture(scope="module", params=[False, True], ids=["no_mips", "mips"])
def flats(request):
    """The same tree in both packages, flattened: random voxels at brick_dim
    4 in a 64 world, with MIP maps or without."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.integers(0, 64, (600, 3)),
                          np.stack(np.meshgrid(np.arange(16, 40), [21], np.arange(8, 30),
                                               indexing="ij"), -1).reshape(-1, 3)])
    cols = (rng.integers(1, 5, (pts.shape[0], 4)) * 50).astype(np.uint8)
    cols[:, 3] = 255
    ref = ref_from_voxels(pts, cols, size=64, brick_dim=4)
    port = from_voxels(pts, cols, size=64, brick_dim=4)
    if request.param:
        for m, t in ((ref_mip, ref), (port_mip, port)):
            m.enable_mips(t, m.MIPStrategy(enabled=True))
    a, b = ref_flat.flatten(ref), port_flat.flatten(port)
    assert (int((b.node_mips >= 0).sum()) > 0) == request.param
    return a, b


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_sample_coarse_equals_reference(flats, g):
    rng = np.random.default_rng(g)
    pts = np.concatenate([rng.integers(0, 64, (3000, 3)),
                          (np.arange(0, 64, g)[:, None] + g // 2).repeat(3, 1)])
    (ro, rc), (po, pc) = (ref_flat.sample_coarse(flats[0], pts, g),
                          port_flat.sample_coarse(flats[1], pts, g))
    assert ro.any() and np.array_equal(ro, po) and np.array_equal(rc, pc)


@pytest.mark.parametrize("g,lo,hi", [(4, (0, 0, 0), (64, 64, 64)), (2, (8, 4, 12), (40, 30, 50)),
                                     (16, (0, 0, 0), (64, 64, 64)), (1, (16, 16, 8), (32, 24, 24))])
def test_coarse_candidate_cells_equal_reference(flats, g, lo, hi):
    a = ref_flat.coarse_candidate_cells(flats[0], g, lo, hi)
    b = port_flat.coarse_candidate_cells(flats[1], g, lo, hi)
    assert a.shape[0] > 0 and np.array_equal(a, b)


# ---- the tracer's start_t at its clip, the rings' distances

def _grazing_rays(size, n, seed):
    """Rays from outside and inside the box [0, size)^3 with starts about
    their exit distance: up to 2e-3 before it (where the clip to tmax - 1e-3
    binds), at it and past it, and zero; a quarter skim a y face."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4, 1] = rng.uniform(-1e-4, 1e-4, n // 4).astype(np.float32)
    o[: n // 4, 1] = np.float32(size) * rng.choice([0.0, 1.0], n // 4).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    S = np.float32(size)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo, t_hi = (np.float32(0) - o) / d, (S - o) / d
    per_max = np.fmax(t_lo, t_hi)
    tmax = np.fmin(np.fmin(per_max[:, 0], per_max[:, 1]), per_max[:, 2])
    k = rng.integers(0, 4, n)
    u = rng.uniform(0, 2e-3, n).astype(np.float32)
    start = np.where(k == 0, tmax - u, np.where(k == 1, tmax, np.where(k == 2, tmax + u, 0)))
    start = np.nan_to_num(start.astype(np.float32), posinf=1e9, neginf=0).astype(np.float32)
    return o, d, start


@pytest.mark.parametrize("size", [16, 64, 256])
def test_start_t_init_equals_reference_at_the_clip(size):
    """``init`` from ``start_t`` on rays that start at their exit: the
    point (the multiply-add XLA:CPU fuses on x and y, not z), the active
    flag and the sectant bit for bit; 4096 rays, a multiple of XLA's 8-wide
    vector loop."""
    rng = np.random.default_rng(size)
    occ = rng.random((size, size, size)) < 0.02
    ref = RefRenderer(ref_from_occupancy(occ))
    o, d, start = _grazing_rays(size, 4096, size)
    st = ref._compact_fns["init"](ref.tree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(start))
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy

    tree = device_bitgrid(bitgrid_from_occupancy(occ), "cpu")
    trace = make_bitgrid_tracer(len(tree["bases"]), size, **KERNEL_CONFIG)
    got = trace.init(tree, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(start))
    assert np.array_equal(got["point"].numpy(), np.asarray(st[0]))
    assert np.array_equal(got["tsect"].numpy(), np.asarray(st[1]))
    assert np.array_equal(got["active"].numpy(), np.asarray(st[10]))
    assert 0 < int(got["active"].sum()) < 4096


def test_hit_dist_equals_reference():
    rng = np.random.default_rng(5)
    p = rng.uniform(-300, 300, (4096, 3)).astype(np.float32)
    o = rng.uniform(-300, 300, (4096, 3)).astype(np.float32)
    hit = rng.random(4096) < 0.7
    for F in (1.0, 4.0, 16.0):
        want = ref_streaming._hit_dist(jnp.asarray(hit), jnp.asarray(p), jnp.asarray(o),
                                       jnp.float32(F))
        got = hit_dist(torch.from_numpy(hit), torch.from_numpy(p), torch.from_numpy(o), F)
        assert np.array_equal(got.numpy(), np.asarray(want))


# ---- frames with one ring (W/S = 4) and with the ladder (W/S = 16)

@pytest.fixture(scope="module")
def one_ring():
    return views(terrain_trees(), view_size=64, regions_per_update=8192)


RES_RAYS = 64 * 48  # test_torch_streaming.RES
# a camera inside the window, and one above it looking down from outside
POSES = {"inside": ((40.0, 31.0, 70.0), (60.0, 13.0, 100.0)),
         "outside": ((20.0, 140.0, 20.0), (120.0, 20.0, 130.0))}


@pytest.mark.parametrize("pose", list(POSES))
@pytest.mark.parametrize("out_u8", [True, False])
def test_one_ring_frames_equal_reference(one_ring, pose, out_u8):
    ref_view, view = one_ring
    cams = cameras(*POSES[pose])
    a, b = render_both(ref_view, view, cams, out_u8)
    assert view.camera_inside(cams[1]) == (pose == "inside")
    assert len(view.far.tiers) == 1 and view.far.factor == 4
    assert np.array_equal(a, b)
    assert np.array_equal(view.far._occ, ref_view.far._occ)
    assert np.array_equal(view.far._col, ref_view.far._col)
    # the rings show content the window does not hold
    stats = []
    window_only = far_frame_plain(view.layers(cams[1])[:1], view.camera_inside(cams[1]),
                                  out_u8=out_u8)
    both = far_frame_plain(view.layers(cams[1]), view.camera_inside(cams[1]), out_u8=out_u8,
                           stats=stats)
    assert np.array_equal(both.numpy(), b) and not np.array_equal(window_only.numpy(), b)
    # no ray comes near the step limit, where the reference's rounds could
    # step a ray further than the kernel
    assert max(int(s["iters"].max()) for s in stats) < MAX_ITERS // 4
    assert [s["rays"] for s in stats][0] == RES_RAYS and any(bool(s["reads"].any())
                                                             for s in stats[1:])



def test_far_field_single_ring_surface(one_ring):
    """``FarField.cells`` and ``FarField.renderer``: the innermost ring's,
    as the reference's single-tier surface, equal to the reference's."""
    ref_view, view = one_ring
    render_both(ref_view, view, cameras(*POSES["outside"]), True)
    assert view.far.cells == ref_view.far.cells == view.far.tiers[0].cells
    assert view.far.renderer is view.far.tiers[0].renderer is not None
    for field in ("occ_lo", "occ_hi", "colors"):
        assert np.array_equal(np.asarray(getattr(view.far.renderer.bitgrid, field)),
                              np.asarray(getattr(ref_view.far.renderer.bitgrid, field)))

def test_far_edit_equals_reference(one_ring):
    """An edit outside the window re-samples the ring's cells there."""
    ref_view, view = one_ring
    cams = cameras(*POSES["outside"])
    render_both(ref_view, view, cams, True)
    for t, albedo in ((ref_view.tree, RefAlbedo), (view.tree, Albedo)):
        t.insert_at_lod((200, 32, 200), 16, albedo(40, 200, 40, 255))
    assert view.far.tiers[0]._dirty_boxes and not view.settled()
    a, b = render_both(ref_view, view, cams, True)
    assert np.array_equal(a, b) and view.settled()
    assert np.array_equal(view.far._occ, ref_view.far._occ)
    assert np.array_equal(view.far._col, ref_view.far._col)


def test_async_far_converges_to_reference(one_ring):
    """Ring refreshes on a worker, with worker-thread paging: once both have
    drained, the frame equals the sync reference's."""
    ref_view = one_ring[0]
    view = streaming.StreamingView(one_ring[1].tree, view_size=64, regions_per_update=4096,
                                   async_uploads=True, async_far=True, device="cpu")
    cams = cameras(*POSES["inside"])
    target = np.asarray(cams[1].target, dtype=np.float64)
    for _ in range(2000):
        if view.update(target, camera=cams[1]) == 0 and not view._inflight:
            break
    for _ in range(100):
        view.render(cams[1], out_u8=True)
        if view.far._job is None:
            break
        view.far._job[0].result()
    a, b = render_both(ref_view, view, cams, True)
    assert view.settled() and np.array_equal(a, b)
    view.close()


# the ladder: a 16 window in a 256 world, rings of 16 cells at factor 4
# (anchored, re-anchoring as the window moves) and 16 (the world); the
# window follows the target across the world
LADDER = [((20.0, 30.0, 20.0), (30.0, 10.0, 40.0)), ((60.0, 14.0, 38.0), (66.0, 10.0, 44.0)),
          ((140.0, 40.0, 150.0), (150.0, 14.0, 170.0)), ((200.0, 90.0, 60.0), (120.0, 10.0, 130.0))]


@pytest.fixture(scope="module")
def ladder():
    ref_view, view = views(terrain_trees(), view_size=16, regions_per_update=8192)
    out = []
    for eye, target in LADDER:
        cams = cameras(eye, target)
        frames = [render_both(ref_view, view, cams, u8) for u8 in (True, False)]
        rings = [(tuple(int(v) for v in a.origin), tuple(int(v) for v in b.origin),
                  np.array_equal(a._occ, b._occ), np.array_equal(a._col, b._col))
                 for a, b in zip(ref_view.far.tiers, view.far.tiers)]
        out.append((frames, rings, state(ref_view, True), state(view, False),
                    view.camera_inside(cams[1])))
    return out


@pytest.mark.parametrize("step", range(len(LADDER)))
def test_ring_ladder_equals_reference(ladder, step):
    frames, rings, ref_state, port_state, _inside = ladder[step]
    assert len(rings) == 2
    for ref_origin, origin, occ_equal, col_equal in rings:
        assert ref_origin == origin and occ_equal and col_equal
    for a, b in frames:
        assert np.array_equal(a, b)
    assert_state_equal(ref_state, port_state)


def test_ring_ladder_re_anchors(ladder):
    """The inner ring moves with the window; the outer one covers the
    world; poses inside and outside the window."""
    origins = {s[1][0][1] for s in ladder}
    assert len(origins) > 1 and all(s[1][1][1] == (0, 0, 0) for s in ladder)
    assert {s[4] for s in ladder} == {True, False}
