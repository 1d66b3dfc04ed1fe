"""The port's ``render_delta_many`` (plain versions, on the CPU) against the
reference renderer's: the same frames, the same ``delta_fetched`` and
``delta_rows_fetched``, the same shared frame objects, over the reference's
own scenarios (``tests/test_bitgrid.py``: a static pose, a mixed-pose batch,
an edit that moves one band of rows); and the row digest against the
reference's ``_digest``.  Scene, cameras and helpers are
``test_torch_batch.py``'s."""

import numpy as np
import pytest
from test_torch_batch import cameras, make_renderers, make_tree, ref_batch

RES = (160, 90)
A, B = 20.0, 24.0  # two poses close enough to share the reference's plan


@pytest.fixture(scope="module")
def renderers():
    return make_renderers(RES)


def both(renderers, yaws):
    """``render_delta_many`` of the poses ``yaws`` on the reference and on
    the port: ``(ref frames, ref stats, port frames, port stats)``, the
    frames and the fetch counts checked equal."""
    ref, port = renderers
    ref_cams, cams = cameras(RES, yaws)
    want = ref_batch(ref, lambda: ref.render_delta_many(ref_cams), ref_cams)
    got = port.render_delta_many(cams)
    assert len(got) == len(want) == len(yaws)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == (RES[1], RES[0], 3)
        np.testing.assert_array_equal(a, np.asarray(b))
    for k in ("delta_fetched", "delta_rows_fetched", "batched_frames", "rays"):
        assert port.last_stats[k] == ref.last_stats[k], k
    assert port.last_stats["delta"]
    return want, ref.last_stats, got, port.last_stats


def shared(frames):
    """Which frames are the same object as the frame before."""
    return [frames[k] is frames[k - 1] for k in range(1, len(frames))]


def test_static_pose_fetches_once_then_shares(renderers):
    ref, port = renderers
    both(renderers, [B])  # a baseline of another pose
    want, _rs, got, st = both(renderers, [A] * 4)
    assert st["delta_fetched"] == 1 and st["delta_rows_fetched"] == RES[1]
    assert shared(got) == shared(want) == [True] * 3
    np.testing.assert_array_equal(got[0], port.render(cameras(RES, [A])[1][0], out_u8=True))
    again = both(renderers, [A] * 4)[2]
    assert port.last_stats["delta_fetched"] == 0 and port.last_stats["host_reads"] == 1
    assert again[0] is got[-1] and shared(again) == [True] * 3
    # the content-change hook keeps the baseline: unchanged content is digest-only
    ref.invalidate_beam()
    port.invalidate_beam()
    after = both(renderers, [A, A])[2]
    assert port.last_stats["delta_fetched"] == 0 and after[0] is got[-1]


def test_mixed_poses_fetch_the_frames_that_moved(renderers):
    both(renderers, [B])
    want, _rs, got, st = both(renderers, [A, A, B, B])
    assert st["delta_fetched"] == 2  # frames 0 and 2 moved
    assert shared(got) == shared(want) == [True, False, True]
    _w, _r, got2, st2 = both(renderers, [B, A])  # against the last frame, pose B
    assert st2["delta_fetched"] == 1 and got2[0] is got[-1]


def test_edit_fetches_its_row_band(renderers):
    """The reference's edit pattern, on each package's own tree: insert into
    the tree, rebuild the BitGrid, swap it in and call ``invalidate_beam``;
    only the band of rows that the edit moved is fetched and patched into
    the frame before, as the reference's edit of its tree does."""
    from voxelhex_tpu.render.bitgrid import build_bitgrid as ref_build_bitgrid
    from voxelhex_tpu.render.bitgrid import device_bitgrid as ref_device_bitgrid
    from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo
    from voxelhex_tpu_torch.render.bitgrid import build_bitgrid, device_bitgrid
    from voxelhex_tpu_torch.tree.boxtree import Albedo

    ref, port = renderers
    before = (ref.bitgrid, ref.tree, port.bitgrid, port.tree)
    both(renderers, [A])
    ref_tree = make_tree()
    ref_tree.insert_at_lod((12, 8, 12), 2, RefAlbedo(30, 30, 240, 255))
    edited = ref_build_bitgrid(ref_tree)
    ref.bitgrid, ref.tree = edited, ref_device_bitgrid(edited)
    tree = make_tree(package="voxelhex_tpu_torch")
    tree.insert_at_lod((12, 8, 12), 2, Albedo(30, 30, 240, 255))
    port.bitgrid = build_bitgrid(tree)
    for k in ("level_bases", "occ_lo", "occ_hi", "colors", "palette"):
        np.testing.assert_array_equal(getattr(port.bitgrid, k), getattr(edited, k))
    port.tree = device_bitgrid(port.bitgrid, "cpu")
    try:
        ref.invalidate_beam()
        port.invalidate_beam()
        _w, _r, got, st = both(renderers, [A])
        assert st["delta_fetched"] == 1 and 0 < st["delta_rows_fetched"] < RES[1] // 2
        np.testing.assert_array_equal(got[0], port.render(cameras(RES, [A])[1][0], out_u8=True))
        _w, _r, again, st = both(renderers, [A])
        assert st["delta_fetched"] == 0 and again[0] is got[0]
    finally:
        ref.bitgrid, ref.tree, port.bitgrid, port.tree = before
        ref.invalidate_beam()
        port.invalidate_beam()


def test_invalidate_beam_checks_the_swapped_tree(renderers):
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    _ref, port = renderers
    tree = port.tree
    port.tree = device_bitgrid(bitgrid_from_occupancy(np.ones((64, 64, 64), dtype=bool)), "cpu")
    try:
        with pytest.raises(ValueError, match="does not match"):
            port.invalidate_beam()
    finally:
        port.tree = tree


def test_digest_equals_reference_digest(renderers):
    """The reference's delta program, taken from its cache and called on a
    baseline that differs from frame 0 in a few rows, against
    :func:`digest_plain` of its own frames and baseline."""
    import jax.numpy as jnp
    import torch

    from voxelhex_tpu.render.camera import camera_params
    from voxelhex_tpu_torch.ops.frames import digest_plain, render_frames_plain

    ref, port = renderers
    yaws = [A, A, B, B]
    both(renderers, yaws)
    ref_cams, cams = cameras(RES, yaws)
    w, h = RES
    (key, fn), = [(k, f) for k, f in ref._fused_fns.items()
                  if k[-1] == "delta" and k[-2] == len(yaws) and k[-3] == RES]
    prev = np.asarray(ref.render(ref_cams[0], out_u8=True)).copy()
    prev[40:43, 7] ^= 3  # three rows of one group differ
    prev[h - 1, w - 1] ^= 1  # and the last row, in the padded tail group
    stacked = [jnp.stack(col) for col in zip(*(camera_params(c) for c in ref_cams))]
    _last, rgbs, ndiffs, rowflags, _counts = fn(
        ref.tree, jnp.asarray(prev.reshape(-1, 3)), *stacked, jnp.zeros(3, jnp.float32))
    frames = torch.from_numpy(np.asarray(rgbs).reshape(len(yaws), h, w, 3).copy())
    nrows, flags = digest_plain(frames, torch.from_numpy(prev))
    np.testing.assert_array_equal(nrows.numpy(), np.asarray(ndiffs))
    np.testing.assert_array_equal(flags.numpy() != 0, np.asarray(rowflags))
    assert list(nrows.numpy()[:2]) == [4, 0] and int(nrows[2]) > 0
    assert np.flatnonzero(flags[0].numpy()).tolist() == [5, (h - 1) // 8]
    assert flags[0, 5] == 0b111  # rows 40, 41 and 42 of group 5
    # the port's plain batch gives the same frames and digest
    port_frames, port_nrows, port_flags = render_frames_plain(
        port.tree, cams, prev=torch.from_numpy(prev))
    assert torch.equal(port_frames, frames)
    assert torch.equal(port_nrows, nrows) and torch.equal(port_flags, flags)
