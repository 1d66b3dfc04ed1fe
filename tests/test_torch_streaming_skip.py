"""The port's streaming view under ``tracer="skip"`` against the
reference's, on the CPU, bit for bit.

The flight and its cameras are ``test_torch_streaming.py``'s (a 256 terrain
through a 64 window, one whole-world ring at factor 4): after each update
the view's state, its frames (u8, and f32 at the last pose) and every
layer's skip rows equal the reference's, and each layer's rows equal
``skip_rows_from_pairs`` of its own word pairs (the refresh's plain
version, ``skip_rows_plain``).  Then an edit, the beam prepass, and the
ring ladder of a 16 window (rings at factors 4 and 16, W / S = 16)."""

import numpy as np
import pytest

from test_torch_far_field import LADDER
from test_torch_streaming import (FLIGHT, assert_state_equal, cameras, flight_camera,
                                  render_both, state, terrain_trees, views)

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from voxelhex_tpu.tree.boxtree import Albedo as RefAlbedo  # noqa: E402
from voxelhex_tpu_torch.tree.boxtree import Albedo  # noqa: E402


def layer_rows(view, ref):
    """Each layer's skip rows (the window, then the rings) as u32."""
    renderers = [view.renderer] + [t.renderer for t in (view.far.tiers if view.far else ())]
    return [np.asarray(r.tree["skip_rows"]).view(np.uint32) if ref
            else r.tree["skip_rows"].numpy().view(np.uint32) for r in renderers]


def rows_derived(view):
    """Whether each layer's rows are the plain refresh of its word pairs."""
    from voxelhex_tpu_torch.ops.stream import skip_rows_plain

    renderers = [view.renderer] + [t.renderer for t in (view.far.tiers if view.far else ())]
    return all(np.array_equal(r.tree["skip_rows"].numpy(),
                              skip_rows_plain(r.tree["occ_pairs"], r.tree["bases"],
                                              r.tree["dims"], r.tree["size"]).numpy())
               for r in renderers)


def rows_equal(ref_view, view):
    a, b = layer_rows(ref_view, True), layer_rows(view, False)
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def flight():
    """The flight through both packages' skip views: each step's state, its
    u8 frames, whether every layer's rows equal the reference's and the
    plain refresh's; then the last pose's f32 frames."""
    ref_view, view = views(terrain_trees(), view_size=64, regions_per_update=8192,
                           tracer="skip")
    steps = []
    for i in range(len(FLIGHT)):
        frames = render_both(ref_view, view, flight_camera(i), True)
        steps.append((state(ref_view, True), state(view, False), frames,
                      rows_equal(ref_view, view), rows_derived(view)))
    f32 = render_both(ref_view, view, flight_camera(len(FLIGHT) - 1), False)
    return ref_view, view, steps, f32


@pytest.mark.parametrize("step", range(len(FLIGHT)))
def test_skip_flight_equals_reference(flight, step):
    ref_state, port_state, (a, b), same_rows, derived = flight[2][step]
    assert_state_equal(ref_state, port_state)
    assert b.dtype == np.uint8 and (a.sum(-1) > 0).sum() > a.shape[0] * a.shape[1] // 4
    assert np.array_equal(a, b)
    assert same_rows and derived


def test_skip_flight_f32_frame_equals_reference(flight):
    a, b = flight[3]
    assert b.dtype == np.float32 and np.array_equal(a, b)


def test_skip_view_marches_the_skip_tracer(flight, monkeypatch):
    """Every layer's renderer takes the view's tracer and substeps (the
    reference renderer's default, 3: the reference's view passes none), and
    the view's frame is the far frame's skip form."""
    from voxelhex_tpu_torch.render import streaming

    view = flight[1]
    renderers = [view.renderer] + [t.renderer for t in view.far.tiers]
    assert all(r.tracer == "skip" and r.skip_substeps == 3 and "skip_rows" in r.tree
               for r in renderers)
    seen = []
    far = streaming.render_far

    def spy(*args):
        seen.append(args[7])
        return far(*args)

    monkeypatch.setattr(streaming, "render_far", spy)
    view.render(flight_camera(len(FLIGHT) - 1)[1], out_u8=True)
    assert seen == [3]


def test_skip_edit_equals_reference(flight):
    """An insert_at_lod inside the window and the ring (the partial scatter,
    the ring's re-sample): frames, state and rows equal the reference's."""
    ref_view, view = flight[0], flight[1]
    cams = flight_camera(0)
    render_both(ref_view, view, cams, True)
    for t, albedo in ((ref_view.tree, RefAlbedo), (view.tree, Albedo)):
        t.insert_at_lod((64, 16, 100), 4, albedo(250, 20, 20, 255))
    assert 0 < len(view._dirty) <= 8 and view._dirty == ref_view._dirty
    for out_u8 in (True, False):
        a, b = render_both(ref_view, view, cams, out_u8)
        assert np.array_equal(a, b)
    assert_state_equal(state(ref_view, True), state(view, False))
    assert rows_equal(ref_view, view) and rows_derived(view)


def test_skip_beam_prepass_equals_reference():
    """``StreamingView(tracer="skip", beam_prepass=True)``: the window's
    rays start from the window renderer's beam, frames equal the
    reference's over two poses (u8, then f32), rows after each update."""
    ref_view, view = views(terrain_trees(), view_size=64, regions_per_update=8192,
                           tracer="skip", beam_prepass=True)
    for i in (0, 1):
        a, b = render_both(ref_view, view, flight_camera(i), i == 0)
        assert np.array_equal(a, b)
        assert rows_equal(ref_view, view) and rows_derived(view)
        cam_local = view.layers(flight_camera(i)[1])[0][1]
        assert view.renderer._beam_spec(cam_local) is not None
    assert view.renderer._beam_grids


def test_skip_ring_ladder_equals_reference():
    """A 16 window in the 256 world: two rings (factor 4, anchored and
    re-anchoring, and 16), poses inside and outside the window; frames in
    u8 and f32, state and every layer's rows equal the reference's."""
    ref_view, view = views(terrain_trees(), view_size=16, regions_per_update=8192,
                           tracer="skip")
    inside = set()
    for eye, target in LADDER:
        cams = cameras(eye, target)
        for out_u8 in (True, False):
            a, b = render_both(ref_view, view, cams, out_u8)
            assert np.array_equal(a, b)
        assert len(view.far.tiers) == 2
        assert [tuple(t.origin) for t in view.far.tiers] == \
            [tuple(t.origin) for t in ref_view.far.tiers]
        assert_state_equal(state(ref_view, True), state(view, False))
        assert rows_equal(ref_view, view) and rows_derived(view)
        inside.add(view.camera_inside(cams[1]))
    assert inside == {True, False}
