"""The port's soft renderer with the beam prepass (plain versions, on the
CPU) against the reference's ``SoftRenderer``: ``beam_spec`` is None where
the reference's is; ``trace_hits(beam=)`` gives the reference's
``trace_hits_compacted(beam=)`` on the reference test's cube
(``test_multihit_beam_start_matches_plain``) at 160 x 120 and on
``with_candidates``' dilated grid: counts, voxels and distances exact (the
reference's own tolerance for the beam is rtol 1e-6, atol 1e-5).

The training steps with the beam are in ``test_torch_soft_beam_step.py``,
the skip tracer's march in ``test_torch_soft_skip.py``: each file compiles
few reference programs, so that each stays cheap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

RES = (160, 120)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cube(package):
    """The reference test's 64^3 world: an 8^3 red cube at its center."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    tree = boxtree.BoxTree(64, 4, auto_simplify=False)
    red = boxtree.Albedo(255, 0, 0, 255)
    for x in range(28, 36):
        for y in range(28, 36):
            for z in range(28, 36):
                tree.insert((x, y, z), red)
    return tree


def camera_pair(res=RES, factor=3.0):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    return (ref_orbit(64.0, distance_factor=factor, resolution=res),
            orbit_camera(64.0, distance_factor=factor, resolution=res))


def rays(ref_cam):
    from voxelhex_tpu.render.camera import device_rays

    o, d = device_rays(ref_cam)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


@pytest.fixture(scope="module")
def pair():
    from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.diff.soft import SoftRenderer

    return (RefSoft(flatten(cube("voxelhex_tpu")), max_hits=2),
            SoftRenderer(cube("voxelhex_tpu_torch"), max_hits=2, device="cpu"))


def assert_hits_equal(got, want, rtol=1e-6, atol=1e-5):
    c, v, d = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), c)
    np.testing.assert_array_equal(got[1].numpy(), v)
    np.testing.assert_allclose(got[2].numpy(), d, rtol=rtol, atol=atol)


def test_beam_spec_gates(pair):
    """None where the tile does not divide the resolution or no level keeps
    the bound, as the reference's; else the reference's key."""
    ref, port = pair
    for res, factor in (((164, 120), 3.0), ((160, 120), 40.0)):
        ref_cam, cam = camera_pair(res, factor)
        assert ref.beam_spec(ref_cam) is None and port.beam_spec(cam) is None
    ref_cam, cam = camera_pair()
    assert port.beam_spec(cam)["key"] == ref.beam_spec(ref_cam)["key"]


def test_trace_hits_with_beam_equals_reference(pair):
    """Most tiles are dead on this camera: their rays have no hit."""
    ref, port = pair
    ref_cam, cam = camera_pair()
    o, d = rays(ref_cam)
    want = ref.trace_hits_compacted(jnp.asarray(o), jnp.asarray(d),
                                    beam=ref.beam_spec(ref_cam))
    spec = port.beam_spec(cam)
    got = port.trace_hits(torch.from_numpy(o), torch.from_numpy(d), beam=spec)
    assert_hits_equal(got, want, rtol=0, atol=0)
    plain = port.trace_hits(torch.from_numpy(o), torch.from_numpy(d))
    for a, b in zip(got[:2], plain[:2]):
        assert torch.equal(a, b)
    starts, tile, w = port.beam_starts(spec, o.shape[0])
    assert (starts == 1e8).float().mean() > 0.5 and (tile, w) == (8, RES[0])
    assert int((got[0] == 2).sum()) > 20
    with pytest.raises(ValueError, match="rays"):
        port.trace_hits(torch.from_numpy(o[:-8]), torch.from_numpy(d[:-8]), beam=spec)


def test_trace_hits_with_beam_on_candidates():
    """``with_candidates``' dilated pyramid: the beam reads its words, so
    the shell's voxels stay recorded."""
    from voxelhex_tpu.diff.soft import with_candidates as ref_cands
    from voxelhex_tpu.tree.flat import flatten
    from voxelhex_tpu_torch.diff.soft import with_candidates

    ref, _p, _c = ref_cands(flatten(cube("voxelhex_tpu")), radius=1, max_hits=2)
    port, _p, _c = with_candidates(cube("voxelhex_tpu_torch"), radius=1, max_hits=2,
                                   device="cpu")
    ref_cam, cam = camera_pair(factor=2.0)
    o, d = rays(ref_cam)
    want = ref.trace_hits_compacted(jnp.asarray(o), jnp.asarray(d),
                                    beam=ref.beam_spec(ref_cam))
    got = port.trace_hits(torch.from_numpy(o), torch.from_numpy(d), beam=port.beam_spec(cam))
    assert_hits_equal(got, want, rtol=0, atol=0)
    assert int((got[1][:, 0, 0] == 27).sum()) > 0  # the shell in front of the cube


