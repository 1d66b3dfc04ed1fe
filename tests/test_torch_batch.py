"""The port's batched frames (plain versions, on the CPU) against the
reference renderer's, bit for bit: ``render_many`` at 160 x 90, its gates,
the cached camera params and ``FramePipeline``.  The ragged 37 x 21 frames
are ``test_torch_batch_ragged.py``'s, the delta path ``test_torch_delta.py``'s,
on this file's scene and helpers; each file compiles its own reference
programs and stays short.

The reference side is ``BitGridRenderer(..., fuse_plan=True)`` primed with
three ``render`` calls, so that its batch path is live; the port's side
renders a copy of the same BitGrid (``convert.from_jax_bitgrid``) on
``device="cpu"``.  The scene is built in code, small enough that the
reference compiles each batched program in a few seconds."""

import numpy as np
import pytest

RES = (160, 90)  # full pixel tiles
YAWS = (20.0, 24.0, 20.0)


def make_tree(seed=1, package="voxelhex_tpu"):
    """A 16^3 BoxTree of ``package`` (the reference's, or the port's
    ``voxelhex_tpu_torch``): 40 random voxels of varied colors and one 4^3
    block."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    Albedo, BoxTree = boxtree.Albedo, boxtree.BoxTree
    tree = BoxTree(16, 4, auto_simplify=False)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        p = tuple(int(v) for v in rng.integers(0, 16, 3))
        tree.insert(p, Albedo(int(rng.integers(0, 255)), 100, 50, 255))
    tree.insert_at_lod((4, 4, 4), 4, Albedo(30, 200, 30, 255))
    return tree


def port_bitgrid(ref_bitgrid):
    from voxelhex_tpu_torch.convert import FIELDS, from_jax_bitgrid

    return from_jax_bitgrid({k: getattr(ref_bitgrid, k) for k in FIELDS})


def cameras(res, yaws=YAWS):
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    return ([ref_orbit(16.0, yaw_deg=y, resolution=res) for y in yaws],
            [orbit_camera(16.0, yaw_deg=y, resolution=res) for y in yaws])


def ref_batch(ref, call, ref_cams):
    """``call()`` of the reference's batch path.  It declines (None) until a
    stable plan is recorded for the pose; as its contract says, render
    frames one at a time to record one, then call again."""
    out = call()
    if out is None:
        for _ in range(3):
            ref.render(ref_cams[0], out_u8=True)
        out = call()
    assert out is not None, "the reference's batch path declined"
    return out


def make_renderers(res):
    """``(reference, port)`` renderers of :func:`make_tree`'s scene, the
    reference's plan recorded at ``res``."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer, build_bitgrid
    from voxelhex_tpu_torch.render import fastest_renderer

    bg = build_bitgrid(make_tree())
    ref = BitGridRenderer(bg, fuse_plan=True)
    ref.fuse_compile_cap = 64  # its single-frame and batch programs, u8 and f32
    for _ in range(3):  # record, stabilize and fuse the plan
        ref.render(cameras(res)[0][0], out_u8=True)
    return ref, fastest_renderer(port_bitgrid(bg), device="cpu")


@pytest.fixture(scope="module")
def renderers():
    return make_renderers(RES)


@pytest.mark.parametrize("out_u8", [True, False])
def test_render_many_equals_reference(renderers, out_u8):
    check_render_many(*renderers, RES, out_u8)


def check_render_many(ref, port, res, out_u8):
    """Every frame equals the reference's ``render`` of its camera, and the
    reference's ``render_many`` everywhere except where that program
    disagrees with the reference's own ``render``: at an odd width, XLA:CPU
    compiles the scanned batch's ray generation so that the middle column,
    where ``(x + 0.5) * (2 / w)`` rounds to 1, takes another ray (ROADMAP.md
    queue 3).  At 160 x 90 the two reference programs agree."""
    ref_cams, cams = cameras(res)
    want = np.asarray(ref_batch(ref, lambda: ref.render_many(ref_cams, out_u8=out_u8), ref_cams))
    single = np.stack([np.asarray(ref.render(c, out_u8=out_u8)) for c in ref_cams])
    got = port.render_many(cams, out_u8=out_u8)
    assert got.dtype == (np.uint8 if out_u8 else np.float32)
    assert got.shape == (len(cams), res[1], res[0], 3)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 5  # hits and misses
    np.testing.assert_array_equal(got, single)
    ref_own = (want != single).any(axis=-1)
    np.testing.assert_array_equal((got != want).any(axis=-1), ref_own)
    if res[0] % 2 == 0:
        assert not ref_own.any()
    else:
        assert set(np.argwhere(ref_own)[:, 2]) <= {res[0] // 2}
    assert port.last_stats == {"rays": res[0] * res[1] * len(cams),
                               "batched_frames": len(cams), "beam_fused": False}
    for k, cam in enumerate(cams):  # each frame is render()'s
        np.testing.assert_array_equal(got[k], port.render(cam, out_u8=out_u8))
    dev = port.render_many(cams, out_u8=out_u8, out_device=True)
    np.testing.assert_array_equal(dev.numpy(), got)


def test_batch_gates():
    """An empty list, mixed resolutions and the beam prepass where the first
    camera has no beam level return None, as the reference's do."""
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    port = fastest_renderer(port_bitgrid(_small_ref_bitgrid()), device="cpu")
    mixed = [orbit_camera(16.0, resolution=(40, 24)), orbit_camera(16.0, resolution=(24, 40))]
    for fn in (port.render_many, port.render_delta_many):
        assert fn([]) is None
        assert fn(mixed) is None
        assert port._beam_spec(mixed[0]) is None
        assert fn(mixed[:1], beam_prepass=True) is None
    assert port._delta_state is None


def _small_ref_bitgrid():
    from voxelhex_tpu.render.bitgrid import build_bitgrid

    return build_bitgrid(make_tree(seed=2))


def test_frame_params_cache_gives_fresh_bytes():
    """A cached pose gives the bytes of a fresh computation; the key is the
    camera's exact fields, so a pose that differs in the last bit, or only
    in its dtype, is computed anew."""
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops import frame as frame_ops
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import camera_params, orbit_camera

    tree = device_bitgrid(port_bitgrid(_small_ref_bitgrid()), "cpu")
    cam = orbit_camera(16.0, yaw_deg=33.0, resolution=(37, 21))
    frame_ops._cams.clear()

    def fresh(c):
        p = _build.FrameCam()
        origin, right, up, forward, scale = camera_params(c)
        p.origin[:], p.right[:], p.up[:], p.forward[:] = (
            [float(v) for v in a] for a in (origin, right, up, forward))
        p.scale[:] = [float(v) for v in scale]
        return bytes(p)

    first = bytes(frame_ops.frame_params(tree, cam))
    assert len(frame_ops._cams) == 1
    again = orbit_camera(16.0, yaw_deg=33.0, resolution=(37, 21))  # equal fields, new object
    assert bytes(frame_ops.frame_params(tree, again)) == first
    assert len(frame_ops._cams) == 1
    assert bytes(frame_ops.frame_cam(again)) == fresh(again)
    nudged = orbit_camera(16.0, yaw_deg=33.0, resolution=(37, 21))
    nudged.origin = nudged.origin.copy()
    nudged.origin[0] = np.nextafter(nudged.origin[0], np.float32(np.inf))
    wide = orbit_camera(16.0, yaw_deg=33.0, resolution=(37, 21))
    wide.origin = wide.origin.astype(np.float64)
    for c in (nudged, wide):
        assert bytes(frame_ops.frame_cam(c)) == fresh(c)
    assert bytes(frame_ops.frame_cam(nudged)) != fresh(cam)
    assert len(frame_ops._cams) == 3
    for yaw in range(frame_ops.CAM_CACHE_SIZE + 5):  # the cache stays bounded
        frame_ops.frame_cam(orbit_camera(16.0, yaw_deg=float(yaw), resolution=(8, 8)))
    assert len(frame_ops._cams) == frame_ops.CAM_CACHE_SIZE


def test_frame_pipeline_equals_render():
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.pipeline import FramePipeline

    port = fastest_renderer(port_bitgrid(_small_ref_bitgrid()), device="cpu")
    cams = cameras((37, 21), yaws=(10.0, 70.0, 130.0, 190.0))[1]
    pipe = FramePipeline(port, max_in_flight=2)
    futs = [pipe.render(c, out_u8=True) for c in cams]
    futs.append(pipe.render(cams[0], bg=(0.1, 0.2, 0.3)))
    pipe.drain()
    assert all(f.done() for f in futs)
    pipe.close()
    for f, c in zip(futs, cams):
        np.testing.assert_array_equal(f.result(timeout=60), port.render(c, out_u8=True))
    f32 = futs[-1].result(timeout=60)
    assert f32.dtype == np.float32
    np.testing.assert_array_equal(f32, port.render(cams[0], bg=(0.1, 0.2, 0.3)))
