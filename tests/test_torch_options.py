"""The stack automaton's options of the renderer (``lateral_step``,
``advance_substeps``, ``parent_skip``) through the port's plain routes, on
the CPU, against the reference's ``BitGridRenderer`` with the same options,
bit for bit: ``trace()`` of every option at the default step limit and at 7
steps (where rays stop mid-march, so that the options change which rays
hit), and one option each through ``render`` in u8 and f32, the beam and
splat starts, ``FramePipeline``, ``render_many``, ``render_delta_many``
and the depth prepass.  The color storage option is in ``test_torch_color_u8.py``.

The scene and rays are ``test_torch_skip.py``'s (the reference test's 64^3
scene, 1000 of its rays).  The reference's ``trace`` of every option is one
jitted program whose step limits are an argument, so that all options and
both limits share a compile; ``advance_substeps=0``, whose rays spin in
place until the limit, stops at 100 steps rather than 2048 (the plain
tracer's 2048 steps take seconds)."""

import numpy as np
import pytest
import torch
from test_torch_skip import camera_pair, one_thread, scenes  # noqa: F401

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

OPTIONS = {
    "lateral_off": dict(lateral_step=False),
    "substeps_0": dict(advance_substeps=0),
    "substeps_1": dict(advance_substeps=1),
    "substeps_2": dict(advance_substeps=2),
    "substeps_3": dict(advance_substeps=3),
    "parent_skip": dict(parent_skip=True),
    "parent_skip_lateral_off": dict(parent_skip=True, lateral_step=False),
}
SHORT = 7  # a step limit that stops rays mid-march
RES = (48, 32)


@pytest.fixture(scope="module")
def rays():
    """The first 1000 of ``test_torch_skip.py``'s 3000 rays from outside
    the world."""
    n = 3000
    rng = np.random.default_rng(23)
    targets = rng.random((n, 3)) * 64
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (targets - dirs * 200).astype(np.float32)
    return origins[:1000], dirs[:1000].astype(np.float32)


@pytest.fixture(scope="module")
def reference_traces(scenes, rays):
    """The reference renderer's ``trace`` of every option at its full step
    limit and at 7 steps: ``{(name, limit): (hit, voxel, hvox, point,
    normal)}``.  One jitted program of ``(tree, origins, dirs, limits)``
    runs each option's tracer (its init, run and color resolve, as
    ``BitGridRenderer.trace`` composes them) at that option's limit."""
    import jax.numpy as jnp
    from voxelhex_tpu.render.bitgrid import BitGridRenderer, make_bitgrid_tracer

    ref = BitGridRenderer(scenes[0])  # its device tree is the same under every option
    tracers = [make_bitgrid_tracer(ref.bitgrid, **({"advance_substeps": 4} | kw))
               for kw in OPTIONS.values()]

    @jax.jit
    def trace(tree, o, d, limits):
        out = []
        for k, tr in enumerate(tracers):
            st, _ = tr.run(tree, tr.init(tree, o, d), limits[k])
            out.append((st[11], tr.resolve_color(tree, st[11], st[12]), st[12], st[0], st[13]))
        return out

    origins, dirs = rays
    out = {}
    for limits in ([full_limit(name) for name in OPTIONS], [SHORT] * len(OPTIONS)):
        got = trace(ref.tree, origins, dirs, jnp.asarray(limits, dtype=jnp.int32))
        for name, m, res in zip(OPTIONS, limits, got):
            out[(name, m)] = [np.asarray(x) for x in res]
    return out


def full_limit(name):
    return 100 if name == "substeps_0" else 2048


@pytest.mark.parametrize("name", OPTIONS)
def test_trace_equals_reference(scenes, rays, reference_traces, name):
    """Hit, voxel, hit voxel, point and normal of every ray, exact, at the
    default step limit and at 7 steps; at 7 the option changes what rays
    end with (against the default options': which rays hit, or where the
    others stop)."""
    from voxelhex_tpu_torch.render import fastest_renderer

    kw = OPTIONS[name]
    origins, dirs = rays
    for max_iters in (full_limit(name), SHORT):
        want = reference_traces[(name, max_iters)]
        port = fastest_renderer(scenes[1], device="cpu", max_iters=max_iters, **kw)
        assert port.options is not None
        got = port.trace(torch.from_numpy(origins), torch.from_numpy(dirs))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    want = reference_traces[(name, SHORT)]
    assert want[0].sum() > 10
    default = fastest_renderer(scenes[1], device="cpu", max_iters=SHORT)
    base = default.trace(torch.from_numpy(origins), torch.from_numpy(dirs))
    assert any((b.numpy() != w).any() for b, w in zip(base, want))


def test_frames_equal_reference(scenes):
    """Without lateral steps, at 7 steps: ``render`` in u8 and f32,
    ``render_many`` (f32) and ``render_delta_many`` (u8) of two poses and
    ``FramePipeline``, each frame the reference's ``render(compact=False)``
    of its camera (its compacted frames march whole rounds of 14 steps past
    a step limit under 14: ROADMAP.md queue 3); the frame differs from the
    default options'.  Then the frames after the beam and the splat
    prepass at the default limit against the reference's."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.pipeline import FramePipeline

    pairs = [camera_pair(res=RES, distance_factor=1.8, yaw_deg=y) for y in (100.0, 220.0)]
    cams = [c for _r, c in pairs]
    kw = OPTIONS["lateral_off"]
    ref = BitGridRenderer(scenes[0], max_iters=SHORT, **kw)
    port = fastest_renderer(scenes[1], device="cpu", max_iters=SHORT, **kw)
    want = {u8: np.stack([np.asarray(ref.render(r, out_u8=u8, compact=False))
                          for r, _c in pairs]) for u8 in (True, False)}
    np.testing.assert_array_equal(port.render_many(cams, out_u8=False), want[False])
    np.testing.assert_array_equal(np.stack(port.render_delta_many(cams)), want[True])
    for u8 in (True, False):
        np.testing.assert_array_equal(port.render(cams[0], out_u8=u8), want[u8][0])
    pipe = FramePipeline(port)
    np.testing.assert_array_equal(pipe.render(cams[1], out_u8=True).result(), want[True][1])
    pipe.close()
    default = fastest_renderer(scenes[1], device="cpu", max_iters=SHORT)
    assert (default.render(cams[0], out_u8=True) != want[True][0]).any()
    ref = BitGridRenderer(scenes[0], **kw)
    port = fastest_renderer(scenes[1], device="cpu", **kw)
    ref_cam, cam = camera_pair(distance_factor=1.8, yaw_deg=100.0)  # a beam level at 96 x 64
    assert ref._beam_spec(ref_cam) is not None
    for start in ("beam", "splat"):
        want = np.asarray(ref.render(ref_cam, out_u8=True, **{f"{start}_prepass": True}))
        got = port.render(cam, out_u8=True, **{f"{start}_prepass": True})
        np.testing.assert_array_equal(got, want)
        assert port.last_stats["prepass"] == start


def test_depth_prepass_equals_reference(scenes):
    """``prepass=True`` at 2 levels with 1 substep, at 7 steps: the levels
    march the renderer's options, as the reference's do; the frame equals
    the reference's without compaction, and differs from the default
    options' prepass frame."""
    from voxelhex_tpu.render.bitgrid import BitGridRenderer
    from voxelhex_tpu_torch.render import fastest_renderer

    ref_cam, cam = camera_pair(res=RES, distance_factor=1.2, yaw_deg=40.0)
    kw = dict(prepass=True, prepass_levels=2, max_iters=SHORT)
    want = np.asarray(BitGridRenderer(scenes[0], advance_substeps=1, **kw).render(
        ref_cam, out_u8=True, compact=False))
    port = fastest_renderer(scenes[1], device="cpu", advance_substeps=1, **kw)
    got = port.render(cam, out_u8=True)
    np.testing.assert_array_equal(got, want)
    assert port.last_stats["prepass"] == "depth"
    default = fastest_renderer(scenes[1], device="cpu", **kw)
    assert (default.render(cam, out_u8=True) != got).any()
