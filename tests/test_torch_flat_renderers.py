"""The port's flat-tree renderers (plain versions, on the CPU) against the
reference's ``JaxRenderer``, ``WavefrontRenderer`` and ``FastRenderer``,
bit for bit: ``trace()``'s six outputs on seeded rays (128 from outside
the world and 128 from inside: multiples of 8, since XLA:CPU fuses the
last ``R % 8`` rays' entry points in its scalar remainder loop otherwise),
32x24 frames, the fast tracer's ``start_t`` and the prepassed frame at an
even and an odd size, and the arrays the renderers upload.

Both packages hold the same trees: ``test_jax_renderer.py``'s 16-world
scene with its uniform node ("s16"), worlds of bricks of 2, 4 and 8 (the
fast tracer's bitmap bricks at 2 and 4, voxel reads at 8), and an
all-solid tree of uniform nodes only, which has no brick rows and so takes
``with_padding``.  The kernels' sources are held to these plain versions
in ``test_torch_kernels_host_flat.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

# name: (world, brick_dim, random voxels, seed); "solid" has only uniform nodes
SCENES = {
    "s16": (16, 4, 150, 11),
    "d2": (32, 2, 300, 2),
    "d4": (64, 4, 1500, 1),
    "d8": (32, 8, 300, 3),
    "solid": (64, 4, 0, 4),
}
TRACERS = ("vmap", "wavefront", "fast")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the plain tracers: their many small ops run
    faster so, and do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(package, name):
    """Scene ``name`` as a BoxTree of the reference's (``voxelhex_tpu``) or
    the port's (``voxelhex_tpu_torch``) package."""
    import importlib

    boxtree = importlib.import_module(f"{package}.tree.boxtree")
    cols = [boxtree.Albedo.from_u32(v) for v in (0xFF0000FF, 0x00FF00FF, 0x0000FFFF)]
    size, brick_dim, n, seed = SCENES[name]
    tree = boxtree.BoxTree(size, brick_dim, auto_simplify=False)
    if name == "solid":
        for k, (p, e) in enumerate((((8, 8, 8), 4), ((32, 16, 32), 16), ((40, 48, 4), 4))):
            tree.insert_at_lod(p, e, cols[k])
        return tree
    rng = np.random.default_rng(seed)
    for _ in range(n):
        tree.insert(tuple(int(v) for v in rng.integers(0, size, 3)), cols[rng.integers(0, 3)])
    tree.insert_at_lod((8, 8, 8), 4, cols[0])
    return tree


@pytest.fixture(scope="module")
def scenes():
    from voxelhex_tpu.tree.flat import flatten as ref_flatten
    from voxelhex_tpu_torch.tree.flat import flatten

    return {name: (ref_flatten(make_tree("voxelhex_tpu", name)),
                   flatten(make_tree("voxelhex_tpu_torch", name))) for name in SCENES}


def make_rays(size, seed, n=128):
    """``n`` rays aimed at the world from outside it, then ``n`` from
    inside, f32 NumPy [2n, 3] each."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(n, 3))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    o1 = rng.random((n, 3)) * size - d1 * size * 2.5
    o2 = rng.random((n, 3)) * size * 0.8 + size * 0.1
    d2 = rng.normal(size=(n, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return (np.concatenate([o1, o2]).astype(np.float32),
            np.concatenate([d1, d2]).astype(np.float32))


def renderer_pair(tracer, ref_flat, flat, cap=None, **kw):
    """The reference's and the port's (CPU) renderer of ``tracer`` at
    ``cap`` steps (``max_inner`` or ``max_iters``; None: the default)."""
    from voxelhex_tpu.render.fast import FastRenderer as RefFast
    from voxelhex_tpu.render.jax_renderer import JaxRenderer as RefJax
    from voxelhex_tpu.render.wavefront import WavefrontRenderer as RefWavefront
    from voxelhex_tpu_torch.render.fast import FastRenderer
    from voxelhex_tpu_torch.render.jax_renderer import JaxRenderer
    from voxelhex_tpu_torch.render.wavefront import WavefrontRenderer

    ref_cls, cls, key = {"vmap": (RefJax, JaxRenderer, "max_inner"),
                         "wavefront": (RefWavefront, WavefrontRenderer, "max_iters"),
                         "fast": (RefFast, FastRenderer, "max_iters")}[tracer]
    if cap is not None:
        kw[key] = cap
    return ref_cls(ref_flat, **kw), cls(flat, device="cpu", **kw)


def assert_same(ref_out, out):
    names = ("hit", "voxel", "brick", "cell", "point", "normal")
    bad = []
    for name, a, b in zip(names, ref_out, out):
        a = np.asarray(a)
        b = b.numpy()
        same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a == b
        if a.dtype.kind == "f":
            same &= np.signbit(a) == np.signbit(b)
        if a.shape != b.shape or not same.all():
            bad.append(name)
    assert not bad, f"outputs differ from the reference: {bad}"


@pytest.mark.parametrize("tracer", TRACERS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_trace_equals_reference(scenes, scene, tracer):
    """``trace()``'s six outputs equal the reference's on every ray."""
    ref_flat, flat = scenes[scene]
    ref, port = renderer_pair(tracer, ref_flat, flat)
    o, d = make_rays(flat.size, 5)
    ref_out = ref.trace(o, d)
    assert_same(ref_out, port.trace(o, d))
    if scene != "solid":
        assert int(np.asarray(ref_out[0]).sum()) > 40


@pytest.mark.parametrize("tracer,cap", [("vmap", 7), ("wavefront", 9), ("fast", 9)])
def test_trace_at_caps_that_cut_rays(scenes, tracer, cap):
    """At a step cap that cuts rays mid-march (each restart pass, brick
    probe and the ADVANCE of the scalar tracer; the bodies of the batched
    ones), every ray stops where the reference's does."""
    ref_flat, flat = scenes["d4"]
    ref, port = renderer_pair(tracer, ref_flat, flat, cap)
    _ref_full, full = renderer_pair(tracer, ref_flat, flat)
    o, d = make_rays(flat.size, 6)
    out = port.trace(o, d)
    assert_same(ref.trace(o, d), out)
    assert bool((out[4] != full.trace(o, d)[4]).any())


def test_fast_start_t_equals_reference(scenes):
    """The fast tracer from a start a ray (``make_fast_tracer``'s
    ``start_t``), bitmap and voxel-read forms, against the reference's
    tracer jitted with it."""
    from voxelhex_tpu.render.fast import make_fast_tracer as ref_tracer
    from voxelhex_tpu.render.fast import pack_device_tree as ref_pack
    from voxelhex_tpu_torch.render.fast import FastRenderer

    for scene in ("d4", "d8"):
        ref_flat, flat = scenes[scene]
        o, d = make_rays(flat.size, 7)
        start = (np.random.default_rng(8).random(o.shape[0]) * 2 * flat.size).astype(np.float32)
        ref = jax.jit(lambda t, a, b, s: ref_tracer(flat.brick_dim)(t, a, b, start_t=s))(
            ref_pack(ref_flat), o, d, start)
        out = FastRenderer(flat, device="cpu").trace(o, d, start_t=torch.from_numpy(start))
        assert_same(ref, out)


@pytest.mark.parametrize("scene,tracer,kw,res", [
    ("s16", "vmap", {}, (32, 24)),
    ("s16", "wavefront", {}, (32, 24)),
    ("s16", "fast", {}, (32, 24)),
    ("d8", "fast", {}, (32, 24)),
    ("s16", "fast", {"prepass": True}, (32, 24)),
    ("s16", "fast", {"prepass": True}, (33, 25)),
])
def test_frames_equal_reference(scenes, scene, tracer, kw, res):
    """Each renderer's f32 frame equals the reference's on a non-zero
    background: the fast one in its bitmap and voxel-read forms, and with
    the prepass at an even size (a half-res launch first) and an odd one
    (none)."""
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    bg = (0.1, 0.2, 0.3)
    ref_flat, flat = scenes[scene]
    ref, port = renderer_pair(tracer, ref_flat, flat, **kw)
    want = ref.render(ref_orbit(float(flat.size), yaw_deg=30.0, resolution=res), bg)
    frame = port.render(orbit_camera(float(flat.size), yaw_deg=30.0, resolution=res), bg)
    assert frame.dtype == np.float32 and frame.shape == (res[1], res[0], 3)
    assert np.array_equal(frame, want)
    assert int((frame != np.float32(bg)).any(axis=-1).sum()) > 50


def test_reference_trap_fast_prepass_skips_near_surfaces():
    """The reference's prepassed frame is not its plain frame: where no
    half-res ray hits a near surface, the 2x2 minimum of the half-res
    depths less 2.0 starts full-res rays behind it (fast.py:475-486).  The
    port reproduces the reference's frame, so it has the same pixels
    wrong: at the bench pose at 96x54, 26 of them."""
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu.render.fast import FastRenderer as RefFast
    from voxelhex_tpu.tree.build import from_voxels as ref_from_voxels
    from voxelhex_tpu.tree.flat import flatten as ref_flatten
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.fast import FastRenderer
    from voxelhex_tpu_torch.scene import build_scene_tree, scene_points
    from voxelhex_tpu_torch.tree.flat import flatten

    pts, cols = scene_points()
    ref_flat = ref_flatten(ref_from_voxels(pts, cols, size=256, brick_dim=4, simplify=True))
    flat = flatten(build_scene_tree(4))
    ref_cam = ref_orbit(128.0, yaw_deg=40.0, resolution=(96, 54))
    cam = orbit_camera(128.0, yaw_deg=40.0, resolution=(96, 54))
    ref_pre, ref_plain = (RefFast(ref_flat, prepass=p).render(ref_cam) for p in (True, False))
    pre, plain = (FastRenderer(flat, prepass=p, device="cpu").render(cam) for p in (True, False))
    assert np.array_equal(pre, ref_pre) and np.array_equal(plain, ref_plain)
    wrong = (pre != plain).any(axis=-1)
    assert int(wrong.sum()) == 26
    assert np.array_equal(wrong, (ref_pre != ref_plain).any(axis=-1))
    y, x = np.argwhere(wrong)[0]
    assert not np.array_equal(pre[y, x], plain[y, x])


@pytest.mark.parametrize("scene", ["s16", "solid"])
def test_uploaded_arrays_equal_reference(scenes, scene):
    """``FlatTree.with_padding``, ``device_tree`` and ``pack_device_tree``
    hold the reference's arrays, value for value (the u32 words as int32
    bit patterns); the all-solid tree is padded to one brick row."""
    from voxelhex_tpu.render.fast import pack_device_tree as ref_pack
    from voxelhex_tpu.render.jax_renderer import device_tree as ref_device_tree
    from voxelhex_tpu_torch.render.fast import pack_device_tree
    from voxelhex_tpu_torch.render.jax_renderer import device_tree

    ref_flat, flat = scenes[scene]
    for n, b in ((8, 8), (1, 1), (3, 5)):
        ref_pad, pad = ref_flat.with_padding(n, b), flat.with_padding(n, b)
        for field in ("node_meta", "node_children", "node_ocbits", "node_mips", "bricks",
                      "brick_ocbits", "palette"):
            a, p = getattr(ref_pad, field), getattr(pad, field)
            assert a.dtype == p.dtype and np.array_equal(a, p), (n, b, field)
    for ref_tree, tree in ((ref_device_tree(ref_flat), device_tree(flat, "cpu")),
                           (ref_pack(ref_flat), pack_device_tree(flat, "cpu"))):
        for key, a in ref_tree.items():
            t = tree[key]
            got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            want = np.asarray(a)
            if want.dtype == np.uint32:
                want = want.view(np.int32)
            assert np.array_equal(got, want), key
    if scene == "solid":
        assert flat.bricks.shape[0] == 0 and device_tree(flat, "cpu")["bricks"].shape == (1, 64)


@pytest.mark.parametrize("res,yaw", [((32, 24), 30.0), ((1920, 1080), 40.0), ((7, 5), 250.0)])
def test_camera_rays_equal_reference(res, yaw):
    """``Camera.rays()``: the host rays of the flat renderers, bit for bit."""
    from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
    from voxelhex_tpu_torch.render.camera import orbit_camera

    want = ref_orbit(128.0, yaw_deg=yaw, resolution=res).rays()
    got = orbit_camera(128.0, yaw_deg=yaw, resolution=res).rays()
    for a, b in zip(want, got):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
