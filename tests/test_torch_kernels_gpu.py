"""The CUDA kernels against their plain PyTorch versions, on the card.

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Skips where there is no CUDA card.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _grid(size=64, seed=0, density=0.02):
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy

    occ = np.random.default_rng(seed).random((size, size, size)) < density
    return bitgrid_from_occupancy(occ, palette=np.random.default_rng(seed).random((7, 4)))


def _rays(n, size, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * size, 1.5 * size, (n, 3)).astype(np.float32)
    d = rng.uniform(0, size, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def _equal(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def test_traverse_kernel_equals_plain(cuda):
    from voxelhex_tpu_torch.ops.traverse import traverse, traverse_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(), cuda)
    o, d = (t.to(cuda) for t in _rays(5000, 64, 1))
    n0 = traverse.launches
    k = traverse(tree, o, d)
    torch.cuda.synchronize()
    assert traverse.launches == n0 + 1
    p = traverse_plain(tree, o, d)
    assert int(k[0].sum()) > 1000
    for a, b in zip(k, p):
        assert _equal(a, b)


def test_traverse_kernel_stops_at_max_iters(cuda):
    from voxelhex_tpu_torch.ops.traverse import traverse, traverse_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(), cuda)
    o, d = (t.to(cuda) for t in _rays(2000, 64, 2))
    k = traverse(tree, o, d, max_iters=5)
    torch.cuda.synchronize()
    for a, b in zip(k, traverse_plain(tree, o, d, max_iters=5)):
        assert _equal(a, b)


def test_shade_kernel_equals_plain(cuda):
    from voxelhex_tpu_torch.ops.shade import shade, shade_plain

    rng = np.random.default_rng(3)
    R, P = 4099, 16425
    hit = torch.from_numpy(rng.random(R) < 0.7).to(cuda)
    voxel = torch.from_numpy(rng.integers(-1, P, R).astype(np.int32)).to(cuda)
    normal = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)).to(cuda)
    palette = torch.from_numpy(rng.random((P, 4)).astype(np.float32)).to(cuda)
    for out_u8 in (True, False):
        k = shade(hit, voxel, normal, palette, (0.1, 0.2, 0.3), out_u8=out_u8)
        torch.cuda.synchronize()
        assert _equal(k, shade_plain(hit, voxel, normal, palette, (0.1, 0.2, 0.3), out_u8))


def test_render_cuda_equals_cpu(cuda):
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    bg = _grid(size=128, seed=4, density=0.01)
    cam = orbit_camera(128.0, resolution=(160, 90))
    a = fastest_renderer(bg, device="cuda").render(cam, out_u8=True, out_device=True)
    b = fastest_renderer(bg, device="cpu").render(cam, out_u8=True, out_device=True)
    assert a.device.type == "cuda" and _equal(a.cpu(), b)
    np.testing.assert_array_equal(fastest_renderer(bg, device="cuda").render(cam),
                                  fastest_renderer(bg, device="cpu").render(cam))


# grids of 2, 3 and 4 pyramid levels (the bench scene has 4)
@pytest.mark.parametrize("size,density", [(16, 0.05), (64, 0.02), (128, 0.01)])
@pytest.mark.parametrize("out_u8", [True, False])
def test_frame_kernel_equals_plain(cuda, size, density, out_u8):
    """At 333x187 the pixel tiles are ragged on the right and at the bottom."""
    from voxelhex_tpu_torch.ops.frame import render_frame, render_frame_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera

    grid = _grid(size=size, seed=size, density=density)
    tree = device_bitgrid(grid, cuda)
    assert len(tree["bases"]) == {16: 2, 64: 3, 128: 4}[size]
    cam = orbit_camera(float(size), yaw_deg=130.0, resolution=(333, 187))
    bg = (0.1, 0.2, 0.3)
    n0 = render_frame.launches
    k = render_frame(tree, cam, bg, out_u8)
    torch.cuda.synchronize()
    assert render_frame.launches == n0 + 1
    p = render_frame_plain(tree, cam, bg, out_u8)
    assert k.shape == p.shape == (187, 333, 3) and k.dtype == p.dtype
    assert len(torch.unique(p.reshape(-1, 3), dim=0)) >= 3  # misses, hits on two faces
    assert _equal(k, p)


def test_render_is_one_frame_launch(cuda):
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.shade import shade
    from voxelhex_tpu_torch.ops.traverse import traverse
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.camera import orbit_camera

    r = fastest_renderer(_grid(), device="cuda")
    counts = (render_frame.launches, traverse.launches, shade.launches)
    r.render(orbit_camera(64.0, resolution=(160, 90)), out_u8=True, out_device=True)
    torch.cuda.synchronize()
    assert (render_frame.launches, traverse.launches, shade.launches) == (
        counts[0] + 1, counts[1], counts[2])


@pytest.mark.parametrize("max_hits,max_iters", [(2, 2048), (4, 2048), (3, 5), (6, 2048)])
def test_multihit_kernel_equals_plain(cuda, max_hits, max_iters):
    from voxelhex_tpu_torch.ops.multihit import multihit, multihit_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(), cuda)
    o, d = (t.to(cuda) for t in _rays(5000, 64, 5))
    n0 = multihit.launches
    k = multihit(tree, o, d, max_hits, max_iters)
    torch.cuda.synchronize()
    assert multihit.launches == n0 + 1
    p = multihit_plain(tree, o, d, max_hits, max_iters)
    assert int((p[0] >= 2).sum()) > 10
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape and _equal(a, b)


# 300,000 rays are more threads than the card holds at once (132 SMs x at
# most 2,048 threads, 270,336): the grid runs in more than one wave
@pytest.mark.parametrize("n_rays", [0, 1, 33, 300_000])
def test_multihit_kernel_ray_counts(cuda, n_rays):
    from voxelhex_tpu_torch.ops.multihit import multihit, multihit_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(), cuda)
    o, d = _rays(max(n_rays, 1), 64, 6)
    o, d = o[:n_rays].to(cuda), d[:n_rays].to(cuda)
    k = multihit(tree, o, d, 3)
    torch.cuda.synchronize()
    p = multihit_plain(tree, o, d, 3)
    assert k[0].shape == (n_rays,) and k[1].shape == (n_rays, 3, 3) and k[2].shape == (n_rays, 3)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and _equal(a, b)


def test_multihit_kernel_twice_in_a_row(cuda):
    """Two launches queued on one stream, with no host read between them,
    each into outputs of its own."""
    from voxelhex_tpu_torch.ops.multihit import multihit, multihit_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(), cuda)
    o, d = (t.to(cuda) for t in _rays(50_000, 64, 7))
    first = multihit(tree, o, d, 2)
    second = multihit(tree, o.flip(0).contiguous(), d.flip(0).contiguous(), 2)
    torch.cuda.synchronize()
    want = multihit_plain(tree, o, d, 2)
    assert int((want[0] == 2).sum()) > 100
    for a, b, c in zip(first, second, want):
        assert _equal(a, c) and _equal(b.flip(0), c)


@pytest.mark.parametrize("max_iters", [1, 3, 9])
def test_multihit_kernel_budget_cuts_rays(cuda, max_iters):
    from voxelhex_tpu_torch.ops.multihit import multihit
    from voxelhex_tpu_torch.ops.traverse import KERNEL_CONFIG
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid, make_multihit_tracer

    tree = device_bitgrid(_grid(density=0.05), cuda)
    o, d = (t.to(cuda) for t in _rays(20_000, 64, 8))
    k = multihit(tree, o, d, 2, max_iters)
    torch.cuda.synchronize()
    trace = make_multihit_tracer(len(tree["bases"]), tree["size"], 2, max_iters, **KERNEL_CONFIG)
    *p, steps = trace(tree, o, d, with_steps=True)
    assert int((steps == 2 * max_iters).sum()) > 1000  # rays the budget cuts
    for a, b in zip(k, p):
        assert _equal(a, b)


def _soft_case(cuda, K, seed):
    from voxelhex_tpu_torch.ops.multihit import multihit
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    rng = np.random.default_rng(seed)
    n = 64**3
    albedo = torch.from_numpy(rng.random(3 * n).astype(np.float32)).to(cuda)
    logits = torch.from_numpy(rng.normal(0, 3, n).astype(np.float32)).to(cuda)
    o, d = (t.to(cuda) for t in _rays(20000, 64, seed))
    _count, voxels, _dists = multihit(device_bitgrid(_grid(density=0.05), cuda), o, d, K)
    grad = torch.from_numpy(rng.normal(0, 1e-3, (o.shape[0], 3)).astype(np.float32)).to(cuda)
    return albedo, logits, voxels, grad


# composite tolerances: expf in the kernel and in PyTorch's sigmoid may round
# an alpha an ulp apart; the backward's atomics add in no fixed order
@pytest.mark.parametrize("K", [1, 2, 4, 6])
@pytest.mark.parametrize("bg", [None, (0.25, 0.5, 0.75)])
@pytest.mark.parametrize("packed", [True, False])
def test_composite_kernels_equal_plain(cuda, K, bg, packed):
    from voxelhex_tpu_torch.ops.composite import (
        composite_backward, composite_backward_plain, composite_forward,
        composite_forward_plain)

    albedo, logits, voxels, grad = _soft_case(cuda, K, K)
    if not packed:  # empty slots first: each slot is valid or not on its own
        voxels = voxels.flip(1).contiguous()
        assert K == 1 or bool(((voxels[:, 0, 0] < 0) & (voxels[:, -1, 0] >= 0)).any())
    n0 = (composite_forward.launches, composite_backward.launches)
    rgb = composite_forward(albedo, logits, voxels, 64, bg)
    ga, gl = composite_backward(grad, albedo, logits, voxels, 64, bg)
    torch.cuda.synchronize()
    assert (composite_forward.launches, composite_backward.launches) == (n0[0] + 1, n0[1] + 1)
    want = composite_forward_plain(albedo, logits, voxels, 64, bg)
    np.testing.assert_allclose(rgb.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-6)
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, 64, bg)
    for got, ref in ((ga, wa), (gl, wl)):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))
        np.testing.assert_array_equal(got == 0, ref == 0)


@pytest.mark.parametrize("fit_albedo,opacity_l1", [(True, 0.0), (False, 0.0), (True, 0.1)])
def test_adam_kernel_equals_plain(cuda, fit_albedo, opacity_l1):
    from voxelhex_tpu_torch.ops.adam import AdamConfig, adam_plain, adam_update

    rng = np.random.default_rng(9)
    n = 100_003
    cfg = AdamConfig(0.05)
    extra = (opacity_l1, ((0.0, 1.0), (-12.0, 12.0)))

    def group():
        return {"albedo": torch.from_numpy(rng.random(3 * n).astype(np.float32)).to(cuda),
                "logits": torch.from_numpy(rng.normal(0, 6, n).astype(np.float32)).to(cuda)}

    def state():
        return {"count": torch.tensor(3, dtype=torch.int32, device=cuda),
                "mu": {k: v * 1e-3 for k, v in group().items()},
                "nu": {k: v * v * 1e-6 for k, v in group().items()}}

    pk, sk = group(), state()
    pp, sp = {k: v.clone() for k, v in pk.items()}, {
        "count": sk["count"].clone(), "mu": {k: v.clone() for k, v in sk["mu"].items()},
        "nu": {k: v.clone() for k, v in sk["nu"].items()}}
    for _ in range(2):
        grads = {k: v * 1e-3 for k, v in group().items()}
        if not fit_albedo:
            grads["albedo"] = None
        n0 = adam_update.launches
        sk = adam_update(pk, grads, sk, cfg, *extra)
        torch.cuda.synchronize()
        assert adam_update.launches == n0 + 1
        sp = adam_plain(pp, grads, sp, cfg, *extra)
        assert int(sk["count"]) == int(sp["count"])
        for a, b in ((pk, pp), (sk["mu"], sp["mu"]), (sk["nu"], sp["nu"])):
            for k in a:
                if opacity_l1 and k == "logits":
                    np.testing.assert_allclose(a[k].cpu().numpy(), b[k].cpu().numpy(),
                                               rtol=1e-6, atol=1e-9)
                else:
                    assert _equal(a[k], b[k]), k


def test_adam_kernel_one_group_equals_plain(cuda):
    """One param tensor (fit_albedo's [B, d^3, 3]) as group 0 beside an
    empty group 1, clamped to [0, 1]: bit for bit."""
    from voxelhex_tpu_torch.ops.adam import AdamConfig, adam_plain, adam_update

    rng = np.random.default_rng(12)
    cfg = AdamConfig(0.1)
    pk = torch.from_numpy(rng.random((3905, 64, 3)).astype(np.float32)).to(cuda)
    pp = pk.clone()
    sk, sp = cfg.init(pk), cfg.init(pp)
    for _ in range(3):
        g = torch.from_numpy(rng.normal(0, 1e-2, pk.shape).astype(np.float32)).to(cuda)
        n0 = adam_update.launches
        sk = adam_update(pk, g, sk, cfg, 0.0, ((0.0, 1.0),))
        torch.cuda.synchronize()
        assert adam_update.launches == n0 + 1
        sp = adam_plain(pp, g, sp, cfg, 0.0, ((0.0, 1.0),))
        assert int(sk["count"]) == int(sp["count"])
        for a, b in ((pk, pp), (sk["mu"], sp["mu"]), (sk["nu"], sp["nu"])):
            assert _equal(a, b)
    assert float(pk.min()) >= 0.0 and float(pk.max()) <= 1.0


def _albedo_case(cuda, R=200_000, seed=4):
    rng = np.random.default_rng(seed)
    B, d3 = 3905, 64
    params = torch.from_numpy(rng.random((B, d3, 3)).astype(np.float32)).to(cuda)
    hit = torch.from_numpy(rng.random(R) < 0.6).to(cuda)
    brick = torch.from_numpy(rng.integers(-1, B, R).astype(np.int32)).to(cuda)
    cell = torch.from_numpy(rng.integers(0, d3, R).astype(np.int32)).to(cuda)
    axis = rng.integers(0, 3, R)
    normal = np.zeros((R, 3), np.float32)
    normal[np.arange(R), axis] = rng.choice([-1.0, 1.0], R)  # cube-face normals
    grad = torch.from_numpy(rng.normal(0, 1e-3, (R, 3)).astype(np.float32)).to(cuda)
    return params, hit, brick, cell, torch.from_numpy(normal).to(cuda), grad


def test_albedo_kernels_equal_plain(cuda):
    """The forward bit for bit; the backward's atomics within the
    composite's tolerance of the plain index_add_."""
    from voxelhex_tpu_torch.ops.albedo import (albedo_backward, albedo_backward_plain,
                                               albedo_forward, albedo_forward_plain)

    params, hit, brick, cell, normal, grad = _albedo_case(cuda)
    for bg in ((0.0, 0.0, 0.0), (0.25, 0.5, 0.75)):
        n0 = albedo_forward.launches
        rgb = albedo_forward(params, hit, brick, cell, normal, bg)
        torch.cuda.synchronize()
        assert albedo_forward.launches == n0 + 1
        assert _equal(rgb, albedo_forward_plain(params, hit, brick, cell, normal, bg))
    n0 = albedo_backward.launches
    g = albedo_backward(grad, hit, brick, cell, normal, params.shape[:2])
    torch.cuda.synchronize()
    assert albedo_backward.launches == n0 + 1
    want = albedo_backward_plain(grad, hit, brick, cell, normal, params.shape[:2])
    got, ref = g.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))
    np.testing.assert_array_equal(got == 0, ref == 0)


def _albedo_runs_case(cuda, R=1_000_003, seed=5):
    """Image-ordered runs of 1-64 rays on one row (a voxel seen by
    neighbouring pixels), with misses and hits with brick < 0 inside them,
    at a ray count that leaves the last chunk ragged."""
    rng = np.random.default_rng(seed)
    B, d3 = 3905, 64
    row = np.repeat(rng.integers(0, B * d3, R), rng.integers(1, 65, R))[:R]
    brick = np.where(rng.random(R) < 0.05, -1, row // d3).astype(np.int32)
    hit = rng.random(R) < 0.9
    axis = rng.integers(0, 3, R)
    normal = np.zeros((R, 3), np.float32)
    normal[np.arange(R), axis] = rng.choice([-1.0, 1.0], R)
    grad = rng.normal(0, 1e-3, (R, 3)).astype(np.float32)
    return ((B, d3), torch.from_numpy(hit).to(cuda), torch.from_numpy(brick).to(cuda),
            torch.from_numpy((row % d3).astype(np.int32)).to(cuda),
            torch.from_numpy(normal).to(cuda), torch.from_numpy(grad).to(cuda))


@pytest.mark.parametrize("offset", [0, 1])
def test_albedo_backward_runs_equal_plain(cuda, offset):
    """The backward on coherent rays, its inputs from ``offset`` rays into
    their buffers (``hit`` then starts off its 16 B boundary, ``normal`` and
    dL/drgb off theirs): within the composite's tolerance of the plain
    index_add_, with the zero pattern equal, one launch a call."""
    from voxelhex_tpu_torch.ops.albedo import albedo_backward, albedo_backward_plain

    shape, hit, brick, cell, normal, grad = _albedo_runs_case(cuda)
    hit, brick, cell, normal, grad = (t[offset:] for t in (hit, brick, cell, normal, grad))
    n0 = albedo_backward.launches
    g = albedo_backward(grad, hit, brick, cell, normal, shape)
    torch.cuda.synchronize()
    assert albedo_backward.launches == n0 + 1
    want = albedo_backward_plain(grad, hit, brick, cell, normal, shape)
    got, ref = g.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))
    np.testing.assert_array_equal(got == 0, ref == 0)


def test_albedo_backward_all_miss_is_zero(cuda):
    """Where no ray hits, every warp of the backward leaves at once and the
    gradient is the entry's fill: exactly +0 everywhere, though the caching
    allocator hands the gradient a block that held NaN just before."""
    from voxelhex_tpu_torch.ops.albedo import albedo_backward

    shape, hit, brick, cell, normal, grad = _albedo_runs_case(cuda)
    n = shape[0] * shape[1] * 3
    stale = torch.full((n,), float("nan"), device=cuda)
    del stale
    n0 = albedo_backward.launches
    g = albedo_backward(grad, torch.zeros_like(hit), brick, cell, normal, shape)
    assert albedo_backward.launches == n0 + 1
    got = g.cpu()
    assert bool((got == 0).all()) and not bool(torch.signbit(got).any())


def test_fit_albedo_step_is_three_launches(cuda):
    """fit_albedo with precomputed hits: one traversal, then the albedo
    forward, backward and Adam once a step; the losses match the plain
    versions' run on the CPU."""
    from voxelhex_tpu_torch.diff.fit import fit_albedo
    from voxelhex_tpu_torch.diff.render import DiffRenderer
    from voxelhex_tpu_torch.ops import adam as adam_ops
    from voxelhex_tpu_torch.ops import albedo, traverse
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene_tree
    from voxelhex_tpu_torch.tree.flat import flatten

    flat = flatten(build_scene_tree(4))
    runs = {}
    for dev in ("cuda", "cpu"):
        diff = DiffRenderer(flat, device=dev)
        o, d = device_rays(orbit_camera(128.0, resolution=(160, 90)), dev)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        target = diff.render(diff.init_params(), o, d).detach()
        counters = (traverse.traverse, albedo.albedo_forward, albedo.albedo_backward,
                    adam_ops.adam_update)
        before = [f.launches for f in counters]
        _p, losses = fit_albedo(diff, o, d, target, steps=4, lr=0.1, chain=4,
                                params0=torch.full_like(diff.init_params(), 0.5))
        runs[dev] = (losses, [f.launches - b for f, b in zip(counters, before)])
    assert runs["cuda"][1] == [1, 4, 4, 4] and runs["cpu"][1] == [0, 0, 0, 0]
    losses = runs["cuda"][0]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, runs["cpu"][0], rtol=1e-5)


def test_training_step_is_four_launches(cuda):
    from voxelhex_tpu_torch.diff.optim import adam
    from voxelhex_tpu_torch.diff.soft import SoftRenderer
    from voxelhex_tpu_torch.ops import adam as adam_ops
    from voxelhex_tpu_torch.ops import composite, multihit

    r = SoftRenderer(_grid(density=0.05), max_hits=2, device="cuda")
    p = r.init_params()
    opt = adam(0.05)
    s = opt.init(p)
    o, d = (t.to(cuda) for t in _rays(4000, 64, 8))
    target = torch.full((4000, 3), 0.5, device=cuda)
    before = (multihit.multihit.launches, composite.composite_forward.launches,
              composite.composite_backward.launches, adam_ops.adam_update.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, s, losses = r.train_steps_fused(p, s, opt, o, d, target, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = (multihit.multihit.launches, composite.composite_forward.launches,
             composite.composite_backward.launches, adam_ops.adam_update.launches)
    assert [a - b for a, b in zip(after, before)] == [3, 3, 3, 3]
    losses = losses.cpu().numpy()
    assert np.isfinite(losses).all() and losses[2] < losses[0]


def _batch(K, res, size):
    from voxelhex_tpu_torch.render.camera import orbit_camera

    yaws = [130.0, 130.0, 40.0, 250.0, 250.0, 40.0, 40.0]
    return [orbit_camera(float(size), yaw_deg=yaws[k % len(yaws)], resolution=res)
            for k in range(K)]


# K = 1 and 3, and KMAX + 1 (two launches, the second's baseline the first's
# last frame); 1080p, and ragged pixel tiles at 333 x 187
@pytest.mark.parametrize("K,res", [(1, (1920, 1080)), (3, (1920, 1080)), (33, (1920, 1080)),
                                   (3, (333, 187))])
def test_frames_kernel_equals_plain(cuda, K, res):
    from voxelhex_tpu_torch.ops import _build
    from voxelhex_tpu_torch.ops.frames import render_frames, render_frames_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(size=128, seed=128, density=0.01), cuda)
    cams = _batch(K, res, 128)
    bg = (0.1, 0.2, 0.3)
    w, h = res
    prev = render_frames_plain(tree, cams[:1], bg)[0][0].clone()
    prev[h // 2, w // 3, 1] ^= 1  # the baseline differs from frame 0 in one row
    n0 = render_frames.launches
    k = render_frames(tree, cams, bg, True, prev=prev)
    torch.cuda.synchronize()
    assert render_frames.launches == n0 + -(-K // _build.KMAX)
    p = render_frames_plain(tree, cams, bg, True, prev=prev)
    assert int(p[1][0]) == 1
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape and _equal(a, b)
    f32 = render_frames(tree, cams[:3], bg, False)
    assert f32[1] is None and _equal(f32[0], render_frames_plain(tree, cams[:3], bg, False)[0])


@pytest.mark.parametrize("max_iters", [1, 2, 3, 7])
def test_frames_kernel_stops_at_max_iters(cuda, max_iters):
    """Budgets that cut rays at their first steps and inside an ADVANCE
    step, with a camera outside the world and one inside it."""
    from voxelhex_tpu_torch.ops.frames import render_frames, render_frames_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import Camera

    tree = device_bitgrid(_grid(size=128, seed=128, density=0.01), cuda)
    res = (333, 187)
    inside = np.float32([70.25, 50.5, 60.75])
    cams = _batch(2, res, 128) + [Camera(origin=inside, target=inside + np.float32([1, -2, 3]),
                                         resolution=res)]
    bg = (0.1, 0.2, 0.3)
    prev = render_frames_plain(tree, cams[-1:], bg, True, max_iters)[0][0]
    k = render_frames(tree, cams, bg, True, max_iters, prev)
    torch.cuda.synchronize()
    p = render_frames_plain(tree, cams, bg, True, max_iters, prev)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape and _equal(a, b)
    f32 = render_frames(tree, cams, bg, False, max_iters)[0]
    torch.cuda.synchronize()
    assert _equal(f32, render_frames_plain(tree, cams, bg, False, max_iters)[0])


def test_batched_renderer_paths_equal_cpu(cuda):
    """render_many, render_delta_many and FramePipeline on the card against
    the CPU renderer; a delta batch is one launch of the batched kernel and
    one blocking read when nothing changed."""
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.ops.frames import render_frames
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.pipeline import FramePipeline

    bg = _grid(size=128, seed=4, density=0.01)
    gpu, cpu = fastest_renderer(bg, device="cuda"), fastest_renderer(bg, device="cpu")
    cams = _batch(4, (160, 90), 128)
    for out_u8 in (True, False):
        np.testing.assert_array_equal(gpu.render_many(cams, out_u8=out_u8),
                                      cpu.render_many(cams, out_u8=out_u8))
    for batch in (cams, cams[-1:] * 3, cams[:2]):
        a, b = gpu.render_delta_many(batch), cpu.render_delta_many(batch)
        assert gpu.last_stats == cpu.last_stats
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    n0, m0 = render_frames.launches, render_frame.launches
    same = gpu.render_delta_many(cams[1:2] * 16)
    assert (render_frames.launches - n0, render_frame.launches - m0) == (1, 0)
    assert gpu.last_stats["delta_fetched"] == 0 and gpu.last_stats["host_reads"] == 1
    assert all(f is same[0] for f in same)
    pipe = FramePipeline(gpu)
    futs = [pipe.render(c, out_u8=True) for c in cams]
    pipe.close()
    for f, c in zip(futs, cams):
        np.testing.assert_array_equal(f.result(timeout=60), cpu.render(c, out_u8=True))


# ---- the streaming view's kernels (csrc/stream.cu) and its far-field frame
# (csrc/far.cu)

def _window(S, cuda, density=0.05, seed=0, n_colors=300):
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid

    rng = np.random.default_rng(seed)
    occ = rng.random((S, S, S)) < density
    bg = bitgrid_from_occupancy(occ, palette=rng.random((n_colors, 4)))
    colors = np.where(occ, rng.integers(0, n_colors, occ.shape), 0xFFFF).astype(np.uint16)
    bg.colors = np.ascontiguousarray(colors.transpose(2, 1, 0)).ravel()
    return device_bitgrid(bg, cuda)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("S", [256, 208])
def test_region_scatter_kernel_equals_plain(cuda, wide, S):
    """The fly-over's window (256) and one whose edge is a multiple of 16
    but not a power of two (208), 1,500 regions."""
    from voxelhex_tpu_torch.ops.stream import region_scatter, region_scatter_plain

    K = 1500
    tree = _window(S, cuda)
    rng = np.random.default_rng(11)
    n = S // 16
    picks = rng.choice(n**3, K, replace=False)
    corners = torch.from_numpy(np.stack([picks % n, picks // n % n, picks // (n * n)], 1)
                               .astype(np.int32) * 16).to(cuda)
    if wide:
        vals = rng.integers(0, 2**16, (K, 4096)).astype(np.uint16).view(np.int16)
    else:
        vals = rng.integers(0, 256, (K, 4096)).astype(np.uint8)
    vals = torch.from_numpy(vals).to(cuda)
    blk = torch.from_numpy(rng.integers(0, 2**32, (K, 64, 2), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(cuda)
    want = dict(tree, colors=tree["colors"].clone(), occ_pairs=tree["occ_pairs"].clone())
    region_scatter_plain(want["colors"], want["occ_pairs"], corners, vals, blk, S)
    n0 = region_scatter.launches
    region_scatter(tree, corners, vals, blk)
    torch.cuda.synchronize()
    assert region_scatter.launches == n0 + 1
    assert _equal(tree["colors"], want["colors"]) and _equal(tree["occ_pairs"],
                                                             want["occ_pairs"])


@pytest.mark.parametrize("S", [48, 128, 256])
def test_coarse_rebuild_kernel_equals_plain(cuda, S):
    from voxelhex_tpu_torch.ops.stream import coarse_rebuild, coarse_rebuild_plain

    tree = _window(S, cuda, density=0.0005, seed=S)
    nb = S // 4
    rng = np.random.default_rng(S)
    level0 = (rng.random((nb**3, 2)) < 0.01) * rng.integers(1, 2**31, (nb**3, 2))
    tree["occ_pairs"][: nb**3] = torch.from_numpy(level0.astype(np.int32)).to(cuda)
    want = coarse_rebuild_plain(tree["occ_pairs"].clone(), tree["bases"], tree["dims"])
    n0 = coarse_rebuild.launches
    coarse_rebuild(tree)
    torch.cuda.synchronize()
    assert coarse_rebuild.launches == n0 + 1
    assert _equal(tree["occ_pairs"], want)


def _pyramid(S, cuda):
    """A window's level table and zero word pairs, without its colors."""
    from voxelhex_tpu_torch.render.bitgrid import level_dims

    n = 1
    while level_dims(S, n)[-1] > 1:
        n += 1
    dims = level_dims(S, n)
    bases = [sum(d**3 for d in dims[:i]) for i in range(n)]
    return {"occ_pairs": torch.zeros((sum(d**3 for d in dims), 2), dtype=torch.int32,
                                     device=cuda), "bases": bases, "dims": dims}


@pytest.mark.parametrize("S", [16, 256, 1024])
def test_coarse_rebuild_kernel_twice_in_a_row(cuda, S):
    """Two rebuilds on one stream, level 0 changed between them, each one
    launch equal to the plain version: the ticket counter is back at 0
    after the first (at 1024: 4,096 blocks, levels 3 and 4 made by the last
    block; at 16 a pyramid of two levels)."""
    from voxelhex_tpu_torch.ops.stream import coarse_rebuild, coarse_rebuild_plain

    tree = _pyramid(S, cuda)
    nb = tree["dims"][0]
    gen = torch.Generator(device=cuda).manual_seed(S)
    for share in (0.01, 0.3):
        words = torch.randint(1, 2**31 - 1, (nb**3, 2), generator=gen, device=cuda,
                              dtype=torch.int32)
        keep = torch.rand((nb**3, 2), generator=gen, device=cuda) < share
        tree["occ_pairs"][: nb**3] = torch.where(keep, words, torch.zeros_like(words))
        want = coarse_rebuild_plain(tree["occ_pairs"].clone(), tree["bases"], tree["dims"])
        n0 = coarse_rebuild.launches
        coarse_rebuild(tree)
        torch.cuda.synchronize()
        assert coarse_rebuild.launches == n0 + 1
        assert _equal(tree["occ_pairs"], want)


@pytest.mark.parametrize("shift", [(96, 0, 16), (-80, -16, 0), (32, -48, 16), (256, 0, 0),
                                   (4, 0, -4)])
def test_window_shift_kernel_equals_plain(cuda, shift):
    from voxelhex_tpu_torch.ops.stream import window_shift, window_shift_plain

    S = 256
    tree = _window(S, cuda, seed=5)
    before = (tree["colors"].clone(), tree["occ_pairs"].clone())
    want = window_shift_plain(tree["colors"], tree["occ_pairs"], S, shift)
    n0 = window_shift.launches
    got = window_shift(tree, shift)
    torch.cuda.synchronize()
    assert window_shift.launches == n0 + 1
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])
    assert _equal(tree["colors"], before[0]) and _equal(tree["occ_pairs"], before[1])


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("inside", [True, False])
def test_far_kernel_equals_plain(cuda, n_layers, inside):
    """A window of 64 and rings of 64 cells at factors 4 and 16, each with
    its own camera frame, at 1920 x 1080, u8 and f32."""
    from dataclasses import replace

    from voxelhex_tpu_torch.ops.far import far_frame_plain, render_far
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import Camera

    eye = np.array([30.5, 20.0, 25.5] if inside else [-200.0, 300.0, -250.0], dtype=np.float32)
    target = np.array([300.0, 4.0, 500.0], dtype=np.float32)
    cam = Camera(origin=eye, target=target, resolution=(1920, 1080), fov_y_deg=55.0)
    layers = []
    for i, (factor, origin) in enumerate([(1, (0, 0, 0)), (4, (-64, 0, -64)),
                                          (16, (-512, 0, -512))][:n_layers]):
        o = np.asarray(origin, dtype=np.float32)
        c = replace(cam, origin=(eye - o) / np.float32(factor),
                    target=(target - o) / np.float32(factor))
        layers.append((device_bitgrid(_grid(64, seed=i, density=0.01), cuda), c, factor))
    for out_u8 in (True, False):
        n0 = render_far.launches
        k = render_far(layers, inside, (0.1, 0.2, 0.3), out_u8)
        torch.cuda.synchronize()
        assert render_far.launches == n0 + 1
        assert _equal(k, far_frame_plain(layers, inside, (0.1, 0.2, 0.3), out_u8))


@pytest.mark.parametrize("res", [(61, 43), (1917, 1077)])
def test_far_kernel_blocks_that_go_on_to_the_ring(cuda, res):
    """The camera inside a window whose voxels are a floor: blocks where
    none, some and all of the pixels go on to the ring, ragged edges that
    cut blocks and warps; u8 and f32 equal to the plain version."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, render_far
    from voxelhex_tpu_torch.render.bitgrid import bitgrid_from_occupancy, device_bitgrid
    from voxelhex_tpu_torch.render.camera import Camera

    rng = np.random.default_rng(4)
    occ = rng.random((16, 16, 16)) < 0.6
    occ[:, 5:] = False
    window = bitgrid_from_occupancy(occ, palette=rng.random((5, 4)))
    window.colors = np.ascontiguousarray(np.where(occ, rng.integers(0, 5, occ.shape), 0xFFFF)
                                         .astype(np.uint16).transpose(2, 1, 0)).ravel()
    eye = np.array([8.0, 7.0, 2.5], dtype=np.float32)
    target = np.array([9.0, 6.0, 40.0], dtype=np.float32)
    cam = Camera(origin=eye, target=target, resolution=res, fov_y_deg=70.0)
    ring_cam = Camera(origin=eye / np.float32(2), target=target / np.float32(2), resolution=res,
                      fov_y_deg=70.0)
    layers = [(device_bitgrid(window, cuda), cam, 1),
              (device_bitgrid(_grid(32, seed=3, density=0.03), cuda), ring_cam, 2)]
    for out_u8 in (True, False):
        n0 = render_far.launches
        k = render_far(layers, True, (0.1, 0.2, 0.3), out_u8)
        torch.cuda.synchronize()
        assert render_far.launches == n0 + 1
        stats = []
        assert _equal(k, far_frame_plain(layers, True, (0.1, 0.2, 0.3), out_u8, stats=stats))
    w, h = res
    go = torch.zeros((-(-h // 8) * 8, -(-w // 16) * 16), dtype=torch.bool)
    go[:h, :w] = ~stats[0]["hit"].reshape(h, w).cpu()
    per_block = go.reshape(go.shape[0] // 8, 8, go.shape[1] // 16, 16).sum(dim=(1, 3))
    assert bool((per_block == 0).any()) and bool((per_block == 128).any())
    assert bool(((per_block > 0) & (per_block < 128)).any())


def test_streaming_view_on_the_card_equals_cpu(cuda):
    """A short flight over a 256 terrain through a 64 window (one whole-world
    ring at factor 4): the card's frames and grids equal the CPU's."""
    from voxelhex_tpu_torch.render.camera import Camera
    from voxelhex_tpu_torch.render.streaming import StreamingView
    from voxelhex_tpu_torch.scene import terrain_points
    from voxelhex_tpu_torch.tree.build import from_voxels

    pts, cols = terrain_points(256)
    views = {dev: StreamingView(from_voxels(pts, cols, size=256, brick_dim=4), view_size=64,
                                regions_per_update=64, device=dev) for dev in (cuda, "cpu")}
    for i in range(4):
        cx = 256 * (0.2 + 0.2 * i)
        cam = Camera(origin=np.array([cx - 20.0, 31.0, 72.0]),
                     target=np.array([cx, 13.0, 102.0]), resolution=(320, 180), fov_y_deg=55.0)
        a, b = (views[dev].render(cam, out_u8=True) for dev in (cuda, "cpu"))
        assert np.array_equal(a, b)
        ta, tb = views[cuda].renderer.tree, views["cpu"].renderer.tree
        assert _equal(ta["colors"].cpu(), tb["colors"]) and _equal(ta["occ_pairs"].cpu(),
                                                                   tb["occ_pairs"])


def test_render_service_on_the_card_equals_cpu(cuda):
    """The server's main paths on the card: dense frames (the batched
    kernel), an edit refreshed in place, and a switch to a 64 window with
    its ring (the far-frame and paging kernels), each frame equal to the
    same service's on the CPU."""
    from voxelhex_tpu_torch.scene import terrain_points
    from voxelhex_tpu_torch.serve import RenderService
    from voxelhex_tpu_torch.tree.build import from_voxels

    pts, cols = terrain_points(256)
    # async_far=False: each frame's rings are built on the render thread, so
    # the two services' frames do not depend on their workers' timing
    services = {dev: RenderService(from_voxels(pts, cols, size=256, brick_dim=4),
                                   async_far=False, device=dev) for dev in (cuda, "cpu")}
    poses = [([-40.0, 90.0, -40.0], [128.0, 10.0, 128.0]), ([60.0, 40.0, 20.0],
                                                             [100.0, 12.0, 90.0])]
    edit = {"op": "insert", "pos": [96, 8, 96], "size": 16, "color": [250, 40, 40, 255]}

    def frames():
        out = {dev: [s.render(o, t, (320, 180), 55.0) for o, t in poses + poses[:1]]
               for dev, s in services.items()}
        for a, b in zip(out[cuda], out["cpu"]):
            assert np.array_equal(a, b)
        return out["cpu"]

    dense = frames()
    assert services[cuda].renderer.last_stats["pose_validated"] is False
    for s in services.values():
        assert s.apply_edits(edit) == 1
    edited = frames()
    assert not np.array_equal(dense[0], edited[0])
    for s in services.values():
        s.set_view_size(64)
    streamed = frames()
    assert services[cuda].view.renderer.tree["colors"].is_cuda
    for s in services.values():
        s.set_view_size(0)
    assert np.array_equal(frames()[0], edited[0]) and streamed[0].any()
