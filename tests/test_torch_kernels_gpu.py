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

    rng = np.random.default_rng(seed)
    occ = np.empty((size, size, size), dtype=bool)
    for i in range(size):  # slab by slab: the values of one draw, a bool at a time
        occ[i] = rng.random((size, size)) < density
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


# ---- the start prepasses


def _scene_renderers(cuda, **kw):
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.scene import build_scene

    scene = build_scene()
    return fastest_renderer(scene, device=cuda, **kw), fastest_renderer(scene, device="cpu", **kw)


@pytest.mark.parametrize("dist", [1.8, 6.0, "258"])
def test_beam_kernel_equals_plain(cuda, dist):
    """beam.cu on every tile of the bench scene at 1080p (L = 1 and L = 3),
    against the plain beams, and two cameras of different levels in one
    launch; with "258", two cameras over a random 258^3 beam world (the 1024
    terrain's at L = 1, 2.2 MB of word pairs)."""
    from voxelhex_tpu_torch.ops.beam import beam_tiles, beam_tiles_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera

    if dist == "258":
        grid = device_bitgrid(_grid(258, seed=5, density=0.002), cuda)
        cams = [orbit_camera(1024.0, distance_factor=d, resolution=(1920, 1080))
                for d in (1.8, 1.2)]
        specs = [(grid, 4.0)] * 2
    else:
        gpu, _cpu = _scene_renderers(cuda)
        cams = [orbit_camera(128.0, distance_factor=d, resolution=(1920, 1080))
                for d in (dist, 1.2)]
        specs = [gpu._beam_spec(c) for c in cams]
    assert all(s is not None for s in specs)
    n0 = beam_tiles.launches
    k = beam_tiles([(*s, c) for s, c in zip(specs, cams)], 8, cuda)
    torch.cuda.synchronize()
    assert beam_tiles.launches == n0 + 1
    for i, (s, c) in enumerate(zip(specs, cams)):
        p = beam_tiles_plain(*s, c, 8)
        assert _equal(k[i], p)
    assert (k == 1e8).any()


def test_splat_kernel_equals_plain(cuda):
    """splat.cu on every texel at the bench pose and at a distant pose
    (reliable splats), at 1080p and at 1000x522 (a 500 x 261 buffer, ragged
    in the texel pass's 32 x 16 tiles), against the plain version, each
    call on the scratch of the calls before it."""
    from voxelhex_tpu_torch.ops.splat import splat_tiles, splat_tiles_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    gpu, _cpu = _scene_renderers(cuda)
    pts = gpu._splat_points()
    for res in ((1920, 1080), (1000, 522)):
        for dist in (1.8, 5.0):
            cam = orbit_camera(128.0, distance_factor=dist, resolution=res)
            n0 = splat_tiles.launches
            k = splat_tiles(pts, cam)
            torch.cuda.synchronize()
            assert splat_tiles.launches == n0 + 1
            assert _equal(k, splat_tiles_plain(pts, cam))


@pytest.mark.parametrize("levels,res", [(2, (1920, 1080)), (3, (1000, 520)), (1, (1000, 522))])
def test_prepass_kernels_equal_plain(cuda, levels, res):
    """prepass.cu's one launch (every level's depths and the start map) at
    the bench pose, 1080p with 2 levels and ragged frames of 3 levels and
    of 1, against the plain versions on the same inputs."""
    from voxelhex_tpu_torch.ops.prepass import (depth_start_plain, level_camera,
                                                level_depth_plain, prepass_start)
    from voxelhex_tpu_torch.render.camera import orbit_camera

    gpu, _cpu = _scene_renderers(cuda)
    cam = orbit_camera(128.0, resolution=res)
    depths = []
    n0 = prepass_start.launches
    start = prepass_start(gpu.tree, cam, levels, depths=depths)
    torch.cuda.synchronize()
    assert prepass_start.launches == n0 + 1 and len(depths) == levels
    coarser = None
    for i, k in zip(range(levels, 0, -1), depths):
        want = level_depth_plain(gpu.tree, level_camera(cam, i), coarser)
        assert _equal(k, want)
        coarser = k
    assert _equal(start, depth_start_plain(coarser))


@pytest.mark.parametrize("kw", [{"beam_prepass": True}, {"splat_prepass": True}, "depth",
                                "depth3"])
def test_prepass_frames_on_the_card_equal_cpu(cuda, kw):
    """The renderer's frames with each prepass on the card against the same
    renderer on the CPU at 320 x 176, in u8 and f32, and the beam batch;
    the depth prepass also at 3 levels of a 328 x 184 frame, whose levels
    (164 x 92, 82 x 46, 41 x 23) are ragged in the kernel's tiles."""
    from voxelhex_tpu_torch.render.camera import orbit_camera

    levels = {"depth": 2, "depth3": 3}.get(kw) if isinstance(kw, str) else None
    extra = {"prepass": True, "prepass_levels": levels} if levels else {}
    res = (328, 184) if kw == "depth3" else (320, 176)
    kw = {} if levels else kw
    gpu, cpu = _scene_renderers(cuda, **extra)
    cams = [orbit_camera(128.0, yaw_deg=y, resolution=res) for y in (40.0, 130.0)]
    for u8 in (True, False):
        for cam in cams:
            a = gpu.render(cam, out_u8=u8, **kw)
            np.testing.assert_array_equal(a, cpu.render(cam, out_u8=u8, **kw))
            assert gpu.last_stats["prepass"] == cpu.last_stats["prepass"] is not None
    if kw.get("beam_prepass"):
        got = gpu.render_delta_many(cams, beam_prepass=True)
        want = cpu.render_delta_many(cams, beam_prepass=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---- the skip tracer and the multi-hit march's start form


@pytest.mark.parametrize("size,density", [(4, 0.3), (16, 0.05), (64, 0.02), (128, 0.01),
                                          (260, 0.002), (1028, 0.0005)])
def test_skip_traverse_kernel_equals_plain(cuda, size, density):
    """Each skip instance at the depth of a random grid of ``size`` (1 to 6
    levels; 1028: 257^3 rows of 48 B, 815 MB) against its plain version:
    traverse.cu's, every output, at substeps 1 and 3; frame.cu's and
    frames.cu's frames, prepass.cu's one launch of 1 level and
    multihit.cu's march (K = 3) at 3."""
    from voxelhex_tpu_torch.ops.frame import render_frame, render_frame_plain
    from voxelhex_tpu_torch.ops.frames import render_frames, render_frames_plain
    from voxelhex_tpu_torch.ops.multihit import multihit, multihit_plain
    from voxelhex_tpu_torch.ops.prepass import (depth_start_plain, level_camera,
                                                level_depth_plain, prepass_start)
    from voxelhex_tpu_torch.ops.skip import trace_skip, trace_skip_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import orbit_camera

    tree = device_bitgrid(_grid(size, density=density), cuda, skip_rows=True)
    o, d = (t.to(cuda) for t in _rays(5000, size, 1))
    for substeps in (1, 3):
        n0 = trace_skip.launches
        k = trace_skip(tree, o, d, substeps=substeps)
        torch.cuda.synchronize()
        assert trace_skip.launches == n0 + 1
        for a, b in zip(k, trace_skip_plain(tree, o, d, substeps=substeps)):
            assert _equal(a, b)
    assert int(k[0].sum()) > 1000
    cams = [orbit_camera(float(size), yaw_deg=y, resolution=(320, 176)) for y in (40.0, 130.0)]
    assert _equal(render_frame(tree, cams[0], skip_substeps=3),
                  render_frame_plain(tree, cams[0], skip_substeps=3))
    prev = torch.zeros((176, 320, 3), dtype=torch.uint8, device=cuda)
    for a, b in zip(render_frames(tree, cams, prev=prev, skip_substeps=3),
                    render_frames_plain(tree, cams, prev=prev, skip_substeps=3)):
        assert _equal(a, b)
    depths = []
    start = prepass_start(tree, cams[0], 1, skip_substeps=3, depths=depths)
    want = level_depth_plain(tree, level_camera(cams[0], 1), None, skip_substeps=3)
    assert _equal(depths[0], want) and _equal(start, depth_start_plain(want))
    for a, b in zip(multihit(tree, o, d, 3, skip_substeps=3),
                    multihit_plain(tree, o, d, 3, skip_substeps=3)):
        assert _equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"beam_prepass": True}, {"splat_prepass": True}, "depth"])
def test_skip_frames_on_the_card_equal_cpu(cuda, kw):
    """The skip renderer's frames on the card (frame.cu's, frames.cu's and
    prepass.cu's skip instances) against the same renderer on the CPU at
    320 x 176, in u8 and f32, and a delta batch."""
    from voxelhex_tpu_torch.ops.frame import render_frame
    from voxelhex_tpu_torch.render.camera import orbit_camera

    extra = {"prepass": True, "prepass_levels": 2} if kw == "depth" else {}
    kw = {} if kw == "depth" else kw
    gpu, cpu = _scene_renderers(cuda, tracer="skip", **extra)
    cams = [orbit_camera(128.0, yaw_deg=y, resolution=(320, 176)) for y in (40.0, 130.0)]
    n0 = render_frame.skip_launches
    for u8 in (True, False):
        for cam in cams:
            np.testing.assert_array_equal(gpu.render(cam, out_u8=u8, **kw),
                                          cpu.render(cam, out_u8=u8, **kw))
    assert render_frame.skip_launches == n0 + 4
    bkw = {"beam_prepass": True} if kw.get("beam_prepass") else {}
    for a, b in zip(gpu.render_delta_many(cams, **bkw), cpu.render_delta_many(cams, **bkw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["start", "skip", "skip+start"])
def test_multihit_forms_equal_plain(cuda, form):
    """multihit.cu's start and skip forms against the plain march, K = 3,
    from a start map over the rays as a 100-wide frame."""
    from voxelhex_tpu_torch.ops.multihit import multihit, multihit_plain
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    tree = device_bitgrid(_grid(), cuda, skip_rows=True)
    o, d = (t.to(cuda) for t in _rays(5000, 64, 2))
    rng = np.random.default_rng(3)
    smap = torch.from_numpy(np.where(rng.random((7, 13)) < 0.3, 1e8, rng.uniform(0, 40, (7, 13)))
                            .astype(np.float32)).to(cuda)
    start = None if form == "skip" else (smap, 8, 100)
    substeps = 3 if "skip" in form else None
    counter = "skip_launches" if substeps else "start_launches"
    n0 = getattr(multihit, counter)
    k = multihit(tree, o, d, 3, start=start, skip_substeps=substeps)
    torch.cuda.synchronize()
    assert getattr(multihit, counter) == n0 + 1
    for a, b in zip(k, multihit_plain(tree, o, d, 3, start=start, skip_substeps=substeps)):
        assert _equal(a, b)
    assert int((k[0] >= 2).sum()) > 100


# ---- the chained depth prepass, the skip far frame, the skip rows' refresh,
# the LOD frame


@pytest.mark.parametrize("levels,tracer", [(9, "stack"), (9, "skip"), (10, "stack")])
def test_prepass_chain_equals_plain(cuda, levels, tracer):
    """Past 8 levels the depth prepass is a chain of launches (9: one level,
    then 8; 10: two, then 8): every level's depths and the start map of a
    512 x 512 frame (1024 x 1024 at 10) equal the plain versions, and a
    renderer with ``prepass_levels`` 9 renders the CPU route's frame."""
    from voxelhex_tpu_torch.ops.prepass import (depth_start_plain, level_camera,
                                                level_depth_plain, prepass_chunks, prepass_start)
    from voxelhex_tpu_torch.render.camera import orbit_camera

    substeps = 3 if tracer == "skip" else None
    kw = {"tracer": "skip"} if substeps else {}
    gpu, cpu = _scene_renderers(cuda, prepass=True, prepass_levels=levels, **kw)
    res = (2**levels,) * 2
    cam = orbit_camera(128.0, resolution=res)
    depths = []
    counter = "skip_launches" if substeps else "launches"
    n0 = getattr(prepass_start, counter)
    start = prepass_start(gpu.tree, cam, levels, skip_substeps=substeps, depths=depths)
    torch.cuda.synchronize()
    assert getattr(prepass_start, counter) == n0 + len(prepass_chunks(levels)) > n0 + 1
    coarser = None
    for i, k in zip(range(levels, 0, -1), depths):
        want = level_depth_plain(gpu.tree, level_camera(cam, i), coarser, skip_substeps=substeps)
        assert _equal(k, want)
        coarser = k
    assert _equal(start, depth_start_plain(coarser))
    if levels == 9:
        np.testing.assert_array_equal(gpu.render(cam, out_u8=True), cpu.render(cam, out_u8=True))


def _skip_layers(cuda, depths, inside, res=(1920, 1080)):
    """A far frame whose window and rings have pyramids of ``depths``
    levels (grids of 64 or 16 cells), with their skip rows."""
    from dataclasses import replace

    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid
    from voxelhex_tpu_torch.render.camera import Camera

    eye = np.array([30.5, 20.0, 25.5] if inside else [-200.0, 300.0, -250.0], dtype=np.float32)
    target = np.array([300.0, 4.0, 500.0], dtype=np.float32)
    cam = Camera(origin=eye, target=target, resolution=res, fov_y_deg=55.0)
    layers = []
    for i, (factor, origin) in enumerate([(1, (0, 0, 0)), (4, (-64, 0, -64)),
                                          (16, (-512, 0, -512))][:len(depths)]):
        o = np.asarray(origin, dtype=np.float32)
        c = replace(cam, origin=(eye - o) / np.float32(factor),
                    target=(target - o) / np.float32(factor))
        size = {3: 64, 2: 16, 4: 128}[depths[i]]
        grid = _grid(size, seed=i, density=0.01 if size > 16 else 0.05)
        layers.append((device_bitgrid(grid, cuda, skip_rows=True), c, factor))
    return layers


@pytest.mark.parametrize("depths", [(3,), (3, 3), (3, 3, 2), (4, 3)])
@pytest.mark.parametrize("inside", [True, False])
def test_far_skip_kernel_equals_plain(cuda, depths, inside):
    """far.cu's skip instance of the window's depth, with rings of its depth
    and one level less, at 1920 x 1080, u8 and f32, with and without a
    window start map, against the plain skip far frame; a ring two levels
    shallower raises."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, render_far

    layers = _skip_layers(cuda, depths, inside)
    rng = np.random.default_rng(7)
    start = torch.from_numpy(rng.uniform(0, 60, (135, 240)).astype(np.float32)).to(cuda)
    for out_u8, st in ((True, None), (False, None), (True, start)):
        n0 = render_far.skip_launches
        k = render_far(layers, inside, (0.1, 0.2, 0.3), out_u8, start=st, start_tile=8,
                       skip_substeps=3)
        torch.cuda.synchronize()
        assert render_far.skip_launches == n0 + 1
        assert _equal(k, far_frame_plain(layers, inside, (0.1, 0.2, 0.3), out_u8, start=st,
                                         start_tile=8, skip_substeps=3))
    if depths == (4, 3):
        with pytest.raises(ValueError, match="levels"):
            render_far(_skip_layers(cuda, (4, 2), inside), inside, skip_substeps=3)


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("depths", [(3, 3), (3, 2)])
@pytest.mark.parametrize("inside", [True, False])
def test_far_skip_kernel_other_substeps_equal_plain(cuda, substeps, depths, inside):
    """far.cu's skip instances for substeps other than the view's 3 (which
    has instances of its own), at 1920 x 1080, u8 and f32, with and without
    a window start map, against the plain skip far frame."""
    from voxelhex_tpu_torch.ops.far import far_frame_plain, render_far

    layers = _skip_layers(cuda, depths, inside)
    rng = np.random.default_rng(8)
    start = torch.from_numpy(rng.uniform(0, 60, (135, 240)).astype(np.float32)).to(cuda)
    for out_u8, st in ((True, None), (False, start)):
        k = render_far(layers, inside, (0.1, 0.2, 0.3), out_u8, start=st, start_tile=8,
                       skip_substeps=substeps)
        torch.cuda.synchronize()
        assert _equal(k, far_frame_plain(layers, inside, (0.1, 0.2, 0.3), out_u8, start=st,
                                         start_tile=8, skip_substeps=substeps))


@pytest.mark.parametrize("with_count", [True, False])
def test_composite_backward_bench_equals_plain(cuda, with_count):
    """The composite backward at the training step's shapes: the bench scene
    at 1920 x 1080, the march at K = 2 over SoftRenderer's initial params,
    dL/drgb of a constant target, with the march's count (as the step calls
    it) and without, against the plain version: one launch, the gradients
    within the composite's tolerance and zero where its are."""
    from voxelhex_tpu_torch.diff.soft import SoftRenderer
    from voxelhex_tpu_torch.ops.composite import (composite_backward, composite_backward_plain,
                                                  composite_forward)
    from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
    from voxelhex_tpu_torch.scene import build_scene

    soft = SoftRenderer(build_scene(), max_hits=2, device=cuda)
    params = soft.init_params()
    albedo, logits = params["albedo"].reshape(-1), params["logits"]
    o, d = device_rays(orbit_camera(128.0, resolution=(1920, 1080)), cuda)
    count, voxels, _dists = soft.trace_hits(o, d)
    rgb = composite_forward(albedo, logits, voxels, soft.size)
    grad = (2.0 * (rgb - torch.tensor([0.25, 0.5, 0.75], device=cuda)) / rgb.numel())
    n0 = composite_backward.launches
    ga, gl = composite_backward(grad.contiguous(), albedo, logits, voxels, soft.size,
                                count=count if with_count else None)
    torch.cuda.synchronize()
    assert composite_backward.launches == n0 + 1
    wa, wl = composite_backward_plain(grad, albedo, logits, voxels, soft.size)
    assert int((wl != 0).sum()) > 10000
    for got, ref in ((ga, wa), (gl, wl)):
        scale = float(ref.abs().max())
        assert bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-6 * scale).all())
        assert bool(((got == 0) == (ref == 0)).all())


@pytest.mark.parametrize("S", [16, 48, 256, 1024])
def test_skip_rows_refresh_equals_plain(cuda, S):
    """refresh_skip_rows' kernel against the reference's gather
    (``skip_rows_from_pairs``) on random pairs, twice, the second time in
    place in the rows of the first."""
    from voxelhex_tpu_torch.ops.stream import refresh_skip_rows, skip_rows_plain

    tree = _pyramid(S, cuda)
    tree["size"] = S
    g = torch.Generator(device=cuda).manual_seed(S)
    tree["occ_pairs"].random_(-2**31, 2**31 - 1, generator=g)
    n0 = refresh_skip_rows.launches
    refresh_skip_rows(tree)
    rows = tree["skip_rows"]
    refresh_skip_rows(tree)
    torch.cuda.synchronize()
    assert refresh_skip_rows.launches == n0 + 2 and tree["skip_rows"] is rows
    want = skip_rows_plain(tree["occ_pairs"], tree["bases"], tree["dims"], S)
    assert _equal(rows, want)


@pytest.fixture(scope="module")
def world_512():
    """The brick-32 512 world of chip_smoke.py phase 10 on the card (its MIP
    grids built at first use), built once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from voxelhex_tpu_torch.render import fastest_renderer
    from voxelhex_tpu_torch.render.bitgrid import build_bitgrid
    from voxelhex_tpu_torch.scene import build_scene_tree
    from voxelhex_tpu_torch.tree.flat import flatten

    return fastest_renderer(build_bitgrid(flatten(build_scene_tree(32))),
                            device=torch.device("cuda", 0))


@pytest.mark.parametrize("scale", [0.0, 0.3, 0.05, 2.0, float("inf"), -1.0, float("nan")])
def test_lod_kernel_equals_plain(cuda, world_512, scale):
    """frame_lod_kernel against render_lod_plain on every pixel of the bench
    pose at 1920 x 1080 and of a ragged 1001 x 523 frame, and the renderer's
    render_lod on the card against the CPU's; the stopless instance at
    lod_scale 0, -1 and NaN, and only there; then the brick-32 512 world
    (chip_smoke.py phase 10) at 1080p."""
    from voxelhex_tpu_torch.ops.frame import render_lod, render_lod_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    stopless = not scale > 0.0
    gpu, cpu = _scene_renderers(cuda)
    for res in ((1920, 1080), (1001, 523)):
        cam = orbit_camera(128.0, resolution=res)
        n0, s0 = render_lod.launches, render_lod.stopless_launches
        a = gpu.render_lod(cam, scale, bg=(0.1, 0.2, 0.3))
        torch.cuda.synchronize()
        assert render_lod.launches == n0 + 1 and a.dtype == np.float32
        assert render_lod.stopless_launches == s0 + stopless
        assert _equal(torch.from_numpy(a), render_lod_plain(gpu.tree, cam, scale,
                                                            (0.1, 0.2, 0.3)).cpu())
        if res[0] < 1920:
            np.testing.assert_array_equal(a, cpu.render_lod(cam, scale, bg=(0.1, 0.2, 0.3)))
    cam = orbit_camera(128.0, resolution=(1920, 1080))
    s0 = render_lod.stopless_launches
    a = world_512.render_lod(cam, scale)
    assert render_lod.stopless_launches == s0 + stopless
    assert _equal(torch.from_numpy(a), render_lod_plain(world_512.tree, cam, scale).cpu())


def test_streaming_skip_view_on_the_card_equals_cpu(cuda):
    """The skip view over a short flight (a 256 terrain through a 64 window,
    one ring), with the beam prepass: the card's frames, grids and skip rows
    equal the CPU's; one far launch a frame."""
    from voxelhex_tpu_torch.ops.far import render_far
    from voxelhex_tpu_torch.render.camera import Camera
    from voxelhex_tpu_torch.render.streaming import StreamingView
    from voxelhex_tpu_torch.scene import terrain_points
    from voxelhex_tpu_torch.tree.build import from_voxels

    pts, cols = terrain_points(256)
    views = {dev: StreamingView(from_voxels(pts, cols, size=256, brick_dim=4), view_size=64,
                                regions_per_update=64, tracer="skip", beam_prepass=True,
                                device=dev) for dev in (cuda, "cpu")}
    for i in range(4):
        cx = 256 * (0.2 + 0.2 * i)
        cam = Camera(origin=np.array([cx - 20.0, 31.0, 72.0]),
                     target=np.array([cx, 13.0, 102.0]), resolution=(320, 180), fov_y_deg=55.0)
        n0 = render_far.skip_launches
        a = views[cuda].render(cam, out_u8=True)
        assert render_far.skip_launches == n0 + 1
        np.testing.assert_array_equal(a, views["cpu"].render(cam, out_u8=True))
        for ta, tb in ((views[cuda].renderer.tree, views["cpu"].renderer.tree),
                       (views[cuda].far.tiers[0].renderer.tree,
                        views["cpu"].far.tiers[0].renderer.tree)):
            assert _equal(ta["skip_rows"].cpu(), tb["skip_rows"])
            assert _equal(ta["occ_pairs"].cpu(), tb["occ_pairs"])


# the stack automaton's options of the renderer (ops.traverse.AutomatonOptions
# fields), each an optioned instance; and the u8 color grid
GPU_OPTIONS = [(False, False, 4), (True, False, 0), (True, False, 1), (True, False, 3),
               (True, True, 4), (False, True, 2)]


def _options_tree(cuda, u8, skip=False):
    """_grid's 64^3 world (7 colors: a u8 grid with ``u8``) with a
    colorless voxel, on the card."""
    from voxelhex_tpu_torch.constants import COLOR_NONE
    from voxelhex_tpu_torch.render.bitgrid import device_bitgrid

    bg = _grid()
    hit = np.flatnonzero(bg.colors != 0xFFFF)
    bg.colors = bg.colors.copy()
    bg.colors[hit[::5]] = COLOR_NONE
    tree = device_bitgrid(bg, cuda, skip_rows=skip, color_u8=u8)
    assert tree["colors"].dtype == (torch.uint8 if u8 else torch.int16)
    return tree


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("options", GPU_OPTIONS)
def test_option_instances_equal_plain(cuda, options, u8):
    """traverse.cu's, frame.cu's (with and without a start map), frames.cu's
    (with the digest) and prepass.cu's optioned instances, over u16 and u8
    colors, at the default step limit and at 7, against their plain
    versions; each call launches the optioned instance."""
    from voxelhex_tpu_torch.ops.frame import render_frame, render_frame_plain
    from voxelhex_tpu_torch.ops.frames import render_frames, render_frames_plain
    from voxelhex_tpu_torch.ops.prepass import prepass_start
    from voxelhex_tpu_torch.ops.traverse import AutomatonOptions, traverse, traverse_plain
    from voxelhex_tpu_torch.render.camera import orbit_camera

    opts = AutomatonOptions(*options)
    tree = _options_tree(cuda, u8)
    o, d = (t.to(cuda) for t in _rays(5000, 64, 1))
    cams = [orbit_camera(64.0, yaw_deg=y, resolution=(67, 41)) for y in (30.0, 150.0)]
    start = torch.rand((6, 9), device=cuda) * 40.0
    prev = torch.zeros((41, 67, 3), dtype=torch.uint8, device=cuda)
    for max_iters in (2048 if opts.advance_substeps > 0 else 100, 7):
        n = (traverse.launches, traverse.option_launches, traverse.u8_launches)
        k = traverse(tree, o, d, max_iters, opts)
        torch.cuda.synchronize()
        assert (traverse.launches, traverse.option_launches, traverse.u8_launches) == (
            n[0] + 1, n[1] + 1, n[2] + u8)
        for a, b in zip(k, traverse_plain(tree, o, d, max_iters, opts)):
            assert _equal(a, b)
        for s in (None, start):
            n0 = render_frame.option_launches
            got = render_frame(tree, cams[0], (0.1, 0.2, 0.3), False, max_iters, s, 8,
                               options=opts)
            assert render_frame.option_launches == n0 + 1
            assert _equal(got, render_frame_plain(tree, cams[0], (0.1, 0.2, 0.3), False,
                                                  max_iters, s, 8, options=opts))
        n0 = render_frames.option_launches
        got = render_frames(tree, cams, max_iters=max_iters, prev=prev, options=opts)
        assert render_frames.option_launches == n0 + 1
        want = render_frames_plain(tree, cams, max_iters=max_iters, prev=prev, options=opts)
        for a, b in zip(got, want):
            assert _equal(a, b)
        n0 = prepass_start.option_launches
        depths = []
        got = prepass_start(tree, orbit_camera(64.0, resolution=(64, 48)), 2, max_iters,
                            depths=depths, options=opts)
        assert prepass_start.option_launches == n0 + 1
        cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in tree.items()}
        plain_depths = []
        want = prepass_start(cpu, orbit_camera(64.0, resolution=(64, 48)), 2, max_iters,
                             depths=plain_depths, options=opts)
        assert _equal(got.cpu(), want)
        for a, b in zip(depths, plain_depths):
            assert _equal(a.cpu(), b)


def test_u8_instances_equal_plain(cuda):
    """The u8 instances of the default options (traverse.cu, frame.cu with
    and without a start map, frames.cu), of the skip tracer (traverse.cu,
    frame.cu, frames.cu) and of the LOD frame (stop and stopless) against
    their plain versions and the u16 instances' outputs."""
    from voxelhex_tpu_torch.ops.frame import render_frame, render_lod, render_lod_plain
    from voxelhex_tpu_torch.ops.frames import render_frames
    from voxelhex_tpu_torch.ops.skip import trace_skip, trace_skip_plain
    from voxelhex_tpu_torch.ops.traverse import traverse, traverse_plain
    from voxelhex_tpu_torch.render.bitgrid import build_mip_colors
    from voxelhex_tpu_torch.render.camera import orbit_camera

    t8, t16 = _options_tree(cuda, True, skip=True), _options_tree(cuda, False, skip=True)
    o, d = (t.to(cuda) for t in _rays(5000, 64, 3))
    cams = [orbit_camera(64.0, yaw_deg=y, resolution=(67, 41)) for y in (30.0, 150.0)]
    start = torch.rand((6, 9), device=cuda) * 40.0
    n = (traverse.u8_launches, trace_skip.u8_launches, render_frame.u8_launches,
         render_frames.u8_launches, render_lod.u8_launches)
    for a, b, c in zip(traverse(t8, o, d), traverse_plain(t8, o, d), traverse(t16, o, d)):
        assert _equal(a, b) and _equal(a, c)
    for a, b, c in zip(trace_skip(t8, o, d), trace_skip_plain(t8, o, d), trace_skip(t16, o, d)):
        assert _equal(a, b) and _equal(a, c)
    for skip in (None, 3):
        for s in (None, start):
            got = render_frame(t8, cams[0], start=s, start_tile=8, skip_substeps=skip)
            assert _equal(got, render_frame(t16, cams[0], start=s, start_tile=8,
                                            skip_substeps=skip))
        got = render_frames(t8, cams, skip_substeps=skip)[0]
        assert _equal(got, render_frames(t16, cams, skip_substeps=skip)[0])
    bg = _grid()
    build_mip_colors(bg)
    for l, grid in enumerate(bg.mip_rgb):
        t8[f"mip_rgb_{l}"] = torch.from_numpy(grid).to(cuda)
    for scale in (0.0, 0.3):
        got = render_lod(t8, cams[1], scale)
        cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in t8.items()}
        assert _equal(got.cpu(), render_lod_plain(cpu, cams[1], scale))
    torch.cuda.synchronize()
    assert (traverse.u8_launches, trace_skip.u8_launches, render_frame.u8_launches,
            render_frames.u8_launches, render_lod.u8_launches) == (
        n[0] + 1, n[1] + 1, n[2] + 4, n[3] + 2, n[4] + 2)


def _flat_tree(size=64, brick_dim=4, n=3000, seed=5):
    """A port FlatTree of ``n`` random voxels and one uniform node (``size``
    is ``brick_dim * 4**k``)."""
    from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree
    from voxelhex_tpu_torch.tree.flat import flatten

    cols = [Albedo.from_u32(v) for v in (0xFF0000FF, 0x00FF00FF, 0x0000FFFF)]
    tree = BoxTree(size, brick_dim, auto_simplify=False)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        tree.insert(tuple(int(v) for v in rng.integers(0, size, 3)), cols[rng.integers(0, 3)])
    tree.insert_at_lod((8, 8, 8), 4, cols[0])
    return flatten(tree)


@pytest.mark.parametrize("brick_dim", [4, 8])
@pytest.mark.parametrize("tracer", ["vmap", "wavefront", "fast"])
@pytest.mark.parametrize("limit", [None, 7])
def test_flat_kernels_equal_plain(cuda, brick_dim, tracer, limit):
    """Each flat-tree kernel (``csrc/flat.cu``) against its plain tracer on
    the card, all six outputs bit for bit, at the default caps and at 7
    steps; the fast kernel also from a start a ray and in its depth form."""
    from voxelhex_tpu_torch.ops import flat as ops
    from voxelhex_tpu_torch.render.fast import make_fast_tracer, pack_device_tree, prepass_depth
    from voxelhex_tpu_torch.render.jax_renderer import device_tree, make_trace_ray
    from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer

    flat = _flat_tree(64, 4, 3000) if brick_dim == 4 else _flat_tree(32, 8, 1500)
    o, d = (t.to(cuda) for t in _rays(6000, flat.size, 21))
    if tracer == "vmap":
        tree, cap = device_tree(flat, cuda), limit or 2048
        got = ops.trace_vmap(tree, brick_dim, o, d, cap)
        want = make_trace_ray(brick_dim, ops.MAX_RESTARTS, cap)(tree, o, d)
    elif tracer == "wavefront":
        tree, cap = device_tree(flat, cuda), limit or 4096
        got = ops.trace_wavefront(tree, brick_dim, o, d, cap)
        want = make_wavefront_tracer(brick_dim, cap)(tree, o, d)
    else:
        tree, cap = pack_device_tree(flat, cuda), limit or 4096
        trace = make_fast_tracer(brick_dim, cap)
        got = ops.trace_fast(tree, brick_dim, o, d, cap)
        want = trace(tree, o, d)
        depth = ops.trace_fast(tree, brick_dim, o, d, cap, depth=True)
        assert _equal(depth, prepass_depth(want[0], want[4], o))
        start = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(3)).to(cuda) * 64
        for a, b in zip(ops.trace_fast(tree, brick_dim, o, d, cap, start_t=start),
                        trace(tree, o, d, start)):
            assert _equal(a, b)
    torch.cuda.synchronize()
    if limit is None:
        assert int(want[0].sum()) > 1000
    for a, b in zip(got, want):
        assert _equal(a, b)


def test_flat_renderers_render_on_the_card(cuda):
    """The three flat renderers' frames on the card (the prepassed one
    too) equal their CPU frames, each through its kernel."""
    from voxelhex_tpu_torch.ops import flat as ops
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.fast import FastRenderer
    from voxelhex_tpu_torch.render.jax_renderer import JaxRenderer
    from voxelhex_tpu_torch.render.wavefront import WavefrontRenderer

    flat = _flat_tree()
    cam = orbit_camera(64.0, resolution=(160, 96))
    for cls, kw, counter, n in ((JaxRenderer, {}, ops.trace_vmap, 1),
                                (WavefrontRenderer, {}, ops.trace_wavefront, 1),
                                (FastRenderer, {}, ops.trace_fast, 1),
                                (FastRenderer, {"prepass": True}, ops.trace_fast, 2)):
        n0 = counter.launches
        frame = cls(flat, **kw).render(cam, bg=(0.1, 0.2, 0.3))
        assert counter.launches == n0 + n
        assert np.array_equal(frame, cls(flat, device="cpu", **kw).render(cam, bg=(0.1, 0.2, 0.3)))


@pytest.mark.parametrize("brick_dim", [4, 8])
@pytest.mark.parametrize("res", [(160, 96), (157, 93)])
@pytest.mark.parametrize("limit", [None, 9])
def test_flat_kernels_on_tiles_equal_plain(cuda, brick_dim, res, limit):
    """The batched flat kernels with a frame's width (warps on 4 x 8 tiles,
    frames whose sides are not multiples of 4 and 8 too) against their
    plain tracers on every ray of the frame, all six outputs bit for bit:
    the wavefront, the fast kernel and its depth form, and on the even
    frame the full-res march from the pooled half-res depths."""
    from voxelhex_tpu_torch.ops import flat as ops
    from voxelhex_tpu_torch.render.camera import orbit_camera
    from voxelhex_tpu_torch.render.fast import (PREPASS_ENTRY_FMA, make_fast_tracer,
                                                pack_device_tree, prepass_depth, start_from_depth)
    from voxelhex_tpu_torch.render.jax_renderer import device_tree, rays_on
    from voxelhex_tpu_torch.render.wavefront import make_wavefront_tracer

    flat = _flat_tree(64, 4, 3000) if brick_dim == 4 else _flat_tree(32, 8, 1500)
    w, h = res
    cap = limit or 4096
    o, d = rays_on(*orbit_camera(float(flat.size), yaw_deg=35.0, resolution=res).rays(), cuda)
    wf, fast = device_tree(flat, cuda), pack_device_tree(flat, cuda)
    got = ops.trace_wavefront(wf, brick_dim, o, d, cap, _width=w)
    for a, b in zip(got, make_wavefront_tracer(brick_dim, cap)(wf, o, d)):
        assert _equal(a, b)
    trace = make_fast_tracer(brick_dim, cap)
    want = trace(fast, o, d)
    for a, b in zip(ops.trace_fast(fast, brick_dim, o, d, cap, _width=w), want):
        assert _equal(a, b)
    depth = ops.trace_fast(fast, brick_dim, o, d, cap, depth=True, _width=w)
    assert _equal(depth, prepass_depth(want[0], want[4], o))
    if limit is None:
        assert int(want[0].sum()) > 1000
    if w % 2 or h % 2:
        return
    half = orbit_camera(float(flat.size), yaw_deg=35.0, resolution=(w // 2, h // 2))
    po, pd = rays_on(*half.rays(), cuda)
    dmap = ops.trace_fast(fast, brick_dim, po, pd, cap, depth=True, _width=w // 2)
    p = trace(fast, po, pd)
    assert _equal(dmap, prepass_depth(p[0], p[4], po))
    want = make_fast_tracer(brick_dim, cap, entry_fma=PREPASS_ENTRY_FMA)(
        fast, o, d, start_from_depth(dmap, h // 2, w // 2))
    got = ops.trace_fast(fast, brick_dim, o, d, cap, start_depth=(dmap, h // 2, w // 2), _width=w)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _equal(a, b)
