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


@pytest.mark.parametrize("max_hits,max_iters", [(2, 2048), (4, 2048), (3, 5)])
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
@pytest.mark.parametrize("K", [1, 2, 4])
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
