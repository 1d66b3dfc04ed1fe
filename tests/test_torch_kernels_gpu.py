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
    a = fastest_renderer(bg, device="cuda").render(cam)
    b = fastest_renderer(bg, device="cpu").render(cam)
    assert _equal(a.cpu(), b)


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
    r.render(orbit_camera(64.0, resolution=(160, 90)))
    torch.cuda.synchronize()
    assert (render_frame.launches, traverse.launches, shade.launches) == (
        counts[0] + 1, counts[1], counts[2])
