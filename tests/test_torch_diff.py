"""The port's ``DiffRenderer`` (plain versions, on the CPU) against the
reference's, on the small scene of ``tests/test_diff_and_parallel.py``
(random voxels and a solid node, so that ``densify`` has work): the
densified tree, the lookup grids and the initial albedo are equal, the
trace is equal, the render is equal bit for bit (Lambert's products by
+-0.5 are exact, so no multiply-add placement moves it), and the gradient
matches ``jax.grad`` of the reference's loss within the composite's
tolerance (``tests/test_torch_soft.py``: the scatter adds in another
order).  Also the fixes of this slice to the renderers' constructors and
to ``render_delta_many``'s baseline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhex_tpu.diff import render as ref_render
from voxelhex_tpu.diff.soft import SoftRenderer as RefSoft
from voxelhex_tpu.render import bitgrid as refbg
from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
from voxelhex_tpu.tree import boxtree as ref_bt
from voxelhex_tpu.tree.flat import flatten as ref_flatten
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.diff import render
from voxelhex_tpu_torch.diff.soft import SoftRenderer
from voxelhex_tpu_torch.ops import albedo as albedo_ops
from voxelhex_tpu_torch.render import bitgrid as portbg
from voxelhex_tpu_torch.render.camera import device_rays, orbit_camera
from voxelhex_tpu_torch.render.renderer import BitGridRenderer

RED = ref_bt.Albedo.from_u32(0xFF0000FF)
GREEN = ref_bt.Albedo.from_u32(0x00FF00FF)
FLAT_FIELDS = ("node_meta", "node_children", "node_ocbits", "node_mips", "bricks", "palette")


@pytest.fixture(scope="module")
def scene():
    """The reference's small scene, its FlatTree in both packages, and rays
    of three poses."""
    tree = ref_bt.BoxTree(16, 4, auto_simplify=False)
    rng = np.random.default_rng(13)
    for _ in range(60):
        p = tuple(int(v) for v in rng.integers(0, 16, 3))
        tree.insert(p, RED if rng.random() < 0.5 else GREEN)
    tree.insert_at_lod((4, 4, 4), 4, GREEN)  # a solid node: densify has work
    ref_flat = ref_flatten(tree)
    port_flat = convert.from_jax_flat_tree(
        {"size": ref_flat.size, "brick_dim": ref_flat.brick_dim,
         **{k: getattr(ref_flat, k) for k in FLAT_FIELDS + ("brick_ocbits",)}})
    o, d = zip(*(ref_orbit(16.0, yaw_deg=y, resolution=(40, 32)).rays() for y in (40, 130, 250)))
    return ref_flat, port_flat, np.concatenate(o).reshape(-1, 3), np.concatenate(d).reshape(-1, 3)


def test_densify_grids_and_init_equal_reference(scene):
    ref_flat, port_flat, _o, _d = scene
    a, b = ref_render.densify(ref_flat), render.densify(port_flat)
    assert b.n_bricks > port_flat.n_bricks  # the solid node became bricks
    for k in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    for x, y in zip(ref_render.dense_brick_cells(a), render.dense_brick_cells(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(ref_render.albedo_params_from_flat(a)),
                                  render.albedo_params_from_flat(b).numpy())


def test_trace_render_and_gradient_equal_reference(scene):
    ref_flat, port_flat, o, d = scene
    ref = ref_render.DiffRenderer(ref_flat)
    port = render.DiffRenderer(port_flat, device="cpu")
    r_out = [np.asarray(x) for x in jax.jit(ref.trace_rays)(o, d)]
    p_out = [x.numpy() for x in port.trace_rays(o, d)]
    for name, x, y in zip(("hit", "voxel", "brick", "cell", "normal"), r_out[:4] + r_out[5:],
                          p_out[:4] + p_out[5:]):
        np.testing.assert_array_equal(x, y, err_msg=name)
    # point: where the march stopped, with the kernels' four DDA substeps an
    # ADVANCE (the reference DiffRenderer's tracer takes two)
    tracer = refbg.make_bitgrid_tracer(ref.bitgrid, max_iters=2048, advance_substeps=4)
    np.testing.assert_array_equal(np.asarray(jax.jit(tracer)(ref.tree, o, d)[3]), p_out[4])
    hit, brick = p_out[0], p_out[2]
    assert hit.sum() > 300 and (~hit).sum() > 300 and (brick[hit] >= 0).all()

    rng = np.random.default_rng(4)
    params = rng.random(np.asarray(ref.init_params()).shape).astype(np.float32)
    target = rng.random((o.shape[0], 3)).astype(np.float32)
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    want = np.asarray(jax.jit(ref.render)(jnp.asarray(params), o, d, jnp.asarray(bg)))
    pt = torch.from_numpy(params)
    np.testing.assert_array_equal(port.render(pt, o, d, bg).numpy(), want)

    # the reference's shading on the trace's hits and normals
    albedo_rgb = rng.random((o.shape[0], 3)).astype(np.float32)
    np.testing.assert_array_equal(
        render.shade_diff(torch.from_numpy(albedo_rgb), torch.from_numpy(hit),
                          torch.from_numpy(p_out[5]), bg).numpy(),
        np.asarray(jax.jit(ref_render.shade_diff)(albedo_rgb, hit, p_out[5], bg)))

    g_ref = np.asarray(jax.grad(ref.loss)(jnp.asarray(params), o, d, target))
    p = pt.clone().requires_grad_(True)
    port.loss(p, o, d, target).backward()
    g = p.grad.numpy()
    scale = float(np.abs(g_ref).max())
    assert scale > 0 and g.shape == g_ref.shape
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_array_equal(g == 0, g_ref == 0)


def test_albedo_ops_edge_rays():
    """Rays that miss (bg), rays that hit a voxel with no params (brick -1:
    zero, signed as 0 * lambert), rows clipped into range; the backward adds
    only the rays that hit a voxel with params."""
    rng = np.random.default_rng(8)
    B, d3, R = 5, 8, 300
    params = torch.from_numpy(rng.random((B, d3, 3)).astype(np.float32))
    hit = torch.from_numpy(rng.random(R) < 0.7)
    brick = torch.from_numpy(rng.integers(-1, B + 2, R).astype(np.int32))
    cell = torch.from_numpy(rng.integers(-1, d3 + 2, R).astype(np.int32))
    normal = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    bg = (0.1, 0.2, 0.3)
    rgb = albedo_ops.albedo_forward(params, hit, brick, cell, normal, bg)
    lam = albedo_ops.lambert(normal)
    assert bool((rgb[~hit] == torch.tensor(bg)).all())
    empty = hit & (brick < 0)
    assert bool((torch.signbit(rgb[empty]) == (lam[empty] < 0)[:, None]).all())
    ok = hit & (brick >= 0)
    rows = params[brick.clamp(0, B - 1).long(), cell.clamp(0, d3 - 1).long()]
    assert bool((rgb[ok] == rows[ok] * lam[ok][:, None]).all())
    g_rgb = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    g = albedo_ops.albedo_backward(g_rgb, hit, brick, cell, normal, (B, d3))
    want = torch.zeros(B, d3, 3, dtype=torch.float64)
    for r in torch.nonzero(ok).ravel().tolist():
        want[min(int(brick[r]), B - 1), min(max(int(cell[r]), 0), d3 - 1)] += (
            g_rgb[r] * lam[r]).double()
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_reference_positional_calls_build_the_same_renderers():
    """The reference's constructors' positional parameters mean the same in
    the port; ``device`` is keyword-only everywhere."""
    occ = np.random.default_rng(0).random((16, 16, 16)) < 0.05
    pal = np.random.default_rng(1).random((5, 4)).astype(np.float32)
    rbg, pbg = refbg.bitgrid_from_occupancy(occ, palette=pal), portbg.bitgrid_from_occupancy(
        occ, palette=pal)
    ref, port = refbg.BitGridRenderer(rbg, 300), BitGridRenderer(pbg, 300, device="cpu")
    assert port.max_iters == ref._max_iters == 300
    cam = orbit_camera(16.0, resolution=(24, 16))
    np.testing.assert_array_equal(port.render(cam, out_u8=True), ref.render(
        ref_orbit(16.0, resolution=(24, 16)), out_u8=True))
    rs, ps = RefSoft(rbg, 3, 512, "stack"), SoftRenderer(pbg, 3, 512, "stack", device="cpu")
    assert (ps.max_hits, ps.max_iters, ps.flat_params) == (rs.max_hits, rs._max_iters, True)
    ps = SoftRenderer(pbg, 3, 512, "stack", False, False, device="cpu")
    assert not ps.flat_albedo_bwd and not ps.flat_params
    assert ps.init_params()["albedo"].shape == (16**3, 3)
    with pytest.raises(TypeError):
        SoftRenderer(pbg, 3, 512, "stack", True, True, "cpu")
    with pytest.raises(TypeError):
        BitGridRenderer(pbg, 3, False, 2, True, False, 4, False, False, False, "stack", 3, "cpu")
    flat = convert.from_jax_flat_tree(
        {"size": 16, "brick_dim": 4, **{k: getattr(ref_flatten(_one_voxel_tree()), k)
                                        for k in FLAT_FIELDS + ("brick_ocbits",)}})
    dr = render.DiffRenderer(flat, 512, False, device="cpu")
    assert dr.max_inner == 512 and not dr.flat_albedo_bwd


def _one_voxel_tree():
    tree = ref_bt.BoxTree(16, 4)
    tree.insert((3, 4, 5), RED)
    return tree


def test_delta_baseline_holds_one_frame():
    """render_delta_many keeps a copy of the batch's last frame, not a view
    that holds the whole batch."""
    occ = np.random.default_rng(3).random((16, 16, 16)) < 0.05
    r = BitGridRenderer(portbg.bitgrid_from_occupancy(occ), device="cpu")
    cams = [orbit_camera(16.0, yaw_deg=30.0 + 3 * k, resolution=(32, 24)) for k in range(16)]
    frames = r.render_delta_many(cams)
    baseline = r._delta_state[1]
    assert baseline.untyped_storage().nbytes() == 32 * 24 * 3 == 2304
    np.testing.assert_array_equal(baseline.numpy(), frames[-1])
    again = r.render_delta_many(cams[-1:] * 4)  # the baseline's pose: nothing to fetch
    assert r.last_stats["delta_fetched"] == 0
    np.testing.assert_array_equal(again[-1], frames[-1])


def test_soft_rows_layout_equals_flat():
    """SoftRenderer(flat_params=False): the same loss and gradients as the
    flat layout, in the row shape; a mismatched layout raises."""
    occ = np.random.default_rng(6).random((16, 16, 16)) < 0.08
    bg = portbg.bitgrid_from_occupancy(occ, palette=np.random.default_rng(2).random((4, 4)))
    flat = SoftRenderer(bg, max_hits=3, device="cpu")
    rows = SoftRenderer(bg, max_hits=3, flat_params=False, device="cpu")
    o, d = device_rays(orbit_camera(16.0, resolution=(24, 20)), "cpu")
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    _c, voxels, _ = flat.trace_hits(o, d)
    target = torch.from_numpy(np.random.default_rng(1).random((o.shape[0], 3)).astype(np.float32))
    pf, pr = flat.init_params(), rows.init_params()
    assert pr["albedo"].shape == (16**3, 3)
    lf, gf = flat.grad_on_hits(pf, None, voxels, target)
    lr, gr = rows.grad_on_hits(pr, None, voxels, target)
    assert float(lf) == float(lr) and float(lf) > 0
    assert gr["albedo"].shape == (16**3, 3)
    assert torch.equal(gr["albedo"].reshape(-1), gf["albedo"])
    assert torch.equal(gr["logits"], gf["logits"])
    with pytest.raises(ValueError, match="expects ndim 2"):
        rows.composite(pf, voxels)
    with pytest.raises(ValueError, match="expects ndim 1"):
        flat.composite(pr, voxels)
