"""The offline trainers (plain versions, on the CPU) against the
reference's: ``fit_albedo`` on the small scene of
``tests/test_diff_and_parallel.py``, ``fit_soft`` on the scene of
``tests/test_soft_diff.py``'s resume test, ``with_candidates`` and
``params_to_tree``.

Tolerances are those of ``tests/test_torch_soft_step.py``: losses to a
relative 1e-6, params to 5e-6 (Adam's step is nearly sign-like, so a
gradient an ulp away moves a param by up to an ulp of the step).  Inside
the port the results are bit-equal: ``chain`` only sets where the host
waits, a resumed fit is the uninterrupted one, and the row layout is the
flat one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tree import assert_flat_equal

from voxelhex_tpu.diff import fit as ref_fit
from voxelhex_tpu.diff import render as ref_render
from voxelhex_tpu.diff import soft as ref_soft
from voxelhex_tpu.render.camera import orbit_camera as ref_orbit
from voxelhex_tpu.tree import boxtree as ref_bt
from voxelhex_tpu.tree.flat import flatten as ref_flatten
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.diff import fit, render, soft
from voxelhex_tpu_torch.render import bitgrid as portbg
from voxelhex_tpu_torch.render import fastest_renderer
from voxelhex_tpu_torch.render.camera import orbit_camera
from voxelhex_tpu_torch.tree import flat as port_flat

RED = ref_bt.Albedo.from_u32(0xFF0000FF)
GREEN = ref_bt.Albedo.from_u32(0x00FF00FF)
FLAT_FIELDS = ("node_meta", "node_children", "node_ocbits", "node_mips", "bricks", "palette",
               "brick_ocbits")


def _port_flat(ref_flat):
    return convert.from_jax_flat_tree({"size": ref_flat.size, "brick_dim": ref_flat.brick_dim,
                                       **{k: getattr(ref_flat, k) for k in FLAT_FIELDS}})


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=5e-6)


# ---------------------------------------------------------------------------
# fit_albedo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def albedo_case():
    """Both renderers of the small scene, rays of two poses, the target
    rendered with the true albedo, a gray start."""
    tree = ref_bt.BoxTree(16, 4, auto_simplify=False)
    rng = np.random.default_rng(13)
    for _ in range(60):
        p = tuple(int(v) for v in rng.integers(0, 16, 3))
        tree.insert(p, RED if rng.random() < 0.5 else GREEN)
    tree.insert_at_lod((4, 4, 4), 4, GREEN)
    ref_flat = ref_flatten(tree)
    ref = ref_render.DiffRenderer(ref_flat)
    port = render.DiffRenderer(_port_flat(ref_flat), device="cpu")
    o, d = zip(*(ref_orbit(16.0, yaw_deg=y, resolution=(32, 24)).rays() for y in (40, 220)))
    o, d = np.concatenate(o).reshape(-1, 3), np.concatenate(d).reshape(-1, 3)
    target = np.asarray(jax.jit(ref.render)(ref.init_params(), o, d))
    gray = np.full(np.asarray(ref.init_params()).shape, 0.5, np.float32)
    return ref, port, o, d, target, gray


@pytest.mark.parametrize("precompute_hits", [True, False])
def test_fit_albedo_equals_reference(albedo_case, precompute_hits):
    ref, port, o, d, target, gray = albedo_case
    kw = dict(steps=6, lr=0.1, precompute_hits=precompute_hits)
    p_r, l_r = ref_fit.fit_albedo(ref, o, d, target, params0=jnp.asarray(gray), chain=4, **kw)
    p1, l1 = fit.fit_albedo(port, o, d, target, params0=torch.from_numpy(gray), chain=1, **kw)
    p4, l4 = fit.fit_albedo(port, o, d, target, params0=gray, chain=4, **kw)
    assert l1 == l4 and torch.equal(p1, p4)  # chain sets only where the host waits
    assert len(l4) == len(l_r) == 6 and l4[-1] < l4[0]
    np.testing.assert_allclose(l4, l_r, rtol=1e-6)
    _close(p4.numpy(), p_r)
    assert float(p4.min()) >= 0.0 and float(p4.max()) <= 1.0


def test_fit_albedo_resumes(albedo_case, tmp_path):
    """Resumed from the port's own checkpoint: bit-equal to the
    uninterrupted fit; from the reference's: within the tolerance."""
    ref, port, o, d, target, gray = albedo_case
    kw = dict(lr=0.1, chain=4)
    full, l_full = fit.fit_albedo(port, o, d, target, steps=7, params0=gray,
                                  checkpoint_path=str(tmp_path / "a.ckpt"), checkpoint_every=3,
                                  **kw)
    part = str(tmp_path / "b.ckpt")
    fit.fit_albedo(port, o, d, target, steps=3, params0=gray, checkpoint_path=part,
                   checkpoint_every=3, **kw)
    resumed, l_res = fit.fit_albedo(port, o, d, target, steps=7, checkpoint_path=part, **kw)
    assert l_res == l_full[3:] and torch.equal(resumed, full)
    # a complete checkpoint: nothing left to run
    again, l_again = fit.fit_albedo(port, o, d, target, steps=7, checkpoint_path=part, **kw)
    assert l_again == [] and torch.equal(again, full)

    ref_part = str(tmp_path / "ref.ckpt")
    ref_fit.fit_albedo(ref, o, d, target, steps=3, params0=jnp.asarray(gray),
                       checkpoint_path=ref_part, checkpoint_every=3, **kw)
    p_r, l_r = ref_fit.fit_albedo(ref, o, d, target, steps=7, params0=jnp.asarray(gray), **kw)
    from_ref, l_from_ref = fit.fit_albedo(port, o, d, target, steps=7, checkpoint_path=ref_part,
                                          **kw)
    np.testing.assert_allclose(l_from_ref, l_r[3:], rtol=1e-6)
    _close(from_ref.numpy(), p_r)


# ---------------------------------------------------------------------------
# fit_soft, with_candidates, params_to_tree
# ---------------------------------------------------------------------------


def _soft_scene():
    """The scene and rays of the reference's fit_soft resume test: a green
    wall with a red voxel in front, 64 parallel rays."""
    tree = ref_bt.BoxTree(16, 4, auto_simplify=False)
    for x in range(3, 9):
        for y in range(3, 9):
            tree.insert((x, y, 10), GREEN)
    tree.insert((5, 5, 4), RED)
    xs, ys = np.meshgrid(np.linspace(3.2, 8.8, 8), np.linspace(3.2, 8.8, 8))
    origins = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -3.0)], axis=1).astype(
        np.float32)
    dirs = np.tile(np.array([[0, 0, 1.0]], dtype=np.float32), (xs.size, 1))
    targets = np.tile(np.array([[0.0, 0.8, 0.0]], dtype=np.float32), (xs.size, 1))
    return tree, origins, dirs, targets


@pytest.fixture(scope="module")
def soft_case():
    tree, o, d, t = _soft_scene()
    flat = ref_flatten(tree)
    ref = ref_soft.SoftRenderer(flat, max_hits=3)
    port = soft.SoftRenderer(_port_flat(flat), max_hits=3, device="cpu")
    return ref, port, o, d, t


@pytest.mark.parametrize("fit_albedo,opacity_l1", [(True, 0.0), (False, 0.1)])
def test_fit_soft_equals_reference(soft_case, fit_albedo, opacity_l1):
    ref, port, o, d, t = soft_case
    kw = dict(steps=6, lr=0.1, fit_albedo=fit_albedo, opacity_l1=opacity_l1)
    p_r, l_r = ref_soft.fit_soft(ref, o, d, t, chain=4, **kw)
    p1, l1 = soft.fit_soft(port, o, d, t, chain=1, **kw)
    p4, l4 = soft.fit_soft(port, o, d, t, chain=4, **kw)
    assert l1 == l4 and all(torch.equal(p1[k], p4[k]) for k in p1)
    assert len(l4) == 6 and l4[-1] < l4[0]
    np.testing.assert_allclose(l4, l_r, rtol=1e-6)
    for k in ("albedo", "logits"):
        _close(p4[k].numpy(), p_r[k])


def test_fit_soft_resumes_and_rows_equal_flat(soft_case, tmp_path):
    ref, port, o, d, t = soft_case
    kw = dict(lr=0.1, chain=4)
    full, l_full = soft.fit_soft(port, o, d, t, steps=12, **kw)
    part = str(tmp_path / "p.ckpt")
    soft.fit_soft(port, o, d, t, steps=6, checkpoint_path=part, checkpoint_every=3, **kw)
    resumed, l_res = soft.fit_soft(port, o, d, t, steps=12, checkpoint_path=part, **kw)
    assert l_res == l_full[6:] and all(torch.equal(resumed[k], full[k]) for k in full)

    ref_part = str(tmp_path / "r.ckpt")
    ref_soft.fit_soft(ref, o, d, t, steps=6, checkpoint_path=ref_part, checkpoint_every=3,
                      **kw)
    p_r, l_r = ref_soft.fit_soft(ref, o, d, t, steps=12, **kw)
    from_ref, l_from_ref = soft.fit_soft(port, o, d, t, steps=12, checkpoint_path=ref_part,
                                         **kw)
    np.testing.assert_allclose(l_from_ref, l_r[6:], rtol=1e-6)
    for k in ("albedo", "logits"):
        _close(from_ref[k].numpy(), p_r[k])

    rows = soft.SoftRenderer(port.bitgrid, max_hits=3, flat_params=False, device="cpu")
    p_rows, l_rows = soft.fit_soft(rows, o, d, t, steps=12, **kw)
    assert l_rows == l_full and p_rows["albedo"].shape == (16**3, 3)
    assert torch.equal(p_rows["albedo"].reshape(-1), full["albedo"])
    assert torch.equal(p_rows["logits"], full["logits"])


def test_with_candidates_equals_reference():
    tree, o, d, t = _soft_scene()
    flat = ref_flatten(tree)
    r_ren, r_params, r_cand = ref_soft.with_candidates(flat, radius=1, max_hits=6)
    p_ren, p_params, p_cand = soft.with_candidates(_port_flat(flat), radius=1, max_hits=6,
                                                   device="cpu")
    for k in ("size", "n_levels", "level_bases", "occ_lo", "occ_hi", "colors", "palette"):
        np.testing.assert_array_equal(getattr(r_ren.bitgrid, k), getattr(p_ren.bitgrid, k),
                                      err_msg=k)
    np.testing.assert_array_equal(r_cand, p_cand)
    assert p_cand.sum() > 100 and p_ren.max_hits == 6
    for k in ("albedo", "logits"):
        np.testing.assert_array_equal(np.asarray(r_params[k]), p_params[k].numpy())
    # the dilated march records the shell: a fit on it matches the reference's
    p_fit, l_p = soft.fit_soft(p_ren, o, d, t, steps=3, lr=0.1, params0=p_params)
    r_fit, l_r = ref_soft.fit_soft(r_ren, o, d, t, steps=3, lr=0.1, params0=r_params)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-6)
    for k in ("albedo", "logits"):
        _close(p_fit[k].numpy(), r_fit[k])


def test_params_to_tree_equals_reference():
    """The bake of the same params is the reference's tree, field for field;
    the identity bake of ``init_params()`` renders as the source scene."""
    tree, _o, _d, _t = _soft_scene()
    flat = ref_flatten(tree)
    ref = ref_soft.SoftRenderer(flat, max_hits=3)
    port = soft.SoftRenderer(_port_flat(flat), max_hits=3, device="cpu")
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) for k, v in ref.init_params().items()}
    params["logits"] = params["logits"] + rng.normal(0, 4, params["logits"].shape).astype(
        np.float32)  # some voxels carved, some grown
    params["albedo"] = rng.random(params["albedo"].shape).astype(np.float32)
    baked_r = ref_soft.params_to_tree(ref, {k: jnp.asarray(v) for k, v in params.items()})
    baked_p = soft.params_to_tree(port, convert.from_jax_soft_params(params, "cpu"))
    assert_flat_equal(baked_r, baked_p)
    ident = soft.params_to_tree(port, port.init_params())
    assert_flat_equal(ref_soft.params_to_tree(ref, ref.init_params()), ident)
    cam = orbit_camera(16.0, resolution=(48, 32))
    src = fastest_renderer(port.bitgrid, device="cpu").render(cam, out_u8=True)
    np.testing.assert_array_equal(fastest_renderer(ident, device="cpu").render(cam, out_u8=True),
                                  src)
    assert (src != 0).any()
    assert port_flat.flatten(ident).n_bricks > 0
    assert portbg.build_bitgrid(ident).size == 16
