"""The port's checkpoints against the reference's: tree, flat and
train-state files written by either package load in the other with equal
contents (the two write the same meta and arrays), ``peek_version`` reads
the header, and a wrong version, kind, leaf count or shape raises.
``load_vox_tree_cached`` runs on ``.vox`` files built in code.  Exact: the
formats hold integers and f32 arrays as they are."""

import json
import os
import zipfile

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_io import vox_bytes
from test_torch_tree import apply, assert_flat_equal, random_ops

from voxelhex_tpu.io import checkpoint as ref_ck
from voxelhex_tpu.io import vox as ref_vox
from voxelhex_tpu.tree import boxtree as ref_bt
from voxelhex_tpu.tree import flat as ref_flat
from voxelhex_tpu.tree import mipmap as ref_mip
from voxelhex_tpu.tree.build import from_voxels as ref_from_voxels
from voxelhex_tpu_torch import convert
from voxelhex_tpu_torch.diff.optim import adam
from voxelhex_tpu_torch.io import checkpoint as ck
from voxelhex_tpu_torch.io import vox
from voxelhex_tpu_torch.tree import boxtree as bt
from voxelhex_tpu_torch.tree import flat as port_flat
from voxelhex_tpu_torch.tree import mipmap as mip
from voxelhex_tpu_torch.tree.build import from_voxels


def _trees(seed=3, mips=True):
    """The same tree in both packages: a bulk build, edits (data entries
    included) and, with ``mips``, a MIP strategy."""
    rng = np.random.default_rng(seed)
    size, d = 32, 2
    pts = rng.integers(0, size, (300, 3))
    cols = (rng.integers(1, 5, (300, 4)) * 50).astype(np.uint8)
    cols[:, 3] = 255
    ref = ref_from_voxels(pts, cols, size=size, brick_dim=d)
    port = from_voxels(pts, cols, size=size, brick_dim=d)
    ops = random_ops(rng, size, d, 12) + [("data", (1, 2, 3), 1, 7), ("data", (9, 9, 9), 1, "x")]
    for op in ops:
        apply(ref, ref_bt, op)
        apply(port, bt, op)
    if mips:
        ref_mip.enable_mips(ref, ref_mip.MIPStrategy(enabled=True).set_similarity(1, 0.05))
        mip.enable_mips(port, mip.MIPStrategy(enabled=True).set_similarity(1, 0.05))
    assert_flat_equal(ref, port)
    return ref, port


def _contents(path):
    with zipfile.ZipFile(path) as zf:
        names = sorted(zf.namelist())
        return {n: zf.read(n) for n in names}


@pytest.mark.parametrize("mips", [True, False])
def test_tree_checkpoints_cross_packages(tmp_path, mips):
    ref, port = _trees(mips=mips)
    a, b = str(tmp_path / "ref.vhx"), str(tmp_path / "port.vhx")
    ref_ck.save_tree(a, ref)
    ck.save_tree(b, port)
    assert _contents(a) == _contents(b)  # the same meta and the same .npy bytes
    assert_flat_equal(ref, ck.load_tree(a))
    assert_flat_equal(ref_ck.load_tree(b), port)
    loaded = ck.load_tree(a)
    assert loaded.data_palette == port.data_palette and len(loaded.data_palette) > 0
    assert (loaded.mip_strategy is None) == (not mips)
    if mips:
        assert loaded.mip_strategy.color_matching_thresholds == \
            port.mip_strategy.color_matching_thresholds
        assert loaded.mip_strategy.methods == port.mip_strategy.methods
    # the loaded tree edits as the original does
    for op in random_ops(np.random.default_rng(9), 32, 2, 6):
        apply(loaded, bt, op)
        apply(ref, ref_bt, op)
    assert_flat_equal(ref, loaded)


def test_flat_checkpoints_cross_packages(tmp_path):
    ref, port = _trees()
    rf, pf = ref_flat.flatten(ref), port_flat.flatten(port)
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_ck.save_flat(a, rf)
    ck.save_flat(b, pf)
    assert _contents(a) == _contents(b)
    fields = ("node_meta", "node_children", "node_ocbits", "node_mips", "bricks", "palette")
    for got, want in ((ck.load_flat(a), rf), (ref_ck.load_flat(b), pf)):
        assert (got.size, got.brick_dim) == (want.size, want.brick_dim)
        for k in fields:
            x = getattr(got, k)
            assert x.dtype == getattr(want, k).dtype, k
            np.testing.assert_array_equal(x, getattr(want, k), err_msg=k)


def _soft_state(rows=False):
    rng = np.random.default_rng(1)
    n = 40
    albedo = rng.random((n, 3) if rows else 3 * n).astype(np.float32)
    params = {"albedo": albedo, "logits": rng.normal(0, 3, n).astype(np.float32)}
    opt = optax.adam(0.05)
    p = {k: jax.numpy.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    grads = {k: jax.numpy.asarray(rng.normal(0, 1e-2, v.shape).astype(np.float32))
             for k, v in params.items()}
    for _ in range(3):  # non-trivial moments and count
        updates, state = opt.update(grads, state)
        p = optax.apply_updates(p, updates)
    return p, state


@pytest.mark.parametrize("kind", ["soft flat", "soft rows", "single array"])
def test_train_state_cross_packages(tmp_path, kind):
    """The reference's params and optax state, and the port's (carried
    across by convert.py), written by each package, load in the other into
    its own templates: the leaves come back equal, in optax's order."""
    if kind == "single array":
        rng = np.random.default_rng(2)
        x = jax.numpy.asarray(rng.random((6, 8, 3)).astype(np.float32))
        opt = optax.adam(0.1)
        state = opt.init(x)
        updates, state = opt.update(x * 1e-2, state)
        p_r = optax.apply_updates(x, updates)
        s_r = state
        p_p = convert.from_jax_albedo(np.asarray(p_r), "cpu")
    else:
        p_r, s_r = _soft_state(rows=kind == "soft rows")
        p_p = convert.from_jax_soft_params({k: np.asarray(v) for k, v in p_r.items()}, "cpu")
    leaves_r = [np.asarray(v) for v in jax.tree.leaves(s_r)]
    s_p = convert.from_jax_adam_state(leaves_r, "cpu")
    a, b = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    ref_ck.save_train_state(a, 3, p_r, s_r)
    ck.save_train_state(b, 3, p_p, s_p)
    assert _contents(a) == _contents(b)

    # the reference's file into the port's templates (zeros of the same shapes)
    tpl = adam(0.05).init(p_p)
    zeros = (torch.zeros_like(p_p) if torch.is_tensor(p_p)
             else {k: torch.zeros_like(v) for k, v in p_p.items()})
    step, p, s = ck.load_train_state(a, zeros, tpl)
    assert step == 3 and s["count"].dtype == torch.int32
    assert int(s["count"]) == int(leaves_r[0]) > 0
    got = [x.numpy() for x in ck._leaves(p)] + [x.numpy() for x in ck._leaves(s)]
    want = [np.asarray(v) for v in jax.tree.leaves(p_r)] + leaves_r
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    # the port's file into the reference's templates
    step, p2, s2 = ref_ck.load_train_state(b, p_r, s_r)
    assert step == 3
    for x, y in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((p_r, s_r))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_peek_version_and_rejections(tmp_path):
    _ref, port = _trees(mips=False)
    t, f, s = (str(tmp_path / n) for n in ("t.vhx", "f.npz", "s.ckpt"))
    ck.save_tree(t, port)
    ck.save_flat(f, port_flat.flatten(port))
    params = {"albedo": torch.zeros(6), "logits": torch.zeros(2)}
    state = adam(0.1).init(params)
    ck.save_train_state(s, 5, params, state)
    for path in (t, f, s):
        assert ck.peek_version(path) == ck.FORMAT_VERSION == ref_ck.FORMAT_VERSION
    # the wrong kind
    with pytest.raises(ValueError, match="not a tree checkpoint"):
        ck.load_tree(f)
    with pytest.raises(ValueError, match="not a flat checkpoint"):
        ck.load_flat(s)
    with pytest.raises(ValueError, match="not a train_state checkpoint"):
        ck.load_train_state(t, params, state)
    # the wrong shape, the wrong leaf count
    with pytest.raises(ValueError, match="shape"):
        ck.load_train_state(s, {"albedo": torch.zeros(9), "logits": torch.zeros(2)}, state)
    with pytest.raises(ValueError, match="leaves"):
        ck.load_train_state(s, params, {"count": state["count"], "mu": state["mu"]})
    # a major version of the future
    bad = str(tmp_path / "v2.vhx")
    with zipfile.ZipFile(t) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                meta = json.loads(data)
                meta["version"] = [2, 0]
                data = json.dumps(meta).encode()
            zout.writestr(name, data)
    assert ck.peek_version(bad) == (2, 0) and not ck.version_compatible((2, 0))
    assert ck.version_compatible((1, 7))
    for load in (ck.load_tree, ck.load_flat):
        with pytest.raises(ValueError, match="incompatible"):
            load(bad)


def test_load_vox_tree_cached(tmp_path, monkeypatch):
    """The first call parses the model and writes the cache; the second
    reads the cache (the model is garbage by then); a stale cache is parsed
    again and rewritten; the reference reads the port's cache; a directory
    that cannot be written gets no cache."""
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "m.vox").write_bytes(vox_bytes())
    path, ref_path = tmp_path / "port" / "m.vox", tmp_path / "ref" / "m.vox"
    cache = tmp_path / "port" / ".cache_m.vox_4.vhx"
    ref_tree = ref_vox.load_vox_tree_cached(str(ref_path), brick_dim=4)
    tree = vox.load_vox_tree_cached(str(path), brick_dim=4)
    assert cache.exists()
    assert_flat_equal(ref_tree, tree)
    assert _contents(cache) == _contents(tmp_path / "ref" / ".cache_m.vox_4.vhx")
    path.write_bytes(b"not a vox file")
    assert_flat_equal(ref_tree, vox.load_vox_tree_cached(str(path), brick_dim=4))
    assert_flat_equal(ref_tree, ref_vox.load_vox_tree_cached(str(path), brick_dim=4))
    # a stale cache: parsed again, and the cache rewritten
    path.write_bytes(vox_bytes())
    cache.write_bytes(b"stale")
    assert_flat_equal(ref_tree, vox.load_vox_tree_cached(str(path), brick_dim=4))
    assert ck.peek_version(str(cache)) == ck.FORMAT_VERSION
    # a directory that cannot be written: the save raises PermissionError
    def refuse(path, tree):
        raise PermissionError(13, "Permission denied", path)

    ro = tmp_path / "ro"
    ro.mkdir()
    (ro / "m.vox").write_bytes(vox_bytes())
    monkeypatch.setattr(ck, "save_tree", refuse)
    assert_flat_equal(ref_tree, vox.load_vox_tree_cached(str(ro / "m.vox"), brick_dim=4))
    assert os.listdir(ro) == ["m.vox"]
