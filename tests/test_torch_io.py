"""The port's scene I/O against the reference's: ``.vox`` files built here
in code (two models, transforms with rotation and translation, a group, an
RGBA palette) parse, load and build into the same trees, corrupt files raise
the same errors, and bencode bytes are the reference's, byte for byte, in
both directions."""

import struct

import numpy as np
import pytest
from test_torch_tree import apply, assert_flat_equal, random_ops

from voxelhex_tpu.io import bencode as ref_bencode
from voxelhex_tpu.io import vox as ref_vox
from voxelhex_tpu.tree import boxtree as ref_bt
from voxelhex_tpu.tree import mipmap as ref_mip
from voxelhex_tpu_torch.io import bencode, vox
from voxelhex_tpu_torch.tree import boxtree as bt
from voxelhex_tpu_torch.tree import mipmap as mip


def chunk(cid: bytes, content: bytes, children: bytes = b"") -> bytes:
    return cid + struct.pack("<ii", len(content), len(children)) + content + children


def vdict(d: dict) -> bytes:
    out = struct.pack("<i", len(d))
    for k, v in d.items():
        out += struct.pack("<i", len(k)) + k.encode() + struct.pack("<i", len(v)) + v.encode()
    return out


def model(size, voxels):
    xyzi = struct.pack("<i", len(voxels)) + bytes(np.asarray(voxels, np.uint8).ravel())
    return chunk(b"SIZE", struct.pack("<3i", *size)) + chunk(b"XYZI", xyzi)


def vox_bytes(rotation=41, with_scene=True, with_rgba=True):
    """Two models; root transform -> group -> (rotated, translated model 0;
    translated model 1)."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(0, 6, (40, 3)), rng.integers(1, 9, (40, 1))], axis=1)
    b = np.concatenate([rng.integers(0, 4, (30, 3)), rng.integers(9, 20, (30, 1))], axis=1)
    body = model((6, 6, 6), a) + model((4, 4, 4), b)
    if with_scene:
        def trn(node, child, frame):
            return chunk(b"nTRN", struct.pack("<i", node) + vdict({}) +
                         struct.pack("<4i", child, -1, 0, 1) + vdict(frame))

        def shp(node, model_id):
            return chunk(b"nSHP", struct.pack("<i", node) + vdict({}) +
                         struct.pack("<ii", 1, model_id) + vdict({}))

        body += trn(0, 1, {})
        body += chunk(b"nGRP", struct.pack("<i", 1) + vdict({}) + struct.pack("<3i", 2, 2, 4))
        body += trn(2, 3, {"_t": "5 -3 2", "_r": str(rotation)}) + shp(3, 0)
        body += trn(4, 5, {"_t": "-4 6 1"}) + shp(5, 1)
    if with_rgba:
        pal = (np.arange(1024) * 7 % 256).astype(np.uint8).reshape(256, 4)
        pal[:, 3] = 255
        body += chunk(b"RGBA", bytes(pal.ravel()))
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", body)


@pytest.mark.parametrize("kind", ["scene", "no scene", "default palette", "other rotation"])
def test_vox_equals_reference(tmp_path, kind):
    kw = {"scene": {}, "no scene": {"with_scene": False},
          "default palette": {"with_rgba": False}, "other rotation": {"rotation": 4 | 16}}[kind]
    path = tmp_path / "m.vox"
    path.write_bytes(vox_bytes(**kw))
    a, b = ref_vox.parse_vox(str(path)), vox.parse_vox(str(path))
    assert len(a.models) == len(b.models) == 2
    for m, n in zip(a.models, b.models):
        np.testing.assert_array_equal(m.size, n.size)
        np.testing.assert_array_equal(m.voxels, n.voxels)
    np.testing.assert_array_equal(a.palette, b.palette)
    assert sorted(a.scene) == sorted(b.scene)
    for k in a.scene:
        assert type(a.scene[k]).__name__ == type(b.scene[k]).__name__
        assert vars(a.scene[k]) == vars(b.scene[k])
    for ra, rb in zip(ref_vox.load_vox_scene(str(path)), vox.load_vox_scene(str(path))):
        np.testing.assert_array_equal(ra, rb)
    for d in (4, 32):
        assert_flat_equal(ref_vox.load_vox_tree(str(path), brick_dim=d),
                          vox.load_vox_tree(str(path), brick_dim=d))
    strategies = [m.MIPStrategy(enabled=True) for m in (ref_mip, mip)]
    assert_flat_equal(ref_vox.load_vox_tree(str(path), brick_dim=2, mip_strategy=strategies[0]),
                      vox.load_vox_tree(str(path), brick_dim=2, mip_strategy=strategies[1]))
    for b_ in range(128):
        if len({b_ & 3, (b_ >> 2) & 3, 3}) == 3:  # two distinct axes of 0..2
            np.testing.assert_array_equal(vox.parse_rotation_byte(b_),
                                          ref_vox.parse_rotation_byte(b_))
    for extent, d in ((1, 4), (16, 4), (17, 4), (100, 32), (513, 32)):
        assert vox.tree_size_for(extent, d) == ref_vox.tree_size_for(extent, d)


def corrupt_files():
    good = vox_bytes()
    xyzi = good.index(b"XYZI")
    claims_more = bytearray(good)
    claims_more[xyzi + 12:xyzi + 16] = struct.pack("<i", 10_000)
    no_main = b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"")[:0] + chunk(b"MAIX", b"")
    return {"not vox": b"PNG " + good[4:], "truncated": good[:len(good) // 2],
            "short header": good[:10], "xyzi claims more": bytes(claims_more),
            "no main": no_main,
            "xyzi before size": b"VOX " + struct.pack("<i", 150) + chunk(
                b"MAIN", b"", chunk(b"XYZI", struct.pack("<i", 0)))}


@pytest.mark.parametrize("name", sorted(corrupt_files()))
def test_corrupt_vox_raises_as_the_reference(tmp_path, name):
    path = tmp_path / "bad.vox"
    path.write_bytes(corrupt_files()[name])
    with pytest.raises(Exception) as want:
        ref_vox.parse_vox(str(path))
    with pytest.raises(Exception) as got:
        vox.parse_vox(str(path))
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def edited_trees(d, seed, mips):
    ref, port = ref_bt.BoxTree(16 * d, d), bt.BoxTree(16 * d, d)
    if mips:
        ref_mip.enable_mips(ref)
        mip.enable_mips(port)
    for op in random_ops(np.random.default_rng(seed), 16 * d, d, 25):
        apply(ref, ref_bt, op)
        apply(port, bt, op)
    return ref, port


@pytest.mark.parametrize("d,mips", [(1, False), (2, True), (4, False), (4, True), (8, False)])
def test_bencode_bytes_equal_reference(tmp_path, d, mips):
    ref, port = edited_trees(d, 11 * d, mips)
    data = ref_bencode.to_bytes(ref)
    assert bencode.to_bytes(port) == data
    back = bencode.from_bytes(data)
    assert_flat_equal(ref, back)
    assert bencode.to_bytes(back) == ref_bencode.to_bytes(ref_bencode.from_bytes(data))
    assert (back.mip_strategy is None) == (not mips)
    # and the other way, through files
    bencode.save(port, tmp_path / "t.bencode")
    assert_flat_equal(ref_bencode.load(tmp_path / "t.bencode"), port)
    assert_flat_equal(ref, bencode.load(tmp_path / "t.bencode"))
    assert bencode.parse_version(data[:bencode.bytes_until_version()]) == \
        ref_bencode.parse_version(data[:ref_bencode.bytes_until_version()])


def test_bencode_user_data_and_errors():
    ref, port = ref_bt.BoxTree(16, 4), bt.BoxTree(16, 4)
    for tree, m in ((ref, ref_bt), (port, bt)):
        tree.insert((1, 1, 1), m.Entry(data="a"))
        tree.insert((2, 1, 1), m.Entry(albedo=m.Albedo(1, 2, 3, 255), data="b"))
    enc = (lambda s: s.encode())
    data = ref_bencode.to_bytes(ref, data_encoder=enc)
    assert bencode.to_bytes(port, data_encoder=enc) == data
    back = bencode.from_bytes(data, data_decoder=lambda b: b.decode())
    assert back.data_palette == ["a", "b"]
    assert_flat_equal(ref, back)
    for m in (ref_bencode, bencode):
        assert m.compatible((0, 6, 1), (0, 6, 0)) and not m.compatible((0, 6, 0), (0, 6, 1))
    newer = data.replace(b"li0ei6ei0ee", b"li0ei7ei0ee", 1)
    for bad in (newer, data[:40], b"x" + data):
        with pytest.raises(ValueError) as want:
            ref_bencode.from_bytes(bad)
        with pytest.raises(ValueError) as got:
            bencode.from_bytes(bad)
        assert str(got.value) == str(want.value)
