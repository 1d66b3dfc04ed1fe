"""Bencode ("bytecode") serialization of BoxTree scenes, the port's copy of
the reference's ``voxelhex_tpu/io/bencode.py``: VoxelHex's save format,
byte for byte, so a tree saved by either package loads in the other.

Wire layout (bencode: ``i<n>e`` ints, ``<len>:<bytes>`` strings, ``l...e``
lists):

* BoxTree = ``l`` Version auto_simplify boxtree_size brick_dim ObjectPool
  color_palette data_palette MIPMapStrategy ``e``
* Version = ``l`` major minor patch ``e``
* ObjectPool = ``l`` capacity NodeData... "#" ``e``: only live slots, in
  index order; the decoder keys them in sequence, so saving compacts the
  pool (child keys remapped to the packed order; the same bytes when the
  pool has no holes)
* NodeData = ``l`` content children mip occupied_bits occlusion_bits ``e``
* NodeContent: ``"#"`` Nothing | ``"##"`` Internal |
  ``l "###" brick*64 e`` Leaf | ``l "##u#" brick e`` UniformLeaf
* BrickData: ``"#b"`` Empty | ``l "#b#" voxel e`` Solid |
  ``l "##b#" len voxel*len "#" e`` Parted
* NodeChildren: ``"##x##"`` NoChildren | ``l "##c##" key*64 e``, an
  empty child 0xFFFFFFFF
* Albedo = ``l r g b a e``
* MIPMapStrategy = ``l`` enabled n (level method-code)*n m
  (level thr*1000)*m ``e``; method codes: BoxFilter 0, PointFilter 1,
  PointFilterBD 2, Posterize 3+thr*1000, PosterizeBD 1003+thr*1000

User data: plain ints encode as they are; other types go through the
optional ``data_encoder(obj) -> structure`` / ``data_decoder(structure) ->
obj`` hooks, where a structure is nested ints, bytes and lists.
"""

from __future__ import annotations

import os

import numpy as np

from voxelhex_tpu_torch.constants import BOX_NODE_CHILDREN_COUNT, EMPTY_U32
from voxelhex_tpu_torch.tree import mipmap as _mip
from voxelhex_tpu_torch.tree.boxtree import (
    EMPTY_KEY,
    INTERNAL,
    LEAF,
    NOTHING,
    UNIFORM,
    Albedo,
    BoxTree,
    _Node,
)

# Version written to files: the VoxelHex library version whose format this
# implements (Cargo.toml voxelhex v0.6.0).
LIBRARY_VERSION = (0, 6, 0)


def compatible(lib_version, tree_version) -> bool:
    """True when ``lib_version`` can load a tree saved by ``tree_version``
    (not commutative: equal major+minor,
    library patch >= tree patch)."""
    return (
        lib_version[0] == tree_version[0]
        and lib_version[1] == tree_version[1]
        and lib_version[2] >= tree_version[2]
    )


def bytes_until_version() -> int:
    """Prefix length guaranteed to contain the version header
    (2 * sizeof(Version))."""
    return 24


# ---------------------------------------------------------------------------
# bencode primitives (ints, byte strings, lists: all the format uses)
# ---------------------------------------------------------------------------


def _emit(out: bytearray, obj):
    """Append one bencode object: int, bytes/str, or list of objects."""
    if isinstance(obj, (int, np.integer)):
        out += b"i%de" % int(obj)
    elif isinstance(obj, (bytes, str)):
        b = obj.encode() if isinstance(obj, str) else obj
        out += b"%d:" % len(b)
        out += b
    elif isinstance(obj, (list, tuple)):
        out += b"l"
        for item in obj:
            _emit(out, item)
        out += b"e"
    else:
        raise TypeError(f"cannot bencode {type(obj).__name__}")


class _Decoder:
    """Pull-parser over a bencode byte stream (tolerates truncated input
    only through :func:`parse_version`'s prefix use)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def peek(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("truncated bencode stream")
        return self.data[self.pos]

    def parse(self):
        """Next object as nested python values: int | bytes | list."""
        c = self.peek()
        if c == ord("i"):
            end = self.data.index(b"e", self.pos)
            val = int(self.data[self.pos + 1 : end])
            self.pos = end + 1
            return val
        if c == ord("l"):
            self.pos += 1
            items = []
            while self.peek() != ord("e"):
                items.append(self.parse())
            self.pos += 1
            return items
        if ord("0") <= c <= ord("9"):
            colon = self.data.index(b":", self.pos)
            n = int(self.data[self.pos : colon])
            start = colon + 1
            self.pos = start + n
            if self.pos > len(self.data):
                raise ValueError("truncated bencode string")
            return self.data[start : self.pos]
        raise ValueError(f"unexpected bencode token {chr(c)!r} at {self.pos}")

    # streaming list access (the ObjectPool node stream can be large; parsing
    # it lazily avoids materializing one giant python list twice)
    def enter_list(self):
        if self.peek() != ord("l"):
            raise ValueError("expected bencode list")
        self.pos += 1

    def at_list_end(self) -> bool:
        return self.peek() == ord("e")

    def exit_list(self):
        if not self.at_list_end():
            raise ValueError("unconsumed items in bencode list")
        self.pos += 1

    def skip_to_list_end(self):
        while not self.at_list_end():
            self.parse()
        self.pos += 1


# ---------------------------------------------------------------------------
# encoding (BoxTree -> bytes)
# ---------------------------------------------------------------------------


def _brick_structure(brick):
    """BrickData encoding structure."""
    if brick is None:
        return "#b"
    if isinstance(brick, (int, np.integer)):
        return ["#b#", int(brick)]
    flat = np.asarray(brick, dtype=np.uint32).reshape(-1)
    return ["##b#", int(flat.size), *[int(v) for v in flat], "#"]


def _emit_node(out: bytearray, node: _Node, keymap):
    """NodeData: content, children, mip, bits."""
    if node.ntype == NOTHING:
        content = "#"
    elif node.ntype == INTERNAL:
        content = "##"
    elif node.ntype == LEAF:
        content = ["###", *[_brick_structure(b) for b in node.bricks]]
    elif node.ntype == UNIFORM:
        content = ["##u#", _brick_structure(node.bricks)]
    else:  # pragma: no cover - invariant
        raise ValueError(f"unknown node type {node.ntype}")

    if node.children is None:
        children = "##x##"
    else:
        children = [
            "##c##",
            *[
                EMPTY_U32 if c == EMPTY_KEY else keymap[c]
                for c in node.children
            ],
        ]

    _emit(
        out,
        [content, children, _brick_structure(node.mip), int(node.occupied), int(node.occlusion)],
    )


def _strategy_structure(strategy):
    """MIPMapStrategy encoding."""
    if strategy is None:
        strategy = _mip.MIPStrategy(enabled=False)

    method_code = {
        _mip.BOX_FILTER: lambda thr: 0,
        _mip.POINT_FILTER: lambda thr: 1,
        _mip.POINT_FILTER_BD: lambda thr: 2,
        _mip.POSTERIZE: lambda thr: 3 + int(round((thr or 0.0) * 1000.0)),
        _mip.POSTERIZE_BD: lambda thr: 1003 + int(round((thr or 0.0) * 1000.0)),
    }
    body = [int(strategy.enabled), len(strategy.methods)]
    for level in sorted(strategy.methods):
        method, thr = strategy.methods[level]
        body += [int(level), method_code[method](thr)]
    body.append(len(strategy.color_matching_thresholds))
    for level in sorted(strategy.color_matching_thresholds):
        thr = strategy.color_matching_thresholds[level]
        body += [int(level), int(thr * 1000.0)]
    return body


def to_bytes(tree: BoxTree, data_encoder=None) -> bytes:
    """Serialize a tree in VoxelHex's byte format."""
    # compact pool keys: the stream stores only live slots, in index order,
    # and the loader re-keys them in sequence
    keymap = {}
    live = []
    for old, node in enumerate(tree._nodes):
        if node is not None:
            keymap[old] = len(live)
            live.append(node)

    out = bytearray(b"l")
    _emit(out, list(LIBRARY_VERSION))
    _emit(out, int(tree.auto_simplify))
    _emit(out, tree.size)
    _emit(out, tree.brick_dim)

    # ObjectPool: capacity, live items, "#" terminator.  capacity is a bound
    # VoxelHex's decoder breaks on at >=, so leave one slot of headroom.
    out += b"l"
    _emit(out, len(live) + 1)
    for node in live:
        _emit_node(out, node, keymap)
    _emit(out, "#")
    out += b"e"

    _emit(out, [[a.r, a.g, a.b, a.a] for a in tree.color_palette])

    out += b"l"
    for data in tree.data_palette:
        _emit(out, data_encoder(data) if data_encoder else data)
    out += b"e"

    _emit(out, _strategy_structure(tree.mip_strategy))
    out += b"e"
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding (bytes -> BoxTree)
# ---------------------------------------------------------------------------


def _brick_from_structure(obj):
    if isinstance(obj, bytes):
        if obj != b"#b":
            raise ValueError(f"unknown BrickData marker {obj!r}")
        return None
    marker = obj[0]
    if marker == b"#b#":
        return int(obj[1])
    if marker == b"##b#":
        n = int(obj[1])
        return np.asarray(obj[2 : 2 + n], dtype=np.uint32)
    raise ValueError(f"unknown BrickData marker {marker!r}")


def _node_from_structure(obj) -> _Node:
    content, children, mip, occupied, occlusion = obj[:5]
    node = _Node()
    if isinstance(content, bytes):
        node.ntype = {b"#": NOTHING, b"##": INTERNAL}[content]
    elif content[0] == b"###":
        node.ntype = LEAF
        node.bricks = [_brick_from_structure(b) for b in content[1:65]]
    elif content[0] == b"##u#":
        node.ntype = UNIFORM
        node.bricks = _brick_from_structure(content[1])
    else:
        raise ValueError(f"unknown NodeContent marker {content[0]!r}")

    if isinstance(children, list) and children[:1] == [b"##c##"]:
        node.children = [
            EMPTY_KEY if c == EMPTY_U32 else int(c)
            for c in children[1 : 1 + BOX_NODE_CHILDREN_COUNT]
        ]
    # bytes b"##x##" -> NoChildren -> None (the default)

    node.mip = _brick_from_structure(mip)
    node.occupied = int(occupied)
    node.occlusion = int(occlusion)
    return node


def _strategy_from_structure(obj):
    it = iter(obj)
    enabled = bool(next(it))
    methods = {}
    for _ in range(int(next(it))):
        level = int(next(it))
        code = int(next(it))
        if code == 0:
            methods[level] = (_mip.BOX_FILTER, None)
        elif code == 1:
            methods[level] = (_mip.POINT_FILTER, None)
        elif code == 2:
            methods[level] = (_mip.POINT_FILTER_BD, None)
        elif 3 <= code < 1002:
            methods[level] = (_mip.POSTERIZE, (code - 3) / 1000.0)
        elif 1003 <= code < 2001:
            methods[level] = (_mip.POSTERIZE_BD, (code - 1003) / 1000.0)
        else:
            raise ValueError(f"unknown MIP resampling code {code}")
    thresholds = {}
    for _ in range(int(next(it))):
        level = int(next(it))
        thresholds[level] = int(next(it)) / 1000.0
    return _mip.MIPStrategy(
        enabled=enabled, methods=methods, color_matching_thresholds=thresholds
    )


def from_bytes(data: bytes, data_decoder=None) -> BoxTree:
    """Load a tree from bytes in VoxelHex's format."""
    dec = _Decoder(data)
    dec.enter_list()

    version = tuple(dec.parse())
    if not compatible(LIBRARY_VERSION, version):
        raise ValueError(
            f"incompatible tree version {version} (library {LIBRARY_VERSION})"
        )

    auto_simplify = bool(dec.parse())
    size = int(dec.parse())
    brick_dim = int(dec.parse())

    # ObjectPool: stream NodeData until the "#" terminator
    dec.enter_list()
    dec.parse()  # capacity (a Vec reservation hint; re-derived from count)
    nodes = []
    while True:
        obj = dec.parse()
        if isinstance(obj, bytes) and obj == b"#":
            break
        nodes.append(_node_from_structure(obj))
    dec.skip_to_list_end()

    palette = [Albedo(*[int(c) for c in row]) for row in dec.parse()]
    raw_data = dec.parse()
    data_palette = [
        data_decoder(entry) if data_decoder else int(entry) for entry in raw_data
    ]
    strategy = _strategy_from_structure(dec.parse())
    dec.skip_to_list_end()

    tree = BoxTree(size, brick_dim=brick_dim, auto_simplify=auto_simplify)
    tree._nodes = nodes if nodes else [_Node()]
    tree._free = []
    tree.color_palette = palette
    tree._color_map = {a: i for i, a in enumerate(palette)}
    tree.data_palette = data_palette
    try:
        tree._data_map = {d: i for i, d in enumerate(data_palette)}
    except TypeError:  # unhashable custom data: rebuilt lazily on next intern
        tree._data_map = {}
    tree.mip_strategy = strategy if strategy.enabled else None
    return tree


def parse_version(data: bytes):
    """Version triple from a (possibly truncated) prefix of a saved tree
    (pair with :func:`bytes_until_version`)."""
    dec = _Decoder(data)
    dec.enter_list()
    version = dec.parse()
    if not (isinstance(version, list) and len(version) == 3):
        raise ValueError("malformed version header")
    return tuple(int(v) for v in version)


def save(tree: BoxTree, path: str | os.PathLike, data_encoder=None) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(tree, data_encoder=data_encoder))


def load(path: str | os.PathLike, data_decoder=None) -> BoxTree:
    with open(path, "rb") as f:
        return from_bytes(f.read(), data_decoder=data_decoder)
