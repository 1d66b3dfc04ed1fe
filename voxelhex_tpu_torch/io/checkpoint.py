"""Checkpoints: versioned save and load of scenes and training state, the
port's copy of the reference's ``voxelhex_tpu/io/checkpoint.py``.

A checkpoint is a zip of ``meta.json`` (``"format": "voxelhex_tpu"``, the
kind, the version and the scalars) and one ``.npy`` file an array, with the
reference's array names, so a file written by either package loads in the
other:

* ``save_flat`` / ``load_flat`` — the flat snapshot (render-ready);
* ``save_tree`` / ``load_tree`` — the editable host tree, palettes and MIP
  strategy included;
* ``save_train_state`` / ``load_train_state`` — a training step's params
  and Adam state, their leaves in optax's order;
* ``peek_version`` — the version alone.
"""

from __future__ import annotations

import ast
import io
import json
import zipfile

import numpy as np
import torch

from voxelhex_tpu_torch.tree.boxtree import INTERNAL, LEAF, UNIFORM, Albedo, BoxTree, _Node
from voxelhex_tpu_torch.tree.flat import FlatTree
from voxelhex_tpu_torch.tree.mipmap import MIPStrategy

# Format version: (major, minor).  Loaders accept equal major versions.
FORMAT_VERSION = (1, 0)


def _meta_dict(kind, extra=None):
    meta = {"format": "voxelhex_tpu", "kind": kind, "version": list(FORMAT_VERSION)}
    if extra:
        meta.update(extra)
    return meta


def version_compatible(version) -> bool:
    return tuple(version)[0] == FORMAT_VERSION[0]


def peek_version(path):
    """Read only the version metadata from a checkpoint file."""
    with zipfile.ZipFile(path) as zf:
        with zf.open("meta.json") as f:
            meta = json.load(f)
    return tuple(meta["version"])


def _write_npz(path, meta: dict, arrays: dict):
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.save(buf, np.asarray(arr))
            zf.writestr(name + ".npy", buf.getvalue())


def _read_npz(path):
    arrays = {}
    with zipfile.ZipFile(path) as zf:
        with zf.open("meta.json") as f:
            meta = json.load(f)
        for name in zf.namelist():
            if name.endswith(".npy"):
                with zf.open(name) as f:
                    arrays[name[:-4]] = np.load(f)
    return meta, arrays


def _check_version(meta):
    if not version_compatible(meta["version"]):
        raise ValueError(f"incompatible checkpoint version {meta['version']} != {FORMAT_VERSION}")


# ---------------------------------------------------------------------------
# flat snapshot
# ---------------------------------------------------------------------------


def save_flat(path, flat: FlatTree):
    meta = _meta_dict("flat", {"size": int(flat.size), "brick_dim": int(flat.brick_dim)})
    _write_npz(path, meta, {
        "node_meta": flat.node_meta,
        "node_children": flat.node_children,
        "node_ocbits": flat.node_ocbits,
        "node_mips": flat.node_mips,
        "bricks": flat.bricks,
        "palette": flat.palette,
    })


def load_flat(path) -> FlatTree:
    """The flat snapshot of :func:`save_flat` (``brick_ocbits`` is not
    stored, as in the reference)."""
    meta, arrays = _read_npz(path)
    _check_version(meta)
    if meta["kind"] not in ("flat", "tree"):
        raise ValueError(f"not a flat checkpoint: {meta['kind']}")
    return FlatTree(
        size=int(meta["size"]),
        brick_dim=int(meta["brick_dim"]),
        node_meta=arrays["node_meta"],
        node_children=arrays["node_children"],
        node_ocbits=arrays["node_ocbits"],
        node_mips=arrays["node_mips"],
        bricks=arrays["bricks"],
        palette=arrays["palette"],
    )


# ---------------------------------------------------------------------------
# full host tree
# ---------------------------------------------------------------------------


def save_tree(path, tree: BoxTree):
    """Serialize a host tree: node table + packed bricks + palettes.

    Per live node (renumbered densely, depth first from the root): type,
    occupancy (2 u32 words), occlusion, 64 children keys (internal) and
    brick descriptors (leaf, uniform, MIP) into a shared pool of bricks
    (``parted``, index >= 0) and solid values (``solids``, -2 - index);
    -1 is no brick."""
    keymap = {}
    order = []

    def discover(key):
        if key in keymap:
            return
        keymap[key] = len(order)
        order.append(key)
        node = tree.node(key)
        if node.ntype == INTERNAL and node.children is not None:
            for child in node.children:
                if tree.key_is_valid(child):
                    discover(child)

    discover(tree.ROOT)
    n = len(order)
    d3 = tree.brick_dim**3

    ntype = np.zeros(n, dtype=np.uint8)
    occupied = np.zeros((n, 2), dtype=np.uint32)
    occlusion = np.zeros(n, dtype=np.uint8)
    children = np.full((n, 64), -1, dtype=np.int64)
    mips = np.full(n, -1, dtype=np.int64)
    parted: list[np.ndarray] = []
    solids: list[int] = []

    def desc_of(brick) -> int:
        if brick is None:
            return -1
        if isinstance(brick, (int, np.integer)):
            solids.append(int(brick))
            return -2 - (len(solids) - 1)
        parted.append(np.asarray(brick, dtype=np.uint32))
        return len(parted) - 1

    for host_key in order:
        i = keymap[host_key]
        node = tree.node(host_key)
        ntype[i] = node.ntype
        occupied[i, 0] = node.occupied & 0xFFFFFFFF
        occupied[i, 1] = (node.occupied >> 32) & 0xFFFFFFFF
        occlusion[i] = node.occlusion
        mips[i] = desc_of(node.mip)
        if node.ntype == INTERNAL and node.children is not None:
            for s, child in enumerate(node.children):
                if tree.key_is_valid(child):
                    children[i, s] = keymap[child]
        elif node.ntype == LEAF:
            for s in range(64):
                children[i, s] = desc_of(node.bricks[s])
        elif node.ntype == UNIFORM:
            children[i, 0] = desc_of(node.bricks)

    colors = np.array([[c.r, c.g, c.b, c.a] for c in tree.color_palette],
                      dtype=np.uint8).reshape(-1, 4)
    # data values are hashable palette keys; their reprs evaluate back as
    # literals for the common types (int, str, tuple, ...)
    data_pal = json.dumps([repr(x) for x in tree.data_palette])

    mip_meta = None
    if tree.mip_strategy is not None:
        ms = tree.mip_strategy
        mip_meta = {
            "enabled": bool(ms.enabled),
            "methods": {str(k): [v[0], v[1]] for k, v in ms.methods.items()},
            "thresholds": {str(k): float(v) for k, v in ms.color_matching_thresholds.items()},
        }

    meta = _meta_dict("tree", {
        "size": int(tree.size),
        "brick_dim": int(tree.brick_dim),
        "auto_simplify": bool(tree.auto_simplify),
        "data_palette": data_pal,
        "mip_strategy": json.dumps(mip_meta),
    })
    _write_npz(path, meta, {
        "ntype": ntype,
        "occupied": occupied,
        "occlusion": occlusion,
        "children": children,
        "mips": mips,
        "parted": np.stack(parted) if parted else np.zeros((0, d3), dtype=np.uint32),
        "solids": np.array(solids, dtype=np.uint32),
        "colors": colors,
    })


def load_tree(path) -> BoxTree:
    meta, arrays = _read_npz(path)
    _check_version(meta)
    if meta["kind"] != "tree":
        raise ValueError(f"not a tree checkpoint: {meta['kind']}")

    tree = BoxTree(int(meta["size"]), int(meta["brick_dim"]), bool(meta["auto_simplify"]))
    for row in arrays["colors"]:
        tree._intern_color(Albedo(*(int(v) for v in row)))
    # the user-data palette: reprs back to literals, else the raw string
    for item in json.loads(meta.get("data_palette", "[]")):
        try:
            value = ast.literal_eval(item)
        except (ValueError, SyntaxError):
            value = item
        tree._intern_data(value)

    mip_meta = json.loads(meta.get("mip_strategy", "null") or "null")
    if mip_meta is not None:
        ms = MIPStrategy(enabled=bool(mip_meta["enabled"]))
        ms.methods = {int(k): (v[0], v[1]) for k, v in mip_meta["methods"].items()}
        ms.color_matching_thresholds = {int(k): float(v)
                                        for k, v in mip_meta["thresholds"].items()}
        tree.mip_strategy = ms

    parted = arrays["parted"]
    solids = arrays["solids"]

    def brick_of(desc: int):
        if desc == -1:
            return None
        if desc < -1:
            return int(solids[-2 - desc])
        return parted[desc].copy()

    ntype = arrays["ntype"]
    n = len(ntype)
    tree._nodes = [None] * n
    tree._free = []
    for i in range(n):
        node = _Node()
        node.ntype = int(ntype[i])
        node.occupied = int(arrays["occupied"][i, 0]) | (int(arrays["occupied"][i, 1]) << 32)
        node.occlusion = int(arrays["occlusion"][i])
        node.mip = brick_of(int(arrays["mips"][i]))
        ch = arrays["children"][i]
        if node.ntype == INTERNAL:
            node.children = [int(c) for c in ch]
        elif node.ntype == LEAF:
            node.bricks = [brick_of(int(c)) for c in ch]
        elif node.ntype == UNIFORM:
            node.bricks = brick_of(int(ch[0]))
        tree._nodes[i] = node
    return tree


# ---------------------------------------------------------------------------
# training state (params + optimizer state): checkpoint and resume of fits
# ---------------------------------------------------------------------------


def _leaves(tree):
    """The leaves of nested dicts, lists and tuples of tensors or arrays, in
    JAX's pytree order: a dict's values by sorted key, a sequence's in
    order; None has none.  The port's soft params {"albedo", "logits"} and
    Adam state {"count", "mu", "nu"} thus give optax's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_train_state(path, step: int, params, opt_state=None):
    """Versioned checkpoint of a training step: ``params`` and ``opt_state``
    are nested dicts (or lists) of tensors or arrays, such as the soft
    params and :func:`~voxelhex_tpu_torch.diff.optim.adam`'s state, or one
    tensor.  Leaves are stored in JAX's pytree order (``p_<i>``, ``o_<i>``),
    which is optax's for these states, so the reference loads them into its
    own templates and this module loads the reference's."""
    leaves_p = _leaves(params)
    leaves_o = _leaves(opt_state)
    meta = _meta_dict("train_state",
                      {"step": int(step), "n_params": len(leaves_p), "n_opt": len(leaves_o)})
    arrays = {f"p_{i}": _to_numpy(x) for i, x in enumerate(leaves_p)}
    arrays.update({f"o_{i}": _to_numpy(x) for i, x in enumerate(leaves_o)})
    _write_npz(path, meta, arrays)


def _restore(template, take):
    """``template`` with each leaf replaced by ``take(leaf)``, in
    :func:`_leaves`'s order."""
    if isinstance(template, dict):
        return {k: _restore(template[k], take) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(v, take) for v in template)
    return take(template)


def load_train_state(path, params_template, opt_state_template=None):
    """Restore ``(step, params, opt_state)`` from :func:`save_train_state`.

    The templates give the structure (e.g. ``opt.init(params)``); each leaf
    is replaced by the checkpoint's array of its shape, as a tensor of the
    template leaf's dtype on its device (an array where the template leaf is
    an array).  A leaf count or shape that differs raises ``ValueError``."""
    meta, arrays = _read_npz(path)
    if meta.get("kind") != "train_state":
        raise ValueError(f"not a train_state checkpoint: {meta.get('kind')}")
    _check_version(meta)

    def restore(template, prefix, count):
        n = len(_leaves(template))
        if n != count:
            raise ValueError(f"template has {n} leaves, checkpoint has {count}")
        index = iter(range(n))

        def take(leaf):
            i = next(index)
            arr = arrays[f"{prefix}_{i}"]
            if tuple(np.shape(leaf)) != tuple(arr.shape):
                raise ValueError(f"leaf {prefix}_{i} shape {arr.shape} != template "
                                 f"{tuple(np.shape(leaf))}")
            if torch.is_tensor(leaf):
                return torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
            return arr

        return _restore(template, take)

    params = restore(params_template, "p", meta["n_params"])
    opt_state = (restore(opt_state_template, "o", meta["n_opt"])
                 if opt_state_template is not None else None)
    return int(meta["step"]), params, opt_state
