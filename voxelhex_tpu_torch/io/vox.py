"""MagicaVoxel ``.vox`` import, the port's copy of the reference's
``voxelhex_tpu/io/vox.py``.

A parser for the public VOX format (chunks MAIN / SIZE / XYZI / RGBA /
nTRN / nGRP / nSHP), the scene-graph walk and the coordinate handling:

* packed-byte rotation matrices (90-degree rotations, row-major 2-bit
  indices and sign bits);
* a walk that accumulates each transform's translation, with the frame
  selection rules of VoxelHex's importer;
* right-handed Z-up (.vox) to left-handed Y-up (the tree), that is
  ``(x, y, z) -> (x, z, y)``;
* the tree's size: the smallest ``brick_dim * 4**k`` that holds the model.

The voxels come out as NumPy arrays and go into a tree through the bulk
builder (:func:`voxelhex_tpu_torch.tree.build.from_voxels`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from voxelhex_tpu_torch.tree.build import from_voxels
from voxelhex_tpu_torch.tree.mipmap import recalculate_mips


@dataclass
class VoxModel:
    size: np.ndarray  # (3,) int32, xyz in vox (Rzup) space
    voxels: np.ndarray  # (N, 4) uint8: x, y, z, color_index


@dataclass
class VoxTransform:
    child: int
    frames: list[dict]
    layer: int = 0


@dataclass
class VoxGroup:
    children: list[int] = field(default_factory=list)


@dataclass
class VoxShape:
    models: list[tuple[int, dict]] = field(default_factory=list)


@dataclass
class VoxFile:
    models: list[VoxModel]
    palette: np.ndarray  # (256, 4) uint8 RGBA
    scene: dict[int, object]  # node_id -> VoxTransform | VoxGroup | VoxShape


def _default_palette() -> np.ndarray:
    """The palette of a file with no RGBA chunk: a grayscale ramp (files
    almost always ship their own)."""
    g = np.linspace(255, 0, 256).astype(np.uint8)
    return np.stack([g, g, g, np.full(256, 255, np.uint8)], axis=1)


def _read_dict(buf, off):
    (n,) = struct.unpack_from("<i", buf, off)
    off += 4
    out = {}
    for _ in range(n):
        (klen,) = struct.unpack_from("<i", buf, off)
        off += 4
        k = buf[off : off + klen].decode("ascii")
        off += klen
        (vlen,) = struct.unpack_from("<i", buf, off)
        off += 4
        v = buf[off : off + vlen].decode("ascii")
        off += vlen
        out[k] = v
    return out, off


def parse_vox(path) -> VoxFile:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"VOX ":
        raise ValueError(f"{path} is not a .vox file")

    models: list[VoxModel] = []
    palette = _default_palette()
    scene: dict[int, object] = {}
    pending_size = None

    off = 8
    try:
        return _parse_vox_chunks(data, off, models, palette, scene,
                                 pending_size)
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        # a truncated/corrupt stream fails mid-unpack — surface a clean
        # error (the viewer's drag-drop /load route shows this message)
        raise ValueError(f"truncated or corrupt .vox file: {e}") from e
    except ValueError as e:
        # short chunk bodies surface as raw numpy frombuffer/reshape
        # ValueErrors; re-wrap those too (but keep already-clean messages)
        if "truncated or corrupt" in str(e) or "MAIN chunk" in str(e):
            raise
        raise ValueError(f"truncated or corrupt .vox file: {e}") from e


def _parse_vox_chunks(data, off, models, palette, scene, pending_size):
    # MAIN chunk header
    cid, csize, childsize = struct.unpack_from("<4sii", data, off)
    if cid != b"MAIN":
        raise ValueError("missing MAIN chunk")
    off += 12 + csize
    end = off + childsize

    while off < end:
        cid, csize, childsize = struct.unpack_from("<4sii", data, off)
        body = data[off + 12 : off + 12 + csize]
        off += 12 + csize + childsize

        if cid == b"SIZE":
            pending_size = np.array(struct.unpack("<3i", body), dtype=np.int32)
        elif cid == b"XYZI":
            (n,) = struct.unpack_from("<i", body, 0)
            if len(body) < 4 + 4 * n:
                raise ValueError(
                    f"XYZI body holds {(len(body) - 4) // 4} voxels, "
                    f"header claims {n}"
                )
            vox = np.frombuffer(body[4 : 4 + 4 * n], dtype=np.uint8).reshape(n, 4)
            if pending_size is None:
                raise ValueError("XYZI without preceding SIZE")
            models.append(VoxModel(size=pending_size, voxels=vox))
            pending_size = None
        elif cid == b"RGBA":
            raw = np.frombuffer(body[: 256 * 4], dtype=np.uint8).reshape(256, 4)
            # color index i (1-based in XYZI) maps to raw[i-1]
            palette = raw.copy()
        elif cid == b"nTRN":
            p = 0
            (node_id,) = struct.unpack_from("<i", body, p)
            p += 4
            _attrs, p = _read_dict(body, p)
            child, _reserved, layer, nframes = struct.unpack_from("<4i", body, p)
            p += 16
            frames = []
            for _ in range(nframes):
                fr, p = _read_dict(body, p)
                frames.append(fr)
            scene[node_id] = VoxTransform(child=child, frames=frames, layer=layer)
        elif cid == b"nGRP":
            p = 0
            (node_id,) = struct.unpack_from("<i", body, p)
            p += 4
            _attrs, p = _read_dict(body, p)
            (n,) = struct.unpack_from("<i", body, p)
            p += 4
            children = list(struct.unpack_from(f"<{n}i", body, p))
            scene[node_id] = VoxGroup(children=children)
        elif cid == b"nSHP":
            p = 0
            (node_id,) = struct.unpack_from("<i", body, p)
            p += 4
            _attrs, p = _read_dict(body, p)
            (n,) = struct.unpack_from("<i", body, p)
            p += 4
            entries = []
            for _ in range(n):
                (model_id,) = struct.unpack_from("<i", body, p)
                p += 4
                attrs, p = _read_dict(body, p)
                entries.append((model_id, attrs))
            scene[node_id] = VoxShape(models=entries)
        # other chunks (MATL, LAYR, rOBJ, rCAM, NOTE, IMAP) are irrelevant

    return VoxFile(models=models, palette=palette, scene=scene)


def parse_rotation_byte(b: int) -> np.ndarray:
    """Packed-byte 90-degree rotation matrix.  Row-major: rows have a single +-1."""
    m = np.zeros((3, 3), dtype=np.int64)
    i0 = b & 0x3
    i1 = (b >> 2) & 0x3
    i2 = (~(i0 ^ i1)) & 0x3
    m[0, i0] = -1 if b & 0x10 else 1
    m[1, i1] = -1 if b & 0x20 else 1
    m[2, i2] = -1 if b & 0x40 else 1
    return m


def _walk_scene(vox: VoxFile, frame: int = 0):
    """Yield (model, translation_rzup, rotation) for every shape instance,
    with VoxelHex's accumulation rules (translation adds unrotated;
    a transform without "_r" resets orientation to identity)."""
    if not vox.scene:
        for model in vox.models:
            yield model, np.zeros(3, dtype=np.int64), np.eye(3, dtype=np.int64)
        return

    root = vox.scene[0]
    assert isinstance(root, VoxTransform), "root scene node must be a Transform"
    stack = [(root.child, np.zeros(3, dtype=np.int64), np.eye(3, dtype=np.int64))]
    while stack:
        node_id, translation, rotation = stack.pop()
        node = vox.scene.get(node_id)
        if node is None:
            continue
        if isinstance(node, VoxTransform):
            used = frame if frame < len(node.frames) else 0
            fr = node.frames[used] if node.frames else {}
            t = translation
            if "_t" in fr:
                t = translation + np.array(
                    [int(x) for x in fr["_t"].split(" ")], dtype=np.int64
                )
            if "_r" in fr:
                r = rotation @ parse_rotation_byte(int(fr["_r"]))
            else:
                r = np.eye(3, dtype=np.int64)
            stack.append((node.child, t, r))
        elif isinstance(node, VoxGroup):
            for child in node.children:
                stack.append((child, translation, rotation))
        elif isinstance(node, VoxShape):
            for model_id, attrs in node.models:
                if int(attrs.get("_f", "0")) == frame:
                    yield vox.models[model_id], translation, rotation


def load_vox_scene(path, frame: int = 0):
    """Load a .vox file into world-space voxel arrays.

    Returns ``(positions int64 (N,3) in Lyup tree space, colors uint8 (N,4))``.
    """
    vox = parse_vox(path)

    all_pos = []
    all_col = []
    min_rzup = np.array([2**62] * 3, dtype=np.int64)
    placements = list(_walk_scene(vox, frame))

    for model, translation, rotation in placements:
        half = (rotation @ model.size.astype(np.int64)) // 2
        min_rzup = np.minimum(min_rzup, translation - half)
        min_rzup = np.minimum(min_rzup, translation + half)

    for model, translation, rotation in placements:
        half = (rotation @ model.size.astype(np.int64)) // 2
        bottom_left = translation - half + np.where(half < 0, -1, 0)
        pos = model.voxels[:, :3].astype(np.int64) @ rotation.T + bottom_left
        all_pos.append(pos - min_rzup)
        color_idx = model.voxels[:, 3].astype(np.int64) - 1
        all_col.append(vox.palette[np.clip(color_idx, 0, 255)])

    if not all_pos:
        return np.zeros((0, 3), np.int64), np.zeros((0, 4), np.uint8)

    pos_rzup = np.concatenate(all_pos)
    colors = np.concatenate(all_col)
    # Rzup -> Lyup: swap y and z
    pos_lyup = pos_rzup[:, [0, 2, 1]]
    return pos_lyup, colors


def tree_size_for(extent: int, brick_dim: int) -> int:
    """Smallest brick_dim * 4**k >= extent."""
    k = 0
    while brick_dim * 4**k < max(extent, brick_dim * 4):
        k += 1
    return brick_dim * 4**k


def load_vox_tree(path, brick_dim: int = 32, frame: int = 0, simplify: bool = True,
                  mip_strategy=None):
    """Load a .vox file into a BoxTree via the bulk builder.

    ``mip_strategy``: an optional :class:`~voxelhex_tpu_torch.tree.mipmap.MIPStrategy`
    installed on the tree before returning; when its ``enabled`` flag is set
    the MIP bricks are built with the strategy's per-level resampling methods
    and color-matching thresholds.
    """
    positions, colors = load_vox_scene(path, frame)
    extent = int(positions.max() + 1) if len(positions) else brick_dim * 4
    size = tree_size_for(extent, brick_dim)
    tree = from_voxels(positions, colors, size=size, brick_dim=brick_dim, simplify=simplify)
    if mip_strategy is not None:
        tree.mip_strategy = mip_strategy
        if mip_strategy.enabled:
            recalculate_mips(tree)
    return tree
