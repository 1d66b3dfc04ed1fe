"""State carried across from the reference package, and back.

The reference's ``BitGrid`` and ``FlatTree`` are dataclasses of NumPy
arrays; their fields, passed as a plain dict, become the port's BitGrid and
FlatTree without importing the reference.  A BoxTree crosses as the
reference's own bencode bytes, the format both packages write:
``voxelhex_tpu_torch.io.bencode.from_bytes(ref_bencode.to_bytes(tree))``,
and back the same way.  The soft renderer's params and optax's Adam state
travel as NumPy arrays (``np.asarray`` of the reference's leaves).
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.render.bitgrid import BitGrid
from voxelhex_tpu_torch.tree.flat import ARRAYS as FLAT_ARRAYS
from voxelhex_tpu_torch.tree.flat import FlatTree

FIELDS = ("size", "n_levels", "level_bases", "occ_lo", "occ_hi", "colors", "palette")


def from_jax_bitgrid(fields: dict) -> BitGrid:
    """BitGrid from the reference BitGrid's fields (``occ_lo``, ``occ_hi``,
    ``level_bases``, ``colors``, ``palette``, ``size``, ``n_levels``)."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"missing BitGrid fields: {missing}")
    bg = BitGrid(
        size=int(fields["size"]),
        n_levels=int(fields["n_levels"]),
        level_bases=np.asarray(fields["level_bases"], dtype=np.int64),
        occ_lo=np.asarray(fields["occ_lo"], dtype=np.uint32),
        occ_hi=np.asarray(fields["occ_hi"], dtype=np.uint32),
        colors=np.asarray(fields["colors"], dtype=np.uint16),
        palette=np.asarray(fields["palette"], dtype=np.float32),
    )
    if len(bg.level_bases) != bg.n_levels or len(bg.occ_lo) != len(bg.occ_hi):
        raise ValueError("inconsistent BitGrid fields")
    if bg.colors.size != bg.size**3:
        raise ValueError(f"colors has {bg.colors.size} entries, want {bg.size ** 3}")
    return bg


FLAT_DTYPES = {"node_meta": np.uint32, "node_children": np.int32, "node_ocbits": np.uint32,
               "node_mips": np.int32, "bricks": np.int32, "palette": np.float32,
               "brick_ocbits": np.uint32}


def from_jax_flat_tree(fields: dict) -> FlatTree:
    """FlatTree from the reference FlatTree's fields (``size``,
    ``brick_dim`` and the arrays of ``tree.flat.ARRAYS``)."""
    missing = [k for k in ("size", "brick_dim") + FLAT_ARRAYS if k not in fields]
    if missing:
        raise KeyError(f"missing FlatTree fields: {missing}")
    arrays = {k: np.array(fields[k], dtype=FLAT_DTYPES[k]) for k in FLAT_ARRAYS}
    flat = FlatTree(size=int(fields["size"]), brick_dim=int(fields["brick_dim"]), **arrays)
    n, d = flat.n_nodes, flat.brick_dim
    shapes = {"node_children": (n, 64), "node_ocbits": (n, 2), "node_mips": (n,),
              "bricks": (flat.n_bricks, d**3), "brick_ocbits": (flat.n_bricks, 2)}
    for k, shape in shapes.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k} has shape {arrays[k].shape}, want {shape}")
    if arrays["palette"].ndim != 2 or arrays["palette"].shape[1] != 4:
        raise ValueError(f"palette has shape {arrays['palette'].shape}, want [P, 4]")
    return flat


SOFT_PARAMS = ("albedo", "logits")


def from_jax_soft_params(params, device="cuda") -> dict:
    """The reference ``SoftRenderer``'s flat params ``{"albedo": [S^3 * 3],
    "logits": [S^3]}``, as NumPy arrays, as the port's f32 tensors."""
    out = {}
    for k in SOFT_PARAMS:
        a = np.asarray(params[k], dtype=np.float32)
        if a.ndim != 1:
            raise ValueError(f"{k}: want a flat array, got shape {a.shape}")
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def from_jax_adam_state(opt_state_leaves, device="cuda") -> dict:
    """optax's Adam state for the soft params as the port's
    ``{"count", "mu", "nu"}``.  ``opt_state_leaves`` is
    ``jax.tree.leaves(opt_state)`` as NumPy arrays: count, mu["albedo"],
    mu["logits"], nu["albedo"], nu["logits"]."""
    leaves = list(opt_state_leaves)
    if len(leaves) != 5:
        raise ValueError(f"want 5 leaves (count, mu albedo/logits, nu albedo/logits), "
                         f"got {len(leaves)}")
    count, mu_a, mu_l, nu_a, nu_l = leaves
    moments = {"mu": from_jax_soft_params({"albedo": mu_a, "logits": mu_l}, device),
               "nu": from_jax_soft_params({"albedo": nu_a, "logits": nu_l}, device)}
    return {"count": torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device),
            **moments}


def to_numpy(tree):
    """A nested dict of tensors (params, or the Adam state) as the same dict
    of NumPy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
