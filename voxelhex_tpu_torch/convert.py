"""State carried across from the reference package, and back.

The reference's ``BitGrid`` is a dataclass of NumPy arrays; its fields,
passed as a plain dict, become the port's BitGrid without importing the
reference.  The soft renderer's params and optax's Adam state travel as
NumPy arrays (``np.asarray`` of the reference's leaves) the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelhex_tpu_torch.render.bitgrid import BitGrid

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
