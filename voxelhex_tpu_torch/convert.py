"""State carried across from the reference package.

The reference's ``BitGrid`` is a dataclass of NumPy arrays; its fields,
passed as a plain dict, become the port's BitGrid without importing the
reference.
"""

from __future__ import annotations

import numpy as np

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
