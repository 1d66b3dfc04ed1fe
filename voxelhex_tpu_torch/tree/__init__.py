"""The boxtree, the port's scene model on the host (NumPy).

* :mod:`.boxtree` — the sparse voxel-brick 64-tree: insert, update, clear
  (at a level of detail), simplify, query;
* :mod:`.mipmap` — per-node MIP bricks and their strategies;
* :mod:`.build` — bulk construction from point voxels;
* :mod:`.flat` — the flat arrays that the BitGrid is built from;
* :mod:`.invariants` — the structural audit the tests run.
"""

from voxelhex_tpu_torch.tree.boxtree import Albedo, BoxTree, Entry

__all__ = ["Albedo", "BoxTree", "Entry"]
