"""Scene I/O on the host: MagicaVoxel ``.vox`` import (:mod:`.vox`), the
bencode save format of VoxelHex (:mod:`.bencode`) and versioned checkpoints
of trees, flat snapshots and training state (:mod:`.checkpoint`)."""

from voxelhex_tpu_torch.io import bencode, checkpoint
from voxelhex_tpu_torch.io.vox import (load_vox_scene, load_vox_tree, load_vox_tree_cached,
                                       parse_vox)

__all__ = ["bencode", "checkpoint", "load_vox_scene", "load_vox_tree", "load_vox_tree_cached",
           "parse_vox"]
