"""Scene I/O on the host: MagicaVoxel ``.vox`` import (:mod:`.vox`) and the
bencode save format of VoxelHex (:mod:`.bencode`)."""

from voxelhex_tpu_torch.io import bencode
from voxelhex_tpu_torch.io.vox import load_vox_scene, load_vox_tree, parse_vox

__all__ = ["bencode", "load_vox_scene", "load_vox_tree", "parse_vox"]
