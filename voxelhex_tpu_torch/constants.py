"""Constants of the boxtree and the BitGrid, copied so the port stands alone.

A boxtree node splits space into 4x4x4 = 64 children ("sectants"); the
BitGrid pyramid stores each 4x4x4 group of cells as one 64-bit occupancy
word pair.
"""

# Number of child cells along one edge of a node.
BOX_NODE_DIMENSION = 4

# Total child cells of a node (4**3); also the out-of-block sectant.
BOX_NODE_CHILDREN_COUNT = 64
OOB = BOX_NODE_CHILDREN_COUNT

# Voxel index of a ray that hit nothing.
EMPTY_DESC = -1
# Descriptor flag of a solid brick in the flat tree.
SOLID_FLAG = 1 << 30
# Voxel index of a hit on an occupied voxel that carries no color.
NO_COLOR_HIT = 0x3FFFFFFE

# Color-grid sentinels: voxel empty / voxel occupied but colorless.
COLOR_EMPTY = 0xFFFF
COLOR_NONE = 0xFFFE

# ---- the boxtree's own constants

# Epsilon used by traversal to nudge points off cell boundaries.
VOXEL_EPSILON = 1e-5

# Palette index meaning "no entry" in a 16-bit palette slot.
EMPTY_U16 = 0xFFFF

# A packed 32-bit palette value / node key meaning "empty".
EMPTY_U32 = 0xFFFFFFFF

# Packed voxel value of a completely empty voxel: no color, no data.
EMPTY_VOXEL = EMPTY_U32

# Most colors a palette holds: 16-bit indices, the largest kept as the
# empty marker.
MAX_PALETTE_SIZE = 0xFFFF
