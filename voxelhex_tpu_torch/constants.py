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
