"""Volume data layer: numpy copies of volren_tpu.voldata (grid
containers, the sparse 8^3 brick-grid encoding, .brick/.dense IO and the
animated multi-grid ``Volume`` container)."""

from .grid import Grid, DenseGrid
from .brick import BrickGrid, build_brick_grid, build_range_mips, to_brick_grid
from .brick_io import read_brick, write_brick, read_dense, write_dense
from .volume import Volume, load_grid

__all__ = [
    "Grid",
    "DenseGrid",
    "BrickGrid",
    "build_brick_grid",
    "build_range_mips",
    "to_brick_grid",
    "read_brick",
    "write_brick",
    "read_dense",
    "write_dense",
    "Volume",
    "load_grid",
]
