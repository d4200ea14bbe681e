"""Volume data layer: numpy copies of volren_tpu.voldata (grid
containers, the sparse 8^3 brick-grid encoding, .brick/.dense IO, the
OpenVDB, NanoVDB and DICOM readers with their blosc/LZ4 codec, and the
animated multi-grid ``Volume`` container)."""

from .buf3d import Buf3D
from .grid import Grid, DenseGrid
from .brick import BrickGrid, build_brick_grid, build_range_mips, to_brick_grid
from .brick_io import read_brick, write_brick, read_dense, write_dense
from .volume import Volume, load_grid

__all__ = [
    "Buf3D",
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
