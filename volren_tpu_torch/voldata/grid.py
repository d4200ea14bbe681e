"""Grid containers (voldata::Grid / DenseGrid equivalents).

Reference API surface from call sites: grids expose ``index_extent()``,
``transform`` (index->world mat4), ``minorant_majorant()`` and can be
converted to a sparse brick grid (reference src/renderer.cpp:56-76,
reference src/main.cpp:464-474).
"""

from __future__ import annotations

import numpy as np


class Grid:
    """Base class for volume grids.

    ``transform`` maps index space (voxel coordinates) to world space.
    ``index_extent`` is the (x, y, z) voxel extent.
    """

    transform: np.ndarray  # (4, 4) float32, index -> world

    def index_extent(self) -> np.ndarray:
        raise NotImplementedError

    def minorant_majorant(self) -> tuple[float, float]:
        raise NotImplementedError

    def lookup(self, ipos: np.ndarray) -> np.ndarray:
        """Nearest-neighbour density lookup at integer index positions
        (out-of-bounds reads return 0)."""
        raise NotImplementedError

    def to_dense(self) -> np.ndarray:
        """Materialize as a dense (z, y, x) float32 array."""
        raise NotImplementedError

    def world_aabb(self) -> tuple[np.ndarray, np.ndarray]:
        """Axis-aligned bounding box of the grid in world space (all 8
        transformed index-space corners, so rotations are handled)."""
        ext = np.asarray(self.index_extent(), dtype=np.float32)
        corners = np.array(
            [[x, y, z, 1.0] for x in (0, ext[0]) for y in (0, ext[1]) for z in (0, ext[2])],
            dtype=np.float32,
        )
        world = corners @ np.asarray(self.transform, dtype=np.float32).T
        return world[:, :3].min(axis=0), world[:, :3].max(axis=0)

    def to_string(self, indent: str = "") -> str:
        ext = self.index_extent()
        mn, mj = self.minorant_majorant()
        return (
            f"{indent}{type(self).__name__}: extent=({ext[0]}, {ext[1]}, {ext[2]}), "
            f"minorant={mn:.4f}, majorant={mj:.4f}"
        )


class DenseGrid(Grid):
    """Dense voxel grid. Mirrors voldata::DenseGrid(w, h, d, float*/uint8*)
    (reference src/main.cpp:470, reference src/bindings.cpp:83-85).

    ``data`` is stored as (z, y, x) float32; uint8 input is normalized to
    [0, 1].
    """

    def __init__(self, w: int, h: int, d: int, values, transform: np.ndarray | None = None):
        values = np.asarray(values)
        if values.dtype == np.uint8:
            values = values.astype(np.float32) / 255.0
        else:
            values = values.astype(np.float32)
        # reference passes a flat pointer with x fastest (GL texture order)
        self.data = values.reshape(d, h, w)
        self.transform = (
            np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)
        )

    def index_extent(self) -> np.ndarray:
        d, h, w = self.data.shape
        return np.array([w, h, d], dtype=np.int64)

    def minorant_majorant(self) -> tuple[float, float]:
        return float(self.data.min()), float(self.data.max())

    def lookup(self, ipos: np.ndarray) -> np.ndarray:
        ipos = np.asarray(ipos, dtype=np.int64)
        d, h, w = self.data.shape
        x, y, z = ipos[..., 0], ipos[..., 1], ipos[..., 2]
        inb = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (z >= 0) & (z < d)
        xc, yc, zc = (np.clip(v, 0, s - 1) for v, s in ((x, w), (y, h), (z, d)))
        return np.where(inb, self.data[zc, yc, xc], 0.0).astype(np.float32)

    def to_dense(self) -> np.ndarray:
        return self.data
