"""Sparse 8^3 brick grid encoding.

This is the device-facing volume format: the decode contract is fixed by the
reference kernels (reference shader/common.glsl:268-281):

    brick       = voxel >> 3
    ptr         = indirection[brick]
    value_unorm = atlas[ptr * 8 + (voxel & 7)] / 255
    density     = range[brick].min + value_unorm * (range[brick].max - range[brick].min)
    majorant(mip) = range_mip[mip][voxel >> (3 + mip)].max      (mip 0 = range itself)

Differences from the reference's texture layout (deliberate):
the atlas is a flat array of 8^3 bricks and the indirection stores a flat
slot id instead of a packed 10-10-10-2 3D texture pointer — random
gathers want a single linear index. The serialized .brick format (3D-texture
layouts) is converted on load/save in brick_io.py.
"""

from __future__ import annotations

import numpy as np

from .grid import Grid

NUM_RANGE_MIPS = 3  # reference ships 3 min/max mipmaps (data/smoke.brick); DDA MIP_START=3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BrickGrid(Grid):
    def __init__(
        self,
        indirection: np.ndarray,  # (bz, by, bx) uint32 flat slot ids
        range_: np.ndarray,  # (bz, by, bx, 2) float32 (min, max)
        atlas: np.ndarray,  # (n_slots, 8, 8, 8) uint8
        transform: np.ndarray,
        voxel_extent: np.ndarray | None = None,  # (x, y, z) true voxel extent
        range_mips: list[np.ndarray] | None = None,
    ):
        self.indirection = np.ascontiguousarray(indirection, dtype=np.uint32)
        self.range = np.ascontiguousarray(range_, dtype=np.float32)
        self.atlas = np.ascontiguousarray(atlas, dtype=np.uint8)
        self.transform = np.asarray(transform, dtype=np.float32)
        bz, by, bx = self.indirection.shape
        if voxel_extent is None:
            voxel_extent = np.array([bx * 8, by * 8, bz * 8], dtype=np.int64)
        self.voxel_extent = np.asarray(voxel_extent, dtype=np.int64)
        self.range_mips = (
            range_mips if range_mips is not None else build_range_mips(self.range)
        )

    # ---- Grid interface ----

    def index_extent(self) -> np.ndarray:
        return self.voxel_extent

    def minorant_majorant(self) -> tuple[float, float]:
        return float(self.range[..., 0].min()), float(self.range[..., 1].max())

    @property
    def n_bricks(self) -> tuple[int, int, int]:
        bz, by, bx = self.indirection.shape
        return (bx, by, bz)

    def lookup(self, ipos: np.ndarray) -> np.ndarray:
        """Decode densities at integer voxel positions (out-of-bounds -> 0)."""
        ipos = np.asarray(ipos, dtype=np.int64)
        bz, by, bx = self.indirection.shape
        x, y, z = ipos[..., 0], ipos[..., 1], ipos[..., 2]
        inb = (x >= 0) & (y >= 0) & (z >= 0) & (x < bx * 8) & (y < by * 8) & (z < bz * 8)
        xc = np.clip(x, 0, bx * 8 - 1)
        yc = np.clip(y, 0, by * 8 - 1)
        zc = np.clip(z, 0, bz * 8 - 1)
        slot = self.indirection[zc >> 3, yc >> 3, xc >> 3]
        rmin = self.range[zc >> 3, yc >> 3, xc >> 3, 0]
        rmax = self.range[zc >> 3, yc >> 3, xc >> 3, 1]
        unorm = self.atlas[slot, zc & 7, yc & 7, xc & 7].astype(np.float32) / 255.0
        return np.where(inb, rmin + unorm * (rmax - rmin), 0.0).astype(np.float32)

    def to_dense(self) -> np.ndarray:
        ex, ey, ez = (int(v) for v in self.voxel_extent)
        zz, yy, xx = np.meshgrid(
            np.arange(ez), np.arange(ey), np.arange(ex), indexing="ij"
        )
        ipos = np.stack([xx, yy, zz], axis=-1)
        return self.lookup(ipos)


def build_range_mips(range_: np.ndarray, n_mips: int = NUM_RANGE_MIPS) -> list[np.ndarray]:
    """Min/max mip pyramid over the per-brick range buffer.

    Mip m has ceil(dim / 2) of the previous level per axis (clamped to >= 1);
    each texel is the (min of mins, max of maxs) over its <=2^3 children, so
    majorant bounds stay conservative at every level.
    """
    mips = []
    cur = range_
    for _ in range(n_mips):
        bz, by, bx = cur.shape[:3]
        nz, ny, nx = max(1, _cdiv(bz, 2)), max(1, _cdiv(by, 2)), max(1, _cdiv(bx, 2))
        pad = np.empty((nz * 2, ny * 2, nx * 2, 2), dtype=np.float32)
        # pad with edge values so padded children never widen the range
        pad[:bz, :by, :bx] = cur
        pad[bz:, :by, :bx] = cur[-1:, :, :]
        pad[:, by:, :bx] = pad[:, by - 1 : by, :bx]
        pad[:, :, bx:] = pad[:, :, bx - 1 : bx]
        blocks = pad.reshape(nz, 2, ny, 2, nx, 2, 2)
        nxt = np.empty((nz, ny, nx, 2), dtype=np.float32)
        nxt[..., 0] = blocks[..., 0].min(axis=(1, 3, 5))
        nxt[..., 1] = blocks[..., 1].max(axis=(1, 3, 5))
        mips.append(nxt)
        cur = nxt
    return mips


def build_brick_grid(dense: np.ndarray, transform: np.ndarray | None = None) -> BrickGrid:
    """Encode a dense (z, y, x) float32 array as a BrickGrid.

    Equivalent of voldata::Volume::to_brick_grid
    (reference src/renderer.cpp:63). Only bricks with max > min get an
    atlas slot: constant bricks (including empty ones) decode exactly through
    the range alone, for any atlas content. This is the numpy path of
    volren_tpu.voldata.brick, bit for bit.
    """
    dense = np.asarray(dense, dtype=np.float32)
    if transform is None:
        transform = np.eye(4, dtype=np.float32)
    Z, Y, X = dense.shape
    bx, by, bz = _cdiv(X, 8), _cdiv(Y, 8), _cdiv(Z, 8)
    padded = np.zeros((bz * 8, by * 8, bx * 8), dtype=np.float32)
    padded[:Z, :Y, :X] = dense
    # (bz, by, bx, 8z, 8y, 8x)
    blocks = (
        padded.reshape(bz, 8, by, 8, bx, 8).transpose(0, 2, 4, 1, 3, 5).copy()
    )
    bmin = blocks.min(axis=(3, 4, 5))
    bmax = blocks.max(axis=(3, 4, 5))
    # padding voxels are zero; keep decoded values exact by not letting the
    # padding widen a brick's range unless the brick really contains zeros
    occupied = bmax > bmin
    n_occ = int(occupied.sum())
    slot_ids = np.zeros((bz, by, bx), dtype=np.uint32)
    slot_ids[occupied] = np.arange(n_occ, dtype=np.uint32)
    if n_occ > 0:
        occ = blocks[occupied]  # (n_occ, 8, 8, 8)
        omin = bmin[occupied][:, None, None, None]
        omax = bmax[occupied][:, None, None, None]
        # f32 op order of the reference encoder: (v - lo) * scale + 0.5
        scale = np.float32(255.0) / (omax - omin)
        atlas = ((occ - omin) * scale + np.float32(0.5)).astype(np.uint8)
    else:
        atlas = np.zeros((1, 8, 8, 8), dtype=np.uint8)
    range_ = np.stack([bmin, bmax], axis=-1).astype(np.float32)
    return BrickGrid(
        indirection=slot_ids,
        range_=range_,
        atlas=atlas,
        transform=transform,
        voxel_extent=np.array([X, Y, Z], dtype=np.int64),
    )


def to_brick_grid(grid: Grid) -> BrickGrid:
    """Convert any grid to a BrickGrid (identity for BrickGrid inputs)."""
    if isinstance(grid, BrickGrid):
        return grid
    return build_brick_grid(grid.to_dense(), grid.transform)
