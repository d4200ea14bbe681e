"""Serialized .brick / .dense grid IO.

The reference reads these through the voldata submodule (not vendored); the
on-disk layout was reverse-engineered byte-exactly from
reference data/smoke.brick:

    u8        tag (1 = brick grid)
    f32[16]   index->world transform, glm column-major
    u32[3]    n_bricks (x, y, z)
    f32[2]    minorant, majorant
    u64       n_allocated_bricks
    Buf3D     indirection  (u32 texels, GL 10-10-10-2 packing, MSB-first:
                            x=bits31..22, y=21..12, z=11..2)
    Buf3D     range        (2 x f16 per texel: min, max)
    Buf3D     atlas        (u8 voxels, 8^3 bricks tiled into a 3D texture)
    u64       n_mips
    n_mips x Buf3D range mipmaps (2 x f16 per texel)

where Buf3D = { u32 sx, sy, sz; u64 n_elements; payload } with x fastest
(GL texture upload order). Verified: smoke.brick = 16x32x16 bricks, 3297
allocated bricks, atlas 128x256x56, 3 range mips, majorant 5.7148.
"""

from __future__ import annotations

import struct

import numpy as np

from .brick import BrickGrid
from .grid import DenseGrid

TAG_DENSE = 0
TAG_BRICK = 1


def _read_buf_header(data: memoryview, off: int) -> tuple[tuple[int, int, int], int, int]:
    sx, sy, sz = struct.unpack_from("<3I", data, off)
    (n,) = struct.unpack_from("<Q", data, off + 12)
    return (sx, sy, sz), n, off + 20


def _write_buf(f, arr_zyx: np.ndarray, stride: tuple[int, int, int]) -> None:
    sx, sy, sz = stride
    n = sx * sy * sz
    f.write(struct.pack("<3IQ", sx, sy, sz, n))
    f.write(np.ascontiguousarray(arr_zyx).tobytes())


def _f16_conservative(range_: np.ndarray) -> np.ndarray:
    """Quantize (..., 2) f32 min/max to f16 without shrinking the interval
    (min rounds down, max rounds up) so majorants stay valid after reload."""
    h = range_.astype(np.float16)
    back = h.astype(np.float32)
    lo, hi = h[..., 0], h[..., 1]
    lo = np.where(back[..., 0] > range_[..., 0], np.nextafter(lo, np.float16(-np.inf)), lo)
    hi = np.where(back[..., 1] < range_[..., 1], np.nextafter(hi, np.float16(np.inf)), hi)
    return np.stack([lo, hi], axis=-1)


def read_brick(path: str) -> BrickGrid:
    data = memoryview(open(path, "rb").read())
    tag = data[0]
    if tag != TAG_BRICK:
        raise ValueError(f"{path}: unsupported grid tag {tag} (expected {TAG_BRICK})")
    transform = np.frombuffer(data, np.float32, 16, 1).reshape(4, 4).T.copy()  # col-major on disk
    off = 65
    nb = struct.unpack_from("<3I", data, off)
    minorant, majorant = struct.unpack_from("<2f", data, off + 12)
    (n_alloc,) = struct.unpack_from("<Q", data, off + 20)
    off += 28

    # indirection
    (sx, sy, sz), n, off = _read_buf_header(data, off)
    if (sx, sy, sz) != nb:
        raise ValueError("corrupt .brick: indirection extent must match "
                         f"n_bricks ({(sx, sy, sz)} != {nb})")
    packed = np.frombuffer(data, "<u4", n, off).reshape(sz, sy, sx)
    off += n * 4

    # range
    (rx, ry, rz), n, off = _read_buf_header(data, off)
    if (rx, ry, rz) != (sx, sy, sz):
        raise ValueError("corrupt .brick: range extent must match "
                         f"indirection ({(rx, ry, rz)} != {(sx, sy, sz)})")
    range_ = (
        np.frombuffer(data, "<f2", n * 2, off).astype(np.float32).reshape(rz, ry, rx, 2)
    )
    off += n * 4

    # atlas
    (ax, ay, az), n, off = _read_buf_header(data, off)
    atlas3d = np.frombuffer(data, np.uint8, n, off).reshape(az, ay, ax)
    off += n

    # range mipmaps
    (n_mips,) = struct.unpack_from("<Q", data, off)
    off += 8
    mips = []
    for _ in range(n_mips):
        (mx, my, mz), n, off = _read_buf_header(data, off)
        mips.append(
            np.frombuffer(data, "<f2", n * 2, off).astype(np.float32).reshape(mz, my, mx, 2)
        )
        off += n * 4

    # unpack 10-10-10-2 pointers and flatten the 3D atlas into brick slots
    px = (packed >> 22).astype(np.int64)
    py = ((packed >> 12) & 1023).astype(np.int64)
    pz = ((packed >> 2) & 1023).astype(np.int64)
    nbx, nby, nbz = ax // 8, ay // 8, az // 8
    slots = (
        atlas3d.reshape(nbz, 8, nby, 8, nbx, 8)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(-1, 8, 8, 8)
        .copy()
    )
    slot_ids = pz * (nby * nbx) + py * nbx + px
    # clamp so vectorized gathers stay in bounds even on malformed pointers
    # (empty bricks decode through their (0, 0) range and never observe the
    # atlas payload)
    slot_ids = np.clip(slot_ids, 0, max(0, slots.shape[0] - 1)).astype(np.uint32)

    return BrickGrid(
        indirection=slot_ids,
        range_=range_,
        atlas=slots,
        transform=transform,
        voxel_extent=np.array([sx * 8, sy * 8, sz * 8], dtype=np.int64),
        range_mips=mips if mips else None,
    )


def write_brick(path: str, grid: BrickGrid) -> None:
    bz, by, bx = grid.indirection.shape
    n_slots = grid.atlas.shape[0]
    # tile flat slots back into a 3D atlas texture, reference layout:
    # slot -> (slot % bx, (slot // bx) % by, slot // (bx * by))
    az_bricks = max(1, -(-n_slots // (bx * by)))
    atlas3d = np.zeros((az_bricks * bx * by, 8, 8, 8), dtype=np.uint8)
    atlas3d[:n_slots] = grid.atlas
    atlas3d = (
        atlas3d.reshape(az_bricks, by, bx, 8, 8, 8)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(az_bricks * 8, by * 8, bx * 8)
    )
    slot = grid.indirection.astype(np.uint64)
    px = slot % bx
    py = (slot // bx) % by
    pz = slot // (bx * by)
    packed = ((px << 22) | (py << 12) | (pz << 2)).astype(np.uint32)

    mn, mj = grid.minorant_majorant()
    with open(path, "wb") as f:
        f.write(struct.pack("<B", TAG_BRICK))
        f.write(np.asarray(grid.transform, np.float32).T.tobytes())  # col-major
        f.write(struct.pack("<3I2fQ", bx, by, bz, mn, mj, n_slots))
        _write_buf(f, packed, (bx, by, bz))
        _write_buf(f, _f16_conservative(grid.range), (bx, by, bz))
        _write_buf(f, atlas3d, (bx * 8, by * 8, az_bricks * 8))
        f.write(struct.pack("<Q", len(grid.range_mips)))
        for mip in grid.range_mips:
            mz, my, mx = mip.shape[:3]
            _write_buf(f, _f16_conservative(mip), (mx, my, mz))


def read_dense(path: str) -> DenseGrid:
    """Read our serialized dense grid format (tag 0 + mat4 + Buf3D<f32>).

    NOTE: the reference's .dense layout is produced by the non-vendored
    voldata submodule and no sample file exists in the snapshot; this format
    follows the same framing as .brick and round-trips with write_dense.
    """
    data = memoryview(open(path, "rb").read())
    if data[0] != TAG_DENSE:
        raise ValueError(f"{path}: unsupported grid tag {data[0]} (expected {TAG_DENSE})")
    transform = np.frombuffer(data, np.float32, 16, 1).reshape(4, 4).T.copy()
    (sx, sy, sz), n, off = _read_buf_header(data, 65)
    values = np.frombuffer(data, np.float32, n, off).reshape(sz, sy, sx)
    return DenseGrid(sx, sy, sz, values, transform)


def write_dense(path: str, grid: DenseGrid) -> None:
    d, h, w = grid.data.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<B", TAG_DENSE))
        f.write(np.asarray(grid.transform, np.float32).T.tobytes())
        _write_buf(f, grid.data.astype(np.float32), (w, h, d))
