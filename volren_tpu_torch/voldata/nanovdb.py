"""Minimal NanoVDB (.nvdb) reader (copy of volren_tpu.voldata.nanovdb).

Parses the subset needed to ingest fog-volume float grids: file header,
grid metadata, and the NanoVDB tree (root -> upper 32^3 -> lower 16^3 ->
leaf 8^3 nodes) for FloatGrid / Fp variants stored uncompressed or
zip-compressed. Reference capability: voldata's NanoVDB loader
(README.md:4, loaders listed in SURVEY §2b).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import blosc
from .grid import DenseGrid

_MAGIC = 0x304244566F6E614E  # "NanoVDB0"
_MAGIC_GRID = 0x314244566F6E614E  # "NanoVDB1" (grid-oriented magic, v32.6+)
_MAGIC_FILE = 0x324244566F6E614E  # "NanoVDB2" (file-oriented magic)

_CODEC_NONE = 0
_CODEC_ZIP = 1
_CODEC_BLOSC = 2

_GRIDTYPE_FLOAT = 1


def read_nanovdb(path: str, name: str = "density") -> DenseGrid:
    """Read a float grid from a .nvdb file and densify it.

    Supports uncompressed and zip codecs, GridType float. Raises on
    blosc-compressed or non-float grids.
    """
    with open(path, "rb") as f:
        raw = f.read()

    magic = struct.unpack_from("<Q", raw, 0)[0]
    if magic not in (_MAGIC, _MAGIC_FILE, _MAGIC_GRID):
        raise ValueError(f"{path}: not a NanoVDB file (magic {magic:#x})")
    version, n_grids, codec = struct.unpack_from("<IHH", raw, 8)
    off = 16

    for _ in range(max(1, n_grids)):
        # FileMetaData: see nanovdb/util/IO.h (public spec)
        (
            grid_size,
            file_size,
            name_key,
            voxel_count,
            grid_type,
            grid_class,
        ) = struct.unpack_from("<QQQQII", raw, off)
        world_bbox = struct.unpack_from("<6d", raw, off + 40)
        index_bbox = struct.unpack_from("<6i", raw, off + 88)
        voxel_size = struct.unpack_from("<3d", raw, off + 112)
        (name_size,) = struct.unpack_from("<I", raw, off + 136)
        n_nodes = struct.unpack_from("<4I", raw, off + 140)
        n_tiles = struct.unpack_from("<4I", raw, off + 156)
        # codec u16 @172, padding u16 @174, version u32 @176 -> 180 B total
        meta_codec, padding, meta_version = struct.unpack_from("<HHI", raw, off + 172)
        off += 180
        gname = raw[off : off + name_size].split(b"\x00")[0].decode("utf-8", "replace")
        off += name_size

        payload = raw[off : off + file_size]
        off += file_size
        if gname != name and n_grids > 1:
            continue
        if meta_codec == _CODEC_ZIP or codec == _CODEC_ZIP:
            # zip framing: u64 compressed size then zlib stream
            (csize,) = struct.unpack_from("<Q", payload, 0)
            payload = zlib.decompress(payload[8 : 8 + csize])
        elif meta_codec == _CODEC_BLOSC or codec == _CODEC_BLOSC:
            # blosc framing: u64 compressed size + chunk, repeated until
            # grid_size bytes are reconstructed (io.h writes one chunk per
            # <= 2^30 span)
            parts, pos = [], 0
            total = 0
            while total < grid_size and pos < len(payload):
                (csize,) = struct.unpack_from("<Q", payload, pos)
                pos += 8
                part = blosc.decompress(payload[pos : pos + csize])
                pos += csize
                parts.append(part)
                total += len(part)
            payload = b"".join(parts)
        if grid_type != _GRIDTYPE_FLOAT:
            raise ValueError(f"{path}: only float NanoVDB grids supported (type {grid_type})")
        return _densify_nanovdb_grid(np.frombuffer(payload, np.uint8), index_bbox)

    raise KeyError(f"{path}: grid {name!r} not found")


def _densify_nanovdb_grid(buf: np.ndarray, index_bbox) -> DenseGrid:
    """Walk the NanoVDB float tree and write active voxels into a dense array."""
    # GridData header is 672 bytes in v32.3+; TreeData follows.
    # Offsets below follow the public NanoVDB.h ABI (version 32).
    data = buf.tobytes()

    def u64(o):
        return struct.unpack_from("<Q", data, o)[0]

    def f64(o):
        return struct.unpack_from("<d", data, o)[0]

    grid_size = u64(8 + 8)  # GridData::mGridSize at offset 16
    # map: mMap at offset 264 holds 4x4 double affine (mMatD 9d + mVecD 3d ...)
    # world transform: T(i) = mMatD * i + mVecD
    matd = struct.unpack_from("<9d", data, 264 + 0)
    # Map layout: float mMatF[9], mInvMatF[9], mVecF[3], mTaperF -> 88 bytes,
    # then double mMatD[9], mInvMatD[9], mVecD[3], mTaperD
    map_off = 264
    matd = struct.unpack_from("<9d", data, map_off + 88)
    vecd = struct.unpack_from("<3d", data, map_off + 88 + 144)

    tree_off = 672  # GridData::memUsage()
    # TreeData v32: mNodeOffset[4] (u64 x4), mNodeCount[3] (u32 x3),
    # mTileCount[3] (u32 x3), mVoxelCount (u64)
    node_off = [u64(tree_off + 8 * i) for i in range(4)]
    leaf_count = struct.unpack_from("<I", data, tree_off + 32)[0]

    x0, y0, z0, x1, y1, z1 = index_bbox
    if x1 < x0 or y1 < y0 or z1 < z0:
        raise ValueError("empty NanoVDB grid")
    nx, ny, nz = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
    # allocation guard: the densified bbox is file-controlled data — a
    # corrupted header must raise, not exhaust memory (loader fuzz pass)
    if nx * ny * nz > 512 * 1024 * 1024:
        raise ValueError(
            f"NanoVDB index bbox {nx}x{ny}x{nz} too large to densify "
            "(corrupted header?)")
    dense = np.zeros((nz, ny, nx), dtype=np.float32)

    # leaf nodes are 8^3 float leaves: LeafData<float> =
    # CoordBBox mBBoxMin (3i) + mBBoxDif (3B) + mFlags (B) ... then
    # mValueMask (64B) + mMinimum, mMaximum, mAverage, mStdDevi (4f) + values[512]
    LEAF_SIZE = 12 + 3 + 1 + 64 + 4 * 4 + 512 * 4
    base = tree_off + node_off[0]
    for i in range(leaf_count):
        o = base + i * LEAF_SIZE
        bx, by, bz = struct.unpack_from("<3i", data, o)
        mask = np.unpackbits(
            np.frombuffer(data, np.uint8, 64, o + 16), bitorder="little"
        ).astype(bool)
        vals = np.frombuffer(data, np.float32, 512, o + 16 + 64 + 16)
        block = np.where(mask, vals, 0.0).reshape(8, 8, 8)  # (x, y, z) order
        block = block.transpose(2, 1, 0)  # -> (z, y, x)
        zi, yi, xi = bz - z0, by - y0, bx - x0
        if 0 <= zi <= nz - 8 and 0 <= yi <= ny - 8 and 0 <= xi <= nx - 8:
            dense[zi : zi + 8, yi : yi + 8, xi : xi + 8] = block

    transform = np.eye(4, dtype=np.float32)
    M = np.array(matd, dtype=np.float64).reshape(3, 3)
    transform[:3, :3] = M.T.astype(np.float32)  # row-major storage of column-major map
    origin = np.array(vecd) + M.T @ np.array([x0, y0, z0], dtype=np.float64)
    transform[:3, 3] = origin.astype(np.float32)
    return DenseGrid(nx, ny, nz, dense, transform)
