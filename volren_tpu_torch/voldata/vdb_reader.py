"""OpenVDB (.vdb) file IO — pure-python reader + writer (copy of
volren_tpu.voldata.vdb_reader; the writer adds several grids per file and
half floats).

The reference loads OpenVDB grids through the voldata submodule linked
against libopenvdb (README.md:17, loaders in SURVEY 2b). No OpenVDB library
exists in this environment, so this is a from-scratch implementation of the
subset needed for volume rendering:

  * file versions >= 220 (OpenVDB 3.x..10.x era files)
  * FloatGrid with the standard 5-4-3 tree (Root -> Internal<5> ->
    Internal<4> -> Leaf<3>), float or half leaf values
  * compression: NONE, ZIP, and BLOSC (lz4 + byte-shuffle chunks — the
    stock OpenVDB default — via the pure-python codec in blosc.py)
  * transforms: UniformScale(Translate)Map, Scale(Translate)Map,
    TranslationMap, AffineMap / identity

The writer emits ZIP-, BLOSC- or un-compressed float grids (used for
round-trip tests and the animated folders of the smoke run; no real .vdb
asset ships in the reference snapshot).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import blosc
from .grid import DenseGrid

MAGIC = 0x56444220  # int64 " BDV" little-endian

COMPRESS_NONE = 0
COMPRESS_ZIP = 0x1
COMPRESS_ACTIVE_MASK = 0x2
COMPRESS_BLOSC = 0x4

# readCompressedValues metadata codes (openvdb/io/Compression.h)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

_LEAF_LOG2 = 3
_INT1_LOG2 = 4  # lower internal: 16^3 leaves-span
_INT2_LOG2 = 5  # upper internal: 32^3


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def read(self, n):
        b = self.d[self.o : self.o + n]
        if len(b) != n:
            raise EOFError("unexpected end of .vdb file")
        self.o += n
        return b

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def i64(self):
        return struct.unpack("<q", self.read(8))[0]

    def f32(self):
        return struct.unpack("<f", self.read(4))[0]

    def f64(self, n=1):
        return struct.unpack(f"<{n}d", self.read(8 * n))

    def boolean(self):
        return self.read(1)[0] != 0

    def name(self):
        return self.read(self.u32()).decode("utf-8", "replace")


def _read_metamap(r: _Reader) -> dict:
    metas = {}
    count = r.u32()
    for _ in range(count):
        name = r.name()
        typ = r.name()
        val = r.read(r.u32())
        metas[name] = (typ, val)
    return metas


def _read_transform(r: _Reader) -> np.ndarray:
    """Returns a 4x4 index->world matrix."""
    map_type = r.name()
    m = np.eye(4, dtype=np.float64)
    if map_type in ("UniformScaleMap", "ScaleMap"):
        scale = r.f64(3)
        _voxel = r.f64(3)
        _inv = r.f64(3)
        _invsq = r.f64(3)
        _inv2 = r.f64(3)
        m[0, 0], m[1, 1], m[2, 2] = scale
    elif map_type in ("UniformScaleTranslateMap", "ScaleTranslateMap"):
        trans = r.f64(3)
        scale = r.f64(3)
        _voxel = r.f64(3)
        _inv = r.f64(3)
        _invsq = r.f64(3)
        _inv2 = r.f64(3)
        m[0, 0], m[1, 1], m[2, 2] = scale
        m[:3, 3] = trans
    elif map_type == "TranslationMap":
        m[:3, 3] = r.f64(3)
    elif map_type in ("AffineMap", "UnitaryMap"):
        mat = np.array(r.f64(16)).reshape(4, 4)
        m = mat.T  # OpenVDB uses row-vector convention (p' = p * M)
    else:
        raise ValueError(f"unsupported OpenVDB transform map: {map_type}")
    return m.astype(np.float32)


def _read_compressed_values(r: _Reader, n_values, dtype, compression, file_version, half):
    """io::readCompressedValues for float values. Returns (values, metadata)."""
    meta = NO_MASK_AND_ALL_VALS
    if file_version >= 222:  # OPENVDB_FILE_VERSION_NODE_MASK_COMPRESSION
        meta = r.read(1)[0]
        if meta == 0xFF:  # NO_MASK_AND_ALL_VALS marker for old files
            meta = NO_MASK_AND_ALL_VALS
    itemsize = 2 if half else 4
    np_dtype = np.float16 if half else np.float32

    inactive_vals = []
    if meta in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL, MASK_AND_TWO_INACTIVE_VALS):
        inactive_vals.append(np.frombuffer(r.read(itemsize), np_dtype)[0])
    if meta == MASK_AND_TWO_INACTIVE_VALS:
        inactive_vals.append(np.frombuffer(r.read(itemsize), np_dtype)[0])

    selection_mask = None
    if meta in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL, MASK_AND_TWO_INACTIVE_VALS):
        nbits = n_values
        selection_mask = np.unpackbits(
            np.frombuffer(r.read((nbits + 7) // 8), np.uint8), bitorder="little"
        )[:nbits].astype(bool)

    count = n_values
    if file_version >= 222 and meta != NO_MASK_AND_ALL_VALS and selection_mask is not None:
        count = n_values - int(selection_mask.sum())

    raw = _read_compressed_block(r, count * itemsize, compression)
    vals = np.frombuffer(raw, np_dtype, count).astype(np.float32)
    return vals, meta, inactive_vals, selection_mask


def _read_compressed_block(r: _Reader, n_bytes, compression):
    if compression & COMPRESS_BLOSC:
        # io::bloscFromStream framing: i64 compressed size (<= 0 means the
        # buffer was stored raw, -size bytes), then one blosc chunk
        csize = r.i64()
        if csize <= 0:
            return r.read(n_bytes)
        try:
            return blosc.decompress(r.read(csize))
        except Exception as e:  # codec errors -> uniform loader error
            raise ValueError(f"corrupt Blosc block in .vdb: {e}") from e
    if compression & COMPRESS_ZIP:
        csize = r.i64()
        if csize <= 0:
            return r.read(n_bytes)
        try:
            return zlib.decompress(r.read(csize))
        except zlib.error as e:
            raise ValueError(f"corrupt ZIP block in .vdb: {e}") from e
    return r.read(n_bytes)


def _expand_values(vals, meta, inactive_vals, selection_mask, n_values, background):
    """Scatter compressed actives back into the full value array."""
    if meta == NO_MASK_AND_ALL_VALS or selection_mask is None:
        out = np.full(n_values, background, np.float32)
        out[: len(vals)] = vals
        return out
    out = np.empty(n_values, np.float32)
    if meta == MASK_AND_NO_INACTIVE_VALS:
        fill0 = fill1 = background
    elif meta == MASK_AND_ONE_INACTIVE_VAL:
        fill0 = fill1 = np.float32(inactive_vals[0])
    else:  # MASK_AND_TWO_INACTIVE_VALS
        fill0, fill1 = np.float32(inactive_vals[0]), np.float32(inactive_vals[1])
    # selection mask bit set -> value was NOT stored; it is an inactive value
    # (-background or +background selected by ... simplified: single fill)
    out[selection_mask] = fill0
    out[~selection_mask] = 0  # placeholder, overwritten below
    np.place(out, ~selection_mask, vals)
    return out


def read_vdb(path: str, name: str = "density") -> DenseGrid:
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    magic = r.i64()
    if magic != MAGIC:
        raise ValueError(f"{path}: not an OpenVDB file")
    file_version = r.u32()
    if file_version < 220:
        raise ValueError(f"{path}: OpenVDB file version {file_version} too old (need >= 220)")
    _major, _minor = r.u32(), r.u32()
    has_offsets = r.boolean()
    file_compression = 0
    if 220 <= file_version < 222:
        file_compression = r.u32()
    # uuid: 36-char ascii since version 221
    r.read(36)
    _file_meta = _read_metamap(r)

    if not has_offsets:
        raise ValueError(f"{path}: .vdb without grid offsets unsupported")
    n_grids = r.u32()

    descriptors = []
    for _ in range(n_grids):
        unique_name = r.name()
        grid_type = r.name()
        half = grid_type.endswith("_HalfFloat")
        if half:
            grid_type = grid_type[: -len("_HalfFloat")]
        instance_parent = ""
        if file_version >= 219:  # OPENVDB_FILE_VERSION_GRID_INSTANCING
            instance_parent = r.name()
        grid_pos = r.i64()
        block_pos = r.i64()
        end_pos = r.i64()
        descriptors.append(
            dict(
                name=unique_name.split("\x1e")[0],
                unique=unique_name,
                type=grid_type,
                half=half,
                grid_pos=grid_pos,
                block_pos=block_pos,
                end_pos=end_pos,
            )
        )
        r.o = end_pos  # skip to next descriptor

    matches = [d for d in descriptors if d["name"] == name]
    if not matches:
        if len(descriptors) == 1:
            matches = descriptors
        else:
            avail = [d["name"] for d in descriptors]
            raise KeyError(f"{path}: grid {name!r} not found (available: {avail})")
    desc = matches[0]
    if desc["type"] != "Tree_float_5_4_3":
        raise ValueError(
            f"{path}: unsupported grid type {desc['type']} (only float 5-4-3 trees)"
        )
    return _read_float_grid(r, desc, file_version, file_compression)


def _read_float_grid(r: _Reader, desc, file_version, file_compression) -> DenseGrid:
    r.o = desc["grid_pos"]
    compression = file_compression
    if file_version >= 222:
        compression = r.u32()
    _grid_meta = _read_metamap(r)
    transform = _read_transform(r)
    half = desc["half"]

    # ---- tree topology ----
    _buffer_count = r.u32()
    background = np.frombuffer(r.read(2 if half else 4), np.float16 if half else np.float32)[0]
    background = np.float32(background)
    n_tiles = r.u32()
    n_children = r.u32()

    root_tiles = []
    for _ in range(n_tiles):
        xyz = struct.unpack("<3i", r.read(12))
        val = np.frombuffer(r.read(2 if half else 4), np.float16 if half else np.float32)[0]
        active = r.boolean()
        if active:
            root_tiles.append((xyz, np.float32(val)))

    leaves = []  # (origin, value_mask) collected during topology

    def read_internal(level_log2, child_log2, origin):
        """Read InternalNode topology. Returns list of (leaf_origin, mask)
        and tile boxes [(origin, size, value)]."""
        dim_log2 = level_log2
        n = 1 << (3 * dim_log2)
        child_mask = np.unpackbits(
            np.frombuffer(r.read(n // 8), np.uint8), bitorder="little"
        )[:n].astype(bool)
        value_mask = np.unpackbits(
            np.frombuffer(r.read(n // 8), np.uint8), bitorder="little"
        )[:n].astype(bool)
        # node tile values (compressed framework)
        vals, meta, inact, selmask = _read_compressed_values(
            r, n, np.float32, compression, file_version, half
        )
        tile_vals = _expand_values(vals, meta, inact, selmask, n, background)
        tiles = []
        child_dim = 1 << child_log2  # voxel span of one child
        idxs = np.nonzero(child_mask)[0]
        # tiles: active, non-child entries
        for i in np.nonzero(value_mask & ~child_mask)[0]:
            off = _offset_to_coord(int(i), dim_log2)
            tiles.append((tuple(origin + off * child_dim), child_dim, tile_vals[i]))
        children = []
        for i in idxs:
            off = _offset_to_coord(int(i), dim_log2)
            child_origin = origin + off * child_dim
            children.append((int(i), child_origin))
        return children, tiles

    all_tiles = []
    child_nodes2 = []  # upper internal nodes
    for _ in range(n_children):
        xyz = np.array(struct.unpack("<3i", r.read(12)), np.int64)
        kids2, tiles2 = read_internal(_INT2_LOG2, _INT1_LOG2 + _LEAF_LOG2 + 0, xyz)
        # child span of upper internal = 2^(4+3) = 128 voxels
        all_tiles.extend(tiles2)
        lower_list = []
        for _i, org1 in kids2:
            kids1, tiles1 = read_internal(_INT1_LOG2, _LEAF_LOG2, org1)
            all_tiles.extend(tiles1)
            for _j, org0 in kids1:
                mask = np.unpackbits(
                    np.frombuffer(r.read(64), np.uint8), bitorder="little"
                ).astype(bool)
                leaves.append([np.asarray(org0, np.int64), mask, None])
            lower_list.append(kids1)
        child_nodes2.append((xyz, kids2, lower_list))

    # ---- leaf buffers ----
    for leaf in leaves:
        origin, mask, _ = leaf
        if file_version < 222:
            mask2 = r.read(64)  # mask repeated in buffers for old versions
        vals, meta, inact, selmask = _read_compressed_values(
            r, 512, np.float32, compression, file_version, half
        )
        leaf[2] = _expand_values(vals, meta, inact, selmask, 512, background)

    # ---- densify ----
    if not leaves and not all_tiles and not root_tiles:
        raise ValueError("empty OpenVDB grid")
    mins = []
    maxs = []
    for origin, _, _ in leaves:
        mins.append(origin)
        maxs.append(origin + 8)
    for origin, size, _ in all_tiles:
        mins.append(np.asarray(origin, np.int64))
        maxs.append(np.asarray(origin, np.int64) + size)
    bb_min = np.min(mins, axis=0)
    bb_max = np.max(maxs, axis=0)
    nx, ny, nz = (bb_max - bb_min).astype(int)
    # allocation guard: node origins are file-controlled — a corrupted
    # coordinate must raise, not exhaust memory (loader fuzz pass)
    if int(nx) * int(ny) * int(nz) > 512 * 1024 * 1024:
        raise ValueError(
            f"OpenVDB active bbox {nx}x{ny}x{nz} too large to densify "
            "(corrupted node table?)")
    dense = np.zeros((nz, ny, nx), np.float32)
    for origin, size, val in all_tiles:
        o = np.asarray(origin, np.int64) - bb_min
        dense[o[2] : o[2] + size, o[1] : o[1] + size, o[0] : o[0] + size] = val
    for origin, mask, vals in leaves:
        block = np.where(mask, vals, 0.0).reshape(8, 8, 8)  # (x, y, z)
        block = block.transpose(2, 1, 0)
        o = origin - bb_min
        dense[o[2] : o[2] + 8, o[1] : o[1] + 8, o[0] : o[0] + 8] = block

    t = np.asarray(transform, np.float64)
    full = np.eye(4, dtype=np.float64)
    full[:3, :3] = t[:3, :3]
    full[:3, 3] = t[:3, :3] @ bb_min + t[:3, 3]
    return DenseGrid(int(nx), int(ny), int(nz), dense, full.astype(np.float32))


def _offset_to_coord(offset: int, dim_log2: int) -> np.ndarray:
    """Invert InternalNode::coordToOffset: offset = ((x << L) | y) << L | z
    per-axis local indices, x slowest."""
    d = dim_log2
    z = offset & ((1 << d) - 1)
    y = (offset >> d) & ((1 << d) - 1)
    x = offset >> (2 * d)
    return np.array([x, y, z], np.int64)


# ----------------------------------------------------------------------------
# writer (round-trip testing + migration path)
# ----------------------------------------------------------------------------


def write_vdb(path: str, dense_zyx: np.ndarray, name: str = "density",
              transform: np.ndarray | None = None,
              compression: str = "zip", half: bool = False) -> None:
    """Write a dense (z, y, x) float32 array as a minimal OpenVDB file
    (file version 220, ZIP or BLOSC value compression, float 5-4-3 tree;
    all leaves dense, origin at index (0,0,0)). The bytes equal
    volren_tpu.voldata.vdb_reader.write_vdb's for ``half=False``;
    ``half=True`` stores the values as half floats (a ``_HalfFloat``
    grid)."""
    write_vdb_grids(path, [(name, dense_zyx, transform)], compression, half)


def write_vdb_grids(path: str, grids, compression: str = "zip",
                    half: bool = False) -> None:
    """``write_vdb`` for several grids in one file: ``grids`` is a list of
    (name, dense (z, y, x) array, 4x4 transform or None), written in that
    order. A half-float grid keeps the reader's layout: its background
    and tile values take 2 bytes each, like its leaf values."""
    if compression not in ("zip", "blosc", "none"):
        raise ValueError(f"compression must be zip/blosc/none, got {compression!r}")
    file_compression = {
        "zip": COMPRESS_ZIP,
        "blosc": COMPRESS_BLOSC,
        "none": COMPRESS_NONE,
    }[compression]
    value_dtype = np.float16 if half else np.float32

    def pack_values(payload: bytes) -> bytes:
        # io::zipToStream / bloscToStream framing: i64 size + buffer,
        # negative size = stored raw
        if compression == "blosc":
            comp = blosc.compress(payload, typesize=2 if half else 4)
        elif compression == "zip":
            comp = zlib.compress(payload)
        else:
            return payload  # COMPRESS_NONE: raw values, no size framing
        if len(comp) >= len(payload):
            return struct.pack("<q", -len(payload)) + payload
        return struct.pack("<q", len(comp)) + comp

    out = bytearray()

    def w(fmt, *vals):
        out.extend(struct.pack(fmt, *vals))

    def wname(s):
        b = s.encode()
        w("<I", len(b))
        out.extend(b)

    w("<q", MAGIC)
    w("<I", 220)  # file version (file-scope compression field era)
    w("<II", 8, 1)  # library version
    w("<B", 1)  # has grid offsets
    w("<I", file_compression)  # file-scope compression
    out.extend(b"0" * 36)  # uuid
    w("<I", 0)  # file metadata count
    w("<I", len(grids))  # grid count

    for name, dense_zyx, transform in grids:
        dense = np.asarray(dense_zyx, np.float32)
        Z, Y, X = dense.shape
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        t = np.asarray(transform, np.float64)
        if not np.allclose(t[:3, :3], np.diag(np.diag(t[:3, :3]))):
            raise ValueError("write_vdb supports axis-aligned transforms only")
        scale = np.diag(t[:3, :3])
        trans = t[:3, 3]

        wname(name)
        wname("Tree_float_5_4_3" + ("_HalfFloat" if half else ""))
        wname("")  # instance parent
        offsets_pos = len(out)
        w("<qqq", 0, 0, 0)  # grid/block/end pos placeholders

        grid_pos = len(out)
        # grid meta
        w("<I", 0)
        # transform
        wname("ScaleTranslateMap")
        for vec in (trans, scale, scale, 1.0 / scale, 1.0 / (scale * scale), 0.5 / scale):
            w("<3d", *np.asarray(vec, np.float64))

        w("<I", 1)  # buffer count
        out.extend(np.zeros(1, value_dtype).tobytes())  # background
        w("<I", 0)  # root tiles
        # collect leaves on the 8-grid
        leaf_origins = [
            (x, y, z)
            for z in range(0, Z, 8)
            for y in range(0, Y, 8)
            for x in range(0, X, 8)
        ]
        # group leaves under lower (16 leaves = 128 voxels a side) and
        # upper (4096 voxels) nodes
        upper = {}
        for lx, ly, lz in leaf_origins:
            uo = (lx >> 12 << 12, ly >> 12 << 12, lz >> 12 << 12)
            lo = (lx >> 7 << 7, ly >> 7 << 7, lz >> 7 << 7)
            upper.setdefault(uo, {}).setdefault(lo, []).append((lx, ly, lz))
        w("<I", len(upper))  # root children

        def mask_bits(nbits, idxs):
            m = np.zeros(nbits, np.uint8)
            m[list(idxs)] = 1
            return np.packbits(m, bitorder="little").tobytes()

        def coord_to_offset(local, d):
            x, y, z = local
            return ((x << d) | y) << d | z

        def write_tile_values(n):
            # version 220 < 222: no per-node metadata byte; one value block
            out.extend(pack_values(np.zeros(n, value_dtype).tobytes()))

        ordered_leaves = []
        for uo, lowers in upper.items():
            w("<3i", *uo)
            # upper internal (32^3)
            lower_idx = {}
            for lo in lowers:
                local = tuple(((np.array(lo) - np.array(uo)) >> 7).tolist())
                lower_idx[coord_to_offset(local, _INT2_LOG2)] = lo
            n2 = 1 << (3 * _INT2_LOG2)
            out.extend(mask_bits(n2, lower_idx.keys()))  # child mask
            out.extend(mask_bits(n2, []))  # value mask
            write_tile_values(n2)
            for off in sorted(lower_idx):
                lo = lower_idx[off]
                leaves_in = lowers[lo]
                leaf_idx = {}
                for lf in leaves_in:
                    local = tuple(((np.array(lf) - np.array(lo)) >> 3).tolist())
                    leaf_idx[coord_to_offset(local, _INT1_LOG2)] = lf
                n1 = 1 << (3 * _INT1_LOG2)
                out.extend(mask_bits(n1, leaf_idx.keys()))
                out.extend(mask_bits(n1, []))
                write_tile_values(n1)
                for loff in sorted(leaf_idx):
                    lf = leaf_idx[loff]
                    out.extend(b"\xff" * 64)  # leaf value mask: all active
                    ordered_leaves.append(lf)

        block_pos = len(out)
        # leaf buffers (file version 220 < 222: mask repeated, no metadata byte)
        for lx, ly, lz in ordered_leaves:
            block = np.zeros((8, 8, 8), np.float32)
            sz = min(8, Z - lz)
            sy = min(8, Y - ly)
            sx = min(8, X - lx)
            block[:sz, :sy, :sx] = dense[lz : lz + sz, ly : ly + sy, lx : lx + sx]
            out.extend(b"\xff" * 64)
            # (x, y, z) order
            payload = block.transpose(2, 1, 0).reshape(-1).astype(value_dtype).tobytes()
            out.extend(pack_values(payload))
        end_pos = len(out)
        struct.pack_into("<qqq", out, offsets_pos, grid_pos, block_pos, end_pos)
    with open(path, "wb") as f:
        f.write(bytes(out))
