"""The port's volume loaders (volren_tpu_torch.voldata: blosc/LZ4, OpenVDB,
NanoVDB, DICOM, load_grid, Volume.load_folder) against volren_tpu.voldata
on small synthetic files: codec and writer bytes, and every reader's
arrays and transforms, bitwise."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from volren_tpu.voldata import blosc as jblosc
from volren_tpu.voldata import dicom as jdicom
from volren_tpu.voldata import nanovdb as jnanovdb
from volren_tpu.voldata import vdb_reader as jvdb
from volren_tpu.voldata.volume import Volume as JVolume
from volren_tpu.voldata.volume import load_grid as jload_grid
from volren_tpu_torch.voldata import DenseGrid, Volume, blosc, dicom, load_grid, nanovdb
from volren_tpu_torch.voldata import vdb_reader as tvdb
from volren_tpu_torch.voldata.brick_io import write_dense

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

READERS = (jvdb.read_vdb, tvdb.read_vdb)


def _same_grid(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.data.dtype == theirs.data.dtype and np.array_equal(ours.data, theirs.data)
    assert np.array_equal(np.asarray(ours.transform), np.asarray(theirs.transform))
    assert ours.to_string() == theirs.to_string()


def _dense(seed, shape=(12, 19, 9)):
    rng = np.random.default_rng(seed)
    dense = (rng.random(shape) * 4).astype(np.float32)
    dense[dense < 1.0] = 0.0
    return dense


# ---- blosc / LZ4 ----

PAYLOADS = [
    b"",
    b"abc",
    np.arange(4096, dtype=np.float32).tobytes(),
    np.random.default_rng(7).integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
    (np.random.default_rng(8).random(2048).astype(np.float32) * 0.01).tobytes(),
]


@pytest.mark.parametrize("split", [None, True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_blosc_bytes_and_cross_decode(shuffle, split):
    for data in PAYLOADS:
        ours = blosc.compress(data, typesize=4, shuffle=shuffle, split=split, blocksize=8192)
        theirs = jblosc.compress(data, typesize=4, shuffle=shuffle, split=split, blocksize=8192)
        assert ours == theirs
        assert jblosc.decompress(ours) == data and blosc.decompress(theirs) == data


def test_lz4_bytes_and_cross_decode():
    cases = [b"", b"x" * 4, b"abcd" * 1000, b"ab" * 5000, bytes(range(256)) * 17,
             PAYLOADS[3]]
    for data in cases:
        ours, theirs = blosc.lz4_compress(data), jblosc.lz4_compress(data)
        assert ours == theirs
        assert jblosc.lz4_decompress(ours, len(data)) == data
        assert blosc.lz4_decompress(theirs, len(data)) == data


# ---- OpenVDB ----

@pytest.mark.parametrize("compression", ["zip", "blosc", "none"])
def test_write_vdb_bytes_match_reference(tmp_path, compression):
    dense = _dense(3)
    t = np.diag([0.5, 0.25, 2.0, 1.0]).astype(np.float32)
    t[:3, 3] = [1, 2, 3]
    ours, theirs = str(tmp_path / "ours.vdb"), str(tmp_path / "theirs.vdb")
    tvdb.write_vdb(ours, dense, "density", t, compression=compression)
    jvdb.write_vdb(theirs, dense, "density", t, compression=compression)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        _same_grid(tvdb.read_vdb(path), jvdb.read_vdb(path))


@pytest.mark.parametrize("compression", ["zip", "blosc", "none"])
def test_half_float_vdb_reads_alike(tmp_path, compression):
    """A ``_HalfFloat`` grid: both readers give the same float32 values (the
    written values rounded to half) and transform."""
    dense = _dense(4)
    path = str(tmp_path / "half.vdb")
    tvdb.write_vdb(path, dense, "density", np.diag([2.0, 2.0, 2.0, 1.0]), compression, half=True)
    ours, theirs = tvdb.read_vdb(path), jvdb.read_vdb(path)
    _same_grid(ours, theirs)
    z, y, x = dense.shape
    assert np.array_equal(ours.data[:z, :y, :x], dense.astype(np.float16).astype(np.float32))


def test_multi_grid_vdb_reads_alike(tmp_path):
    """write_vdb_grids: each named grid of one file, read by both readers;
    a name the file lacks raises KeyError in both."""
    density, temp = _dense(5, (16, 16, 24)), _dense(6, (8, 8, 16))
    path = str(tmp_path / "two.vdb")
    tvdb.write_vdb_grids(path, [("density", density, None),
                                ("temperature", temp, np.diag([2.0, 2.0, 2.0, 1.0]))])
    for name, want in (("density", density), ("temperature", temp)):
        ours, theirs = tvdb.read_vdb(path, name), jvdb.read_vdb(path, name)
        _same_grid(ours, theirs)
        assert np.array_equal(ours.data, want)
    for read in READERS:
        with pytest.raises(KeyError):
            read(path, "flame")


# ---- NanoVDB: the minimal file of tests/test_loaders.py ----

def _build_min_nvdb(path, codec=0):
    """Hand-assemble a minimal NanoVDB file: file header + FileMetaData +
    one float grid whose payload is GridData(672 B) + TreeData + a single
    8^3 leaf at index origin (8,16,24) (public NanoVDB v32 ABI)."""
    leaf_vals = np.arange(512, dtype=np.float32) / 512.0
    mask = np.zeros(512, dtype=bool)
    mask[::3] = True
    leaf = struct.pack("<3i", 8, 16, 24) + bytes([7, 7, 7, 0])
    leaf += np.packbits(mask, bitorder="little").tobytes()
    leaf += struct.pack("<4f", leaf_vals.min(), leaf_vals.max(), 0.0, 0.0)
    leaf += leaf_vals.tobytes()
    grid_data = bytearray(672)
    struct.pack_into("<Q", grid_data, 16, 672 + 48 + len(leaf))
    vox = 0.5
    struct.pack_into("<9d", grid_data, 264 + 88, vox, 0, 0, 0, vox, 0, 0, 0, vox)
    struct.pack_into("<3d", grid_data, 264 + 88 + 144, 1.0, 2.0, 3.0)
    tree = bytearray(48)
    struct.pack_into("<Q", tree, 0, 48)
    struct.pack_into("<I", tree, 32, 1)
    payload = bytes(grid_data) + bytes(tree) + leaf
    if codec == 1:
        z = zlib.compress(payload)
        payload = struct.pack("<Q", len(z)) + z
    elif codec == 2:
        c = blosc.compress(payload, typesize=4)
        payload = struct.pack("<Q", len(c)) + c
    name = b"density\x00"
    meta = bytearray(180)
    struct.pack_into("<QQQQII", meta, 0, 672 + 48 + len(leaf), len(payload), 0,
                     int(mask.sum()), 1, 1)
    struct.pack_into("<6d", meta, 40, 4.0, 8.0, 12.0, 8.0, 12.0, 16.0)
    struct.pack_into("<6i", meta, 88, 8, 16, 24, 15, 23, 31)
    struct.pack_into("<3d", meta, 112, vox, vox, vox)
    struct.pack_into("<I", meta, 136, len(name))
    struct.pack_into("<4I", meta, 140, 1, 0, 0, 0)
    struct.pack_into("<HHI", meta, 172, codec, 0, 32 << 21)
    header = struct.pack("<QIHH", 0x324244566F6E614E, 32, 1, codec)
    with open(path, "wb") as f:
        f.write(header + bytes(meta) + name + payload)
    return leaf_vals, mask


@pytest.mark.parametrize("codec", [0, 1, 2], ids=["raw", "zip", "blosc"])
def test_nanovdb_reads_alike(tmp_path, codec):
    path = str(tmp_path / "min.nvdb")
    vals, mask = _build_min_nvdb(path, codec)
    ours, theirs = nanovdb.read_nanovdb(path), jnanovdb.read_nanovdb(path)
    _same_grid(ours, theirs)
    expect = np.where(mask, vals, 0.0).reshape(8, 8, 8).transpose(2, 1, 0)
    assert np.array_equal(ours.data, expect)
    _same_grid(load_grid(path), jload_grid(path))


# ---- DICOM: a synthetic series as in tests/test_loaders.py ----

def _write_synthetic_dicom(path, rows, cols, values, z, instance):
    """Minimal explicit-VR little-endian CT slice."""
    def elem(group, el, vr, val):
        if vr in (b"OB", b"OW"):
            return struct.pack("<HH2sH I", group, el, vr, 0, len(val)) + val
        return struct.pack("<HH2sH", group, el, vr, len(val)) + val

    meta = elem(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00")
    body = elem(0x0018, 0x0050, b"DS", b"2.5 ")
    body += elem(0x0020, 0x0013, b"IS", str(instance).encode() + b" ")
    body += elem(0x0020, 0x0032, b"DS", f"0\\0\\{z}".encode())
    body += elem(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    body += elem(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    body += elem(0x0028, 0x0030, b"DS", b"0.7\\0.7 ")
    body += elem(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += elem(0x0028, 0x0103, b"US", struct.pack("<H", 1))
    body += elem(0x0028, 0x1052, b"DS", b"-1024 ")
    body += elem(0x0028, 0x1053, b"DS", b"1 ")
    body += elem(0x7FE0, 0x0010, b"OW", values.astype("<i2").tobytes())
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def test_dicom_series_and_file_read_alike(tmp_path):
    rng = np.random.default_rng(2)
    series = tmp_path / "series"
    series.mkdir()
    for i, z in enumerate([5.0, 0.0, 2.5]):  # unsorted on purpose
        vals = (rng.random((4, 6)) * 2000 - 500).astype(np.int16)
        _write_synthetic_dicom(str(series / f"s{i}.dcm"), 4, 6, vals, z, i)
    ours, theirs = dicom.read_dicom(str(series)), jdicom.read_dicom(str(series))
    _same_grid(ours, theirs)
    assert ours.to_dense().shape == (3, 4, 6)
    _same_grid(load_grid(str(series)), jload_grid(str(series)))
    one = str(series / "s1.dcm")
    _same_grid(load_grid(one), jload_grid(one))
    _same_grid(Volume(one).current_grid(), JVolume(one).current_grid())


# ---- garbage ----

@pytest.mark.parametrize("ext", [".vdb", ".nvdb", ".dcm", ".brick", ".xyz"])
def test_garbage_is_rejected_alike(tmp_path, ext):
    path = str(tmp_path / f"bad{ext}")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64 if ext == ".vdb" else b"not a volume file at all........")
    with pytest.raises(Exception) as ours:
        load_grid(path)
    with pytest.raises(Exception) as theirs:
        jload_grid(path)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


# ---- load_folder ----

def test_load_folder_matches_reference(tmp_path):
    """Alphanumeric frame order, hidden files and subfolders skipped,
    multi-grid VDB frames with and without an emission grid, a single-grid
    VDB and a .dense frame (single-grid formats answer every name)."""
    folder = tmp_path / "anim"
    folder.mkdir()
    (folder / "sub").mkdir()
    (folder / ".hidden.vdb").write_bytes(b"junk")
    (folder / "notes.txt").write_text("not a grid")
    tvdb.write_vdb_grids(str(folder / "f10.vdb"), [("density", _dense(1, (8, 16, 8)), None),
                                                   ("temperature", _dense(2, (8, 8, 8)),
                                                    np.diag([2.0, 2.0, 2.0, 1.0]))])
    tvdb.write_vdb_grids(str(folder / "f2.vdb"), [("density", _dense(3, (8, 16, 8)), None),
                                                  ("mask", _dense(4, (8, 8, 8)), None)])
    tvdb.write_vdb(str(folder / "f1.vdb"), _dense(5, (8, 16, 8)))
    write_dense(str(folder / "f3.dense"), DenseGrid(8, 16, 8, _dense(6, (8, 16, 8))))
    ours, theirs = Volume.load_folder(str(folder)), JVolume.load_folder(str(folder))
    assert ours.n_grid_frames() == theirs.n_grid_frames() == 4
    for a, b in zip(ours.grids, theirs.grids):
        assert list(a) == list(b)
        for name in a:
            _same_grid(a[name], b[name])
    assert [sorted(f) for f in ours.grids] == [
        ["density", "flame", "flames", "temperature"], ["density"],
        ["density", "flame", "flames", "temperature"], ["density", "temperature"]]
    assert ours.to_string() == theirs.to_string() and repr(ours) == repr(theirs)
    empty = tmp_path / "empty"
    empty.mkdir()
    for vol in (Volume, JVolume):
        with pytest.raises(RuntimeError, match="no loadable grids"):
            vol.load_folder(str(empty))


def test_volume_of_a_vdb_path(tmp_path):
    path = str(tmp_path / "v.vdb")
    dense = np.zeros((8, 8, 8), np.float32)
    dense[2:6, 2:6, 2:6] = 3.0
    tvdb.write_vdb(path, dense)
    ours, theirs = Volume(path), JVolume(path)
    _same_grid(ours.current_grid(), theirs.current_grid())
    assert ours.minorant_majorant() == theirs.minorant_majorant() == (0.0, 3.0)
    assert os.path.getsize(path) > 0
