"""DICOM CT series reader (copy of volren_tpu.voldata.dicom).

Reference capability: voldata's Imebra-backed DICOMGrid (README.md:37-40).
This is a from-scratch minimal parser for uncompressed DICOM part-10 files
(explicit and implicit VR, little endian): enough to load CT slice series
into a dense grid with rescale slope/intercept applied and values normalized
to [0, 1] (the reference renders DICOM through the transfer-function path,
which windows normalized density).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .grid import DenseGrid

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}


def _parse_dicom_file(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[128:132] != b"DICM":
        raise ValueError(f"{path}: missing DICM preamble")
    pos = 132

    def read_elements(pos, explicit, limit):
        elems = {}
        while pos < limit:
            group, elem = struct.unpack_from("<HH", raw, pos)
            pos += 4
            if explicit and group != 0xFFFE:
                vr = raw[pos : pos + 2]
                if vr in _EXPLICIT_LONG_VRS:
                    (length,) = struct.unpack_from("<I", raw, pos + 4)
                    pos += 8
                else:
                    (length,) = struct.unpack_from("<H", raw, pos + 2)
                    pos += 4
            else:
                vr = b"UN"
                (length,) = struct.unpack_from("<I", raw, pos)
                pos += 4
            if length == 0xFFFFFFFF:
                raise ValueError("undefined-length elements (compressed pixel data?) unsupported")
            elems[(group, elem)] = (vr, raw[pos : pos + length])
            pos += length
            if (group, elem) == (0x7FE0, 0x0010):
                break
        return elems

    # file meta group (always explicit VR LE)
    (g, e) = struct.unpack_from("<HH", raw, pos)
    meta_len = 0
    transfer_syntax = "1.2.840.10008.1.2.1"
    if g == 0x0002:
        meta = read_elements(pos, True, len(raw))
        # meta group length
        if (0x0002, 0x0000) in meta:
            meta_len = struct.unpack("<I", meta[(0x0002, 0x0000)][1])[0]
        if (0x0002, 0x0010) in meta:
            transfer_syntax = meta[(0x0002, 0x0010)][1].rstrip(b"\x00 ").decode()
        # skip to end of meta group
        pos2 = pos
        # re-scan to find first non-0x0002 group
        while pos2 < len(raw):
            gg = struct.unpack_from("<H", raw, pos2)[0]
            if gg != 0x0002:
                break
            vr = raw[pos2 + 4 : pos2 + 6]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", raw, pos2 + 8)
                pos2 += 12 + length
            else:
                (length,) = struct.unpack_from("<H", raw, pos2 + 6)
                pos2 += 8 + length
        pos = pos2
    if transfer_syntax == "1.2.840.10008.1.2":
        explicit = False
    elif transfer_syntax in ("1.2.840.10008.1.2.1", "1.2.840.10008.1.2.2"):
        explicit = True
        if transfer_syntax.endswith(".2"):
            raise ValueError("big-endian DICOM unsupported")
    else:
        raise ValueError(f"{path}: compressed transfer syntax {transfer_syntax} unsupported")

    elems = read_elements(pos, explicit, len(raw))

    def get_str(tag, default=None):
        if tag not in elems:
            return default
        return elems[tag][1].rstrip(b"\x00 ").decode("ascii", "replace")

    def get_int(tag, default=None):
        if tag not in elems:
            return default
        vr, val = elems[tag]
        if vr == b"US" or (vr == b"UN" and len(val) == 2):
            return struct.unpack("<H", val)[0]
        return int(get_str(tag, str(default)))

    rows = get_int((0x0028, 0x0010))
    cols = get_int((0x0028, 0x0011))
    bits = get_int((0x0028, 0x0100), 16)
    signed = get_int((0x0028, 0x0103), 0) == 1
    slope = float(get_str((0x0028, 0x1053), "1") or 1)
    intercept = float(get_str((0x0028, 0x1052), "0") or 0)
    spacing = get_str((0x0028, 0x0030), "1\\1")
    dy, dx = (float(v) for v in spacing.split("\\")[:2])
    dz = float(get_str((0x0018, 0x0050), "1") or 1)  # slice thickness
    ipp = get_str((0x0020, 0x0032), "0\\0\\0")
    z_pos = float(ipp.split("\\")[2]) if ipp else 0.0
    inst = get_int((0x0020, 0x0013), 0)
    pixel = elems.get((0x7FE0, 0x0010))
    if pixel is None or rows is None or cols is None:
        raise ValueError(f"{path}: no pixel data")
    dt = {8: np.uint8, 16: np.int16 if signed else np.uint16, 32: np.int32}[bits]
    img = np.frombuffer(pixel[1], dtype=dt, count=rows * cols).reshape(rows, cols)
    values = img.astype(np.float32) * slope + intercept
    return {
        "values": values,
        "z": z_pos,
        "instance": inst,
        "spacing": (dx, dy, dz),
    }


def read_dicom(path: str) -> DenseGrid:
    """Load a DICOM series: ``path`` is a single .dcm file or a directory of
    slices (ordered by image position / instance number)."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith((".dcm", ".dicom")) or "." not in f
        )
    else:
        files = [path]
    slices = []
    for f in files:
        try:
            slices.append(_parse_dicom_file(f))
        except ValueError:
            continue
    if not slices:
        raise RuntimeError(f"no readable DICOM slices in {path}")
    slices.sort(key=lambda s: (s["z"], s["instance"]))
    vol = np.stack([s["values"] for s in slices], axis=0)  # (z, y, x)
    # normalize to [0, 1] for the transfer-function path
    lo, hi = float(vol.min()), float(vol.max())
    vol = (vol - lo) / max(hi - lo, 1e-8)
    dx, dy, dz = slices[0]["spacing"]
    if len(slices) > 1:
        dz = abs(slices[1]["z"] - slices[0]["z"]) or dz
    nz, ny, nx = vol.shape
    transform = np.diag([dx, dy, dz, 1.0]).astype(np.float32)
    return DenseGrid(nx, ny, nz, vol, transform)
