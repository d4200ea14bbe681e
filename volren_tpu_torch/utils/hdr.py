"""Radiance (.hdr / RGBE) image IO.

The reference loads equirectangular HDR environment maps through cppgl's
``Texture2D(name, path)`` (stb_image backed; see call site
reference src/environment.cpp:9). Neither stb nor a float-capable
imageio plugin is available here, so this is a from-scratch pure-numpy
implementation of the Radiance picture format (RGBE, with new-style RLE
scanlines) — loader and writer.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_hdr", "write_hdr", "rgbe_to_float", "float_to_rgbe"]


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """Convert (..., 4) uint8 RGBE to (..., 3) float32 RGB."""
    rgbe = rgbe.astype(np.float32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0.0, 0.0, np.exp2(exp - (128.0 + 8.0)))
    return rgbe[..., :3] * scale[..., None]


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """Convert (..., 3) float RGB to (..., 4) uint8 RGBE."""
    rgb = np.asarray(rgb, dtype=np.float32)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    valid = maxc >= 1e-32
    # frexp: maxc = frac * 2**exp with frac in [0.5, 1)
    frac, exp = np.frexp(np.where(valid, maxc, 1.0))
    scale = frac * 256.0 / np.where(valid, maxc, 1.0)
    mantissa = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = np.where(valid[..., None], mantissa, 0)
    out[..., 3] = np.where(valid, (exp + 128).astype(np.uint8), 0)
    return out


def _decode_rle_scanline(data: memoryview, pos: int, width: int) -> tuple[np.ndarray, int]:
    """Decode one new-style RLE scanline. Returns ((width, 4) uint8, new pos)."""
    scan = np.empty((4, width), dtype=np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            count = data[pos]
            pos += 1
            if count > 128:  # run
                run_len = count - 128
                scan[c, x : x + run_len] = data[pos]
                pos += 1
                x += run_len
            else:  # literal dump
                scan[c, x : x + count] = np.frombuffer(data, np.uint8, count, pos)
                pos += count
                x += count
    return scan.T.copy(), pos


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file into a (H, W, 3) float32 array.

    Row 0 is the top of the image (follows the ``-Y H +X W`` resolution line).
    """
    with open(path, "rb") as f:
        raw = f.read()

    # ---- header ----
    pos = raw.find(b"\n\n")
    if pos < 0:
        raise ValueError(f"{path}: missing HDR header terminator")
    header = raw[:pos].decode("ascii", errors="replace")
    if not (header.startswith("#?RADIANCE") or header.startswith("#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    fmt_ok = any(
        line.strip() == "FORMAT=32-bit_rle_rgbe" for line in header.splitlines()
    )
    if not fmt_ok:
        raise ValueError(f"{path}: unsupported FORMAT (need 32-bit_rle_rgbe)")
    pos += 2

    # ---- resolution line ----
    eol = raw.index(b"\n", pos)
    res_line = raw[pos:eol].decode("ascii").split()
    pos = eol + 1
    if len(res_line) != 4 or res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"{path}: unsupported resolution line {res_line!r}")
    height, width = int(res_line[1]), int(res_line[3])

    data = memoryview(raw)
    rows = np.empty((height, width, 4), dtype=np.uint8)
    for y in range(height):
        # peek at scanline type
        if (
            width >= 8
            and width < 32768
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((data[pos + 2] << 8) | data[pos + 3]) == width
        ):
            rows[y], pos = _decode_rle_scanline(data, pos + 4, width)
        else:
            # flat RGBE pixels (possibly with old-style RLE; treat literally,
            # expanding 1,1,1,n repeat records)
            row = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            if np.any((row[:, 0] == 1) & (row[:, 1] == 1) & (row[:, 2] == 1)):
                # old-style RLE needs sequential decode
                out = np.empty((width, 4), dtype=np.uint8)
                xi = 0
                shift = 0
                while xi < width:
                    px = np.frombuffer(data, np.uint8, 4, pos)
                    pos += 4
                    if px[0] == 1 and px[1] == 1 and px[2] == 1:
                        rep = int(px[3]) << shift
                        out[xi : xi + rep] = out[xi - 1]
                        xi += rep
                        shift += 8
                    else:
                        out[xi] = px
                        xi += 1
                        shift = 0
                rows[y] = out
            else:
                rows[y] = row
                pos += width * 4
    return rgbe_to_float(rows)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a (H, W, 3) float array as an uncompressed Radiance .hdr file."""
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w = rgb.shape[:2]
    rgbe = float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())
