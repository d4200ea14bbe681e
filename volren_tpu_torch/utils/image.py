"""LDR image output: PNG written with zlib and struct only (no imaging
library), the counterpart of volren_tpu.utils.image.save_ldr."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(u8: np.ndarray) -> bytes:
    """An (H, W, 3|4) uint8 image as the bytes of an 8-bit RGB or RGBA
    PNG."""
    u8 = np.ascontiguousarray(u8, dtype=np.uint8)
    h, w, c = u8.shape
    if c not in (3, 4):
        raise ValueError(f"PNG needs 3 or 4 channels, got {c}")
    # every scanline carries filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, u8: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 image as an 8-bit RGB or RGBA PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(u8))


def save_ldr(path: str, img: np.ndarray, flip: bool = True, alpha: bool = False) -> None:
    """Save a float image in [0,1] (H, W, 3|4) as PNG. ``flip`` mirrors the
    GL framebuffer convention (row 0 = bottom)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if not alpha and img.shape[-1] == 4:
        img = img[..., :3]
    if flip:
        img = img[::-1]
    u8 = np.clip(np.nan_to_num(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_png(path, u8)


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes with its PNG filter (None, Sub, Up, Average,
    Paeth) undone, against the previous reconstructed line."""
    if kind == 0:
        return line
    if kind == 2:
        return line + prev
    if kind == 1:   # Sub: a running sum per byte of a pixel
        px = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    out = np.zeros(line.shape[0] + bpp, np.int64)
    up = prev.astype(np.int64)
    cur = line.astype(np.int64)
    for i in range(0, line.shape[0], bpp):
        a = out[i:i + bpp]                       # left (zeros before the line)
        b = up[i:i + bpp]
        if kind == 3:
            v = cur[i:i + bpp] + ((a + b) >> 1)
        elif kind == 4:
            c = up[i - bpp:i] if i >= bpp else np.zeros(bpp, np.int64)
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            v = cur[i:i + bpp] + pred
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[i + bpp:i + 2 * bpp] = v & 0xFF
    return out[bpp:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced grey, grey+alpha, RGB or RGBA PNG (what
    write_png and common image libraries write) as an (H, W, C) uint8
    array, C = 1, 2, 3 or 4, rows top first."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _comp, _filt, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are read "
                         f"(depth {depth}, colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    rows = np.zeros((h, w * channels), np.uint8)
    prev = np.zeros(w * channels, np.uint8)
    for y in range(h):
        prev = rows[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, channels)
    return rows.reshape(h, w, channels)
