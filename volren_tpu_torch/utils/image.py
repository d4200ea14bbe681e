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
