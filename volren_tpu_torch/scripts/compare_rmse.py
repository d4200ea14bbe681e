"""RMSE / PSNR between two renders (the port of scripts/compare_rmse.py).

Reads 8-bit PNGs (volren_tpu_torch.utils.image.read_png), Radiance .hdr
files, ``.npy`` arrays and ``.npz`` checkpoints (their ``framebuffer``).

Usage: python -m volren_tpu_torch.scripts.compare_rmse a.png b.png
       [--flip-a] [--flip-b] [--resize-b]

Exits 0 when the relative RMSE is below 1%, else 1.
"""

import argparse
import sys

import numpy as np

from ..utils.hdr import read_hdr
from ..utils.image import read_png


def load_any(path: str) -> np.ndarray:
    """An (H, W, 3) float32 image."""
    if path.endswith(".npz"):
        return np.load(path)["framebuffer"][..., :3].astype(np.float32)
    if path.endswith(".npy"):
        return np.load(path)[..., :3].astype(np.float32)
    if path.endswith(".hdr"):
        return read_hdr(path)
    img = read_png(path)
    if img.shape[-1] < 3:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].astype(np.float32) / 255.0


PRECISION_BITS = 22   # PIL's fixed-point resampling coefficients (32 - 8 - 2)


def _box_coeffs(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) fixed-point weights of PIL's BOX filter: output pixel i
    averages the input pixels whose centres fall in (i * s, (i + 1) * s],
    s = n_in / n_out."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 0.5 * filterscale
    coeffs = np.zeros((n_out, n_in), np.int64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        t = (np.arange(lo, hi) - center + 0.5) / filterscale
        w = ((t > -0.5) & (t <= 0.5)).astype(np.float64)
        w = w / w.sum() if w.sum() else w
        coeffs[i, lo:hi] = np.where(w < 0, np.trunc(w * (1 << PRECISION_BITS) - 0.5),
                                    np.trunc(w * (1 << PRECISION_BITS) + 0.5))
    return coeffs


def _pass(u8: np.ndarray, coeffs: np.ndarray, axis: int) -> np.ndarray:
    acc = np.tensordot(coeffs, u8.astype(np.int64), axes=([1], [axis]))
    acc = np.moveaxis(acc, 0, axis) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def box_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Box-filter an (H, W, 3) image in [0, 1] to (height, width) as the
    JAX script does through PIL's ``Image.BOX`` on its 8-bit image: a
    horizontal pass, rounded to 8 bits, then a vertical one."""
    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if u8.shape[1] != width:
        u8 = _pass(u8, _box_coeffs(u8.shape[1], width), 1)
    if u8.shape[0] != height:
        u8 = _pass(u8, _box_coeffs(u8.shape[0], height), 0)
    return u8.astype(np.float32) / 255.0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("image_a")
    p.add_argument("image_b")
    p.add_argument("--flip-a", action="store_true", help="flip A vertically")
    p.add_argument("--flip-b", action="store_true", help="flip B vertically")
    p.add_argument(
        "--resize-b",
        action="store_true",
        help="box-downscale B to A's resolution (e.g. compare a reduced-res "
        "render against a full-resolution reference image)",
    )
    args = p.parse_args(argv)
    a = load_any(args.image_a)
    b = load_any(args.image_b)
    if args.flip_a:
        a = a[::-1]
    if args.flip_b:
        b = b[::-1]
    if args.resize_b and a.shape != b.shape:
        b = box_resize(b, a.shape[0], a.shape[1])
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    diff = a - b
    rmse = float(np.sqrt(np.mean(diff**2)))
    denom = float(np.sqrt(np.mean(b**2)))
    rel = rmse / max(denom, 1e-12)
    peak = max(float(b.max()), 1e-12)
    psnr = 20 * np.log10(peak / max(rmse, 1e-12))
    print(f"RMSE:          {rmse:.6f}")
    print(f"relative RMSE: {rel * 100:.3f}%")
    print(f"PSNR:          {psnr:.2f} dB")
    return 0 if rel < 0.01 else 1


if __name__ == "__main__":
    sys.exit(main())
