"""HDR environment map + luminance importance pyramid.

Replicates the reference's Environment (reference src/environment.cpp)
and its GPU importance-map pass (reference shader/env_setup.glsl):
a 512^2 map of supersampled luminance (8x8 taps/texel) plus a full box-filter
mip pyramid used by the hierarchical sample warp in the kernels
(reference shader/common.glsl:100-152).

Conventions: the equirect image is kept in image order (row 0 = top). The
spherical mapping is v = 1 - acos(y)/pi, so v = 1 corresponds to image row 0;
the importance map and all device-side sampling use "v-order" rows
(row index grows with v), matching GL texture addressing after cppgl's
vertical flip on load.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import spans

DIMENSION = 512  # importance map resolution (reference: environment.cpp:6)

# (abspath, mtime_ns, size) -> impmap mips; see Environment.__init__
_IMPMAP_CACHE: dict = {}
SAMPLES_PER_AXIS = 8  # sqrt(64) supersamples (environment.cpp:7)

_LUMA = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)


def _bilinear_wrap_u(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """GL-style bilinear sample: u wraps (equirect seam), v clamps.

    ``img`` rows are in v-order (row 0 = v ~ 0). u, v in [0, 1].
    """
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    x0w = x0 % w
    x1w = (x0 + 1) % w
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = img[y0c, x0w] * (1 - fx) + img[y0c, x1w] * fx
    bot = img[y1c, x0w] * (1 - fx) + img[y1c, x1w] * fx
    return top * (1 - fy) + bot * fy


class Environment:
    """Environment light: equirect radiance + importance mip pyramid.

    ``transform`` is the env rotation (3x3), ``strength`` a scalar multiplier
    (reference fields: environment.h:20-21).
    """

    def __init__(self, image: np.ndarray | str):
        cache_key = None
        if isinstance(image, str):
            from ..utils.hdr import read_hdr

            try:
                st = os.stat(image)
                cache_key = (os.path.abspath(image), st.st_mtime_ns,
                             st.st_size)
            except OSError:
                cache_key = None
            image = read_hdr(image)
        image = np.atleast_3d(np.asarray(image, dtype=np.float32))
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        if cache_key is None and image.size <= 3 * 64:
            # tiny images (Environment.white) memoize on content
            cache_key = ("image", image.shape, image.tobytes())
        # store in v-order: flip image vertically so row index grows with v
        self.envmap = np.ascontiguousarray(image[::-1])
        self.transform = np.eye(3, dtype=np.float32)
        self.strength = 1.0
        # the importance build is ~13 s of supersampled taps (64/texel);
        # streaming loops that reconstruct Environment per frame from the
        # same file (the reference rebinds one GL texture,
        # main.cpp:477-523) must not pay it repeatedly — memoize on file
        # identity (path, mtime, size). Arrays are treated as immutable.
        if cache_key is not None and cache_key in _IMPMAP_CACHE:
            self.impmap_mips = _IMPMAP_CACHE[cache_key]
        else:
            with spans.span("volren_tpu_torch.environment"):
                self.impmap_mips = build_importance_pyramid(self.envmap)
            if cache_key is not None:
                _IMPMAP_CACHE[cache_key] = self.impmap_mips

    @classmethod
    def white(cls, value: float = 1.0) -> "Environment":
        return cls(np.full((1, 1, 3), value, dtype=np.float32))


def build_importance_pyramid(envmap_v_order: np.ndarray) -> list[np.ndarray]:
    """512^2 supersampled-luma importance map + box mip pyramid.

    Per texel: mean of 8x8 bilinear luma taps (env_setup.glsl:25-31), then
    successive 2x2 means down to 1x1 (glGenerateMipmap box filter).
    Returns [512^2, 256^2, ..., 1^2] float32 arrays in v-order.
    """
    n = DIMENSION * SAMPLES_PER_AXIS
    base = np.empty((DIMENSION, DIMENSION), dtype=np.float32)
    # chunk rows to bound temp memory (n^2 taps total)
    us = (np.arange(n, dtype=np.float32) + 0.5) / n
    for row0 in range(0, DIMENSION, 64):
        rows = slice(row0 * SAMPLES_PER_AXIS, (row0 + 64) * SAMPLES_PER_AXIS)
        vs = (np.arange(n, dtype=np.float32)[rows] + 0.5) / n
        uu, vv = np.meshgrid(us, vs)
        taps = _bilinear_wrap_u(envmap_v_order, uu, vv) @ _LUMA
        base[row0 : row0 + 64] = taps.reshape(
            64, SAMPLES_PER_AXIS, DIMENSION, SAMPLES_PER_AXIS
        ).mean(axis=(1, 3))
    mips = [base]
    cur = base
    while cur.shape[0] > 1:
        cur = cur.reshape(cur.shape[0] // 2, 2, cur.shape[1] // 2, 2).mean(axis=(1, 3))
        mips.append(cur.astype(np.float32))
    return mips


def rotation_y(degrees: float) -> np.ndarray:
    """Env rotation used by --env_rot (reference src/main.cpp:389)."""
    r = np.radians(degrees)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def procedural_sky(width: int = 1024, height: int = 512, seed: int = 0) -> np.ndarray:
    """A (height, width, 3) float32 equirect sky in image order (row 0 =
    zenith): a zenith-to-horizon gradient over a dark ground, plus a sun
    disc whose direction is drawn from ``seed``. Directions follow the
    kernels' mapping u = atan2(z, x) / 2pi + 0.5, v = 1 - acos(y) / pi."""
    rng = np.random.default_rng(seed)
    sun_theta = rng.uniform(0.25, 0.45) * np.pi      # 9-45 degrees above the horizon
    sun_phi = rng.uniform(-1.0, 1.0) * np.pi
    theta = (np.arange(height, dtype=np.float64) + 0.5) / height * np.pi
    phi = ((np.arange(width, dtype=np.float64) + 0.5) / width - 0.5) * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    zenith = np.array([0.15, 0.35, 0.9])
    horizon = np.array([0.9, 0.9, 1.0])
    ground = np.array([0.08, 0.07, 0.06])
    up = np.clip(d[..., 1:2], 0.0, 1.0) ** 0.5
    img = np.where(d[..., 1:2] >= 0.0, horizon + (zenith - horizon) * up, ground)
    sun = np.array([np.sin(sun_theta) * np.cos(sun_phi), np.cos(sun_theta),
                    np.sin(sun_theta) * np.sin(sun_phi)])
    cos_a = d @ sun
    img = img + np.where(cos_a > np.cos(0.02), 400.0, 0.0)[..., None] * np.array([1.0, 0.95, 0.85])
    return img.astype(np.float32)
