"""Colormap tables for transfer functions (the counterpart of
volren_tpu.utils.colormaps, without matplotlib).

The reference samples tinycolormap (Parula, Heat, Jet, Turbo, Hot, Gray,
Magma, Inferno, Plasma, Viridis, Cividis, Github, Cubehelix, HSV —
reference src/transferfunc.h:29). The JAX package samples the well-known
maps with matplotlib, which the card's machine does not have, so this module
carries matplotlib's own 256-row RGB tables as data (``colormaps.npz``,
written by ``PYTHONPATH=. python tests/test_torch_colormaps.py --write``,
whose tests hold every table to matplotlib bitwise) and samples them as
matplotlib does: no interpolation, bin ``min(int(t * 256), 255)`` of t
clipped to [0, 1]. Parula and Github use small anchor tables with linear
interpolation, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "colormaps.npz")

# colormap name -> matplotlib's name (the key of its table in TABLES)
_MPL_NAMES = {
    "heat": "hot",  # tinycolormap Heat ~ black->red->yellow->white ramp
    "jet": "jet",
    "turbo": "turbo",
    "hot": "hot",
    "gray": "gray",
    "magma": "magma",
    "inferno": "inferno",
    "plasma": "plasma",
    "viridis": "viridis",
    "cividis": "cividis",
    "cubehelix": "cubehelix",
    "hsv": "hsv",
}

# MATLAB parula anchors (public reference values, coarse 11-point table)
_PARULA = np.array(
    [
        [0.2422, 0.1504, 0.6603],
        [0.2810, 0.3228, 0.9579],
        [0.1786, 0.5289, 0.9682],
        [0.0689, 0.6948, 0.8394],
        [0.2161, 0.7843, 0.5923],
        [0.6720, 0.7793, 0.2227],
        [0.9970, 0.7659, 0.2199],
        [0.9892, 0.8136, 0.1885],
        [0.9616, 0.8913, 0.1533],
        [0.9763, 0.9831, 0.0538],
        [0.9763, 0.9831, 0.0538],
    ],
    dtype=np.float32,
)

# GitHub contribution-graph greens
_GITHUB = np.array(
    [
        [0.933, 0.933, 0.933],
        [0.776, 0.894, 0.545],
        [0.482, 0.788, 0.435],
        [0.137, 0.604, 0.231],
        [0.098, 0.380, 0.153],
    ],
    dtype=np.float32,
)


def _table_cmap(table: np.ndarray):
    def f(t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, dtype=np.float32), 0.0, 1.0)
        x = t * (len(table) - 1)
        i0 = np.floor(x).astype(np.int64)
        i1 = np.minimum(i0 + 1, len(table) - 1)
        w = (x - i0)[..., None]
        return table[i0] * (1 - w) + table[i1] * w

    return f


def _binned_cmap(table: np.ndarray):
    """matplotlib's ``Colormap.__call__`` on floats: t * N truncated to
    its bin (t == 1 in the last), NaN to black."""
    n = len(table)

    def f(t: np.ndarray) -> np.ndarray:
        x = np.clip(np.asarray(t, np.float32), 0, 1) * np.float32(n)
        x = np.where(x == n, np.float32(n - 1), x)
        bad = np.isnan(x)
        rgb = table[np.where(bad, 0, x).astype(np.int64)]
        return np.where(bad[..., None], np.float32(0.0), rgb)

    return f


def table(name: str) -> np.ndarray:
    """matplotlib's (256, 3) float32 RGB table of ``name`` (one of the
    values of _MPL_NAMES)."""
    with np.load(TABLES) as data:
        return data[name]


def get_colormap(name: str):
    """Return f(t in [0,1]) -> (..., 3) rgb (float32 for the matplotlib
    maps; Parula and Github return what the JAX package's do)."""
    key = name.lower()
    if key == "parula":
        return _table_cmap(_PARULA)
    if key == "github":
        return _table_cmap(_GITHUB)
    if key in _MPL_NAMES:
        return _binned_cmap(table(_MPL_NAMES[key]))
    raise KeyError(f"unknown colormap: {name}")
