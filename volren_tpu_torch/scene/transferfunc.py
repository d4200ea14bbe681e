"""RGBA transfer-function LUT (numpy copy of volren_tpu.scene.transferfunc).

Reference TransferFunction (src/transferfunc.cpp): density windowing
(window_left/window_width), the alpha-CDF rewrite that the DDA majorant
needs (transferfunc.cpp:33-58), random LUTs and the `%f, %f, %f, %f` text
IO. Colormap LUTs (``colormap``, the CLI's --turbo / --viridis) are still
to port (ROADMAP Queue 1): the JAX package builds them with matplotlib,
which the card's machine does not have.
"""

from __future__ import annotations

import re

import numpy as np


class TransferFunction:
    def __init__(self, arg=None):
        self.window_left = 0.0
        self.window_width = 1.0
        self._rng = np.random.default_rng(0)
        if arg is None:
            self.randomize()
        elif isinstance(arg, str):
            self.load_from_file(arg)
        elif isinstance(arg, (list, tuple, np.ndarray)):
            self.lut = np.asarray(arg, dtype=np.float32).reshape(-1, 4)
        else:
            raise TypeError(f"cannot construct TransferFunction from {arg!r}")

    # ---- LUT sources ----

    def randomize(self, n_bins: int = 8, seed: int | None = None) -> None:
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        lut = rng.random((n_bins, 4)).astype(np.float32)
        lut[0] = 0.0
        self.lut = lut

    def colormap(self, name: str, n_bins: int = 256) -> None:
        raise NotImplementedError(
            f"colormap LUTs ({name!r}) are not ported yet: ROADMAP Queue 1, "
            "colormaps (--turbo, --viridis)")

    def load_from_file(self, path: str) -> None:
        rows = []
        with open(path) as f:
            for line in f:
                vals = re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", line)
                if len(vals) >= 4:
                    rows.append([float(v) for v in vals[:4]])
        if not rows:
            raise ValueError(f"{path}: no LUT entries")
        self.lut = np.asarray(rows, dtype=np.float32)

    def write_to_file(self, path: str) -> None:
        if not path.endswith(".txt"):
            path = re.sub(r"\.[^.]*$", "", path) + ".txt"
        with open(path, "w") as f:
            for r, g, b, a in self.lut:
                f.write(f"{r:f}, {g:f}, {b:f}, {a:f}\n")

    # ---- device LUT ----

    @staticmethod
    def compute_lut_cdf(lut: np.ndarray) -> np.ndarray:
        """Rewrite alpha as its normalized CDF so it is nondecreasing, as
        the DDA majorant needs (transferfunc.cpp:33-46)."""
        out = np.array(lut, dtype=np.float32, copy=True)
        csum = np.cumsum(out[:, 3])
        integral = csum[-1]
        if integral <= 0.0:
            out[:, 3] = (np.arange(len(out)) + 1) / float(len(out))
        else:
            out[:, 3] = csum / integral
        return out

    def device_lut(self) -> np.ndarray:
        """The LUT actually uploaded: CDF-rewritten iff alpha is not already
        monotone (transferfunc.cpp:47-57)."""
        alpha = self.lut[:, 3]
        if np.any(alpha[:-1] > alpha[1:]):
            return self.compute_lut_cdf(self.lut)
        return self.lut.astype(np.float32)

    @property
    def size(self) -> int:
        return len(self.lut)
