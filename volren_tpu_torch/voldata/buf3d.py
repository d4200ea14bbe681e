"""3D buffer container mirroring voldata::Buf3D<T> (copy of
volren_tpu.voldata.buf3d).

The reference serializes brick-grid components as Buf3D blocks
(uvec3 stride + element count + payload; layout verified empirically against
reference data/smoke.brick). Here a Buf3D is a thin wrapper around a
numpy array of shape (z, y, x) or (z, y, x, C) plus the (x, y, z) stride
triple used on disk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Buf3D:
    """A dense 3D buffer. ``stride`` is (x, y, z) extent as in the reference;
    ``data`` is stored as a numpy array indexed [z, y, x(, channel)]."""

    stride: tuple[int, int, int]
    data: np.ndarray

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Buf3D":
        z, y, x = arr.shape[:3]
        return cls((x, y, z), arr)

    @property
    def n_elements(self) -> int:
        sx, sy, sz = self.stride
        return sx * sy * sz

    def __post_init__(self):
        sx, sy, sz = self.stride
        assert self.data.shape[:3] == (sz, sy, sx), (
            f"Buf3D shape {self.data.shape} does not match stride {self.stride}"
        )
