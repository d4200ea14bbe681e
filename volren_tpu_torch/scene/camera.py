"""Pinhole camera.

Matches the reference's cppgl camera semantics at the points the kernels
consume them: ``cam_transform = inverse(mat3(view))`` with
view = lookAt(pos, pos + dir, up) (reference src/renderer.cpp:96-98)
and the ray generation in view_dir (reference shader/common.glsl:76-80).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


@dataclass
class Camera:
    pos: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 1.0], np.float32))
    dir: np.ndarray = field(default_factory=lambda: _normalize(np.array([-1.0, 0.0, -1.0], np.float32)))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fov_degree: float = 70.0
    near: float = 0.01
    far: float = 1000.0

    def __post_init__(self):
        self.pos = np.asarray(self.pos, np.float32)
        self.dir = _normalize(np.asarray(self.dir, np.float32))
        self.up = np.asarray(self.up, np.float32)

    @property
    def view(self) -> np.ndarray:
        """World -> view matrix (glm::lookAt convention, right-handed,
        camera looks down -z in view space)."""
        f = _normalize(self.dir.astype(np.float64))
        s = _normalize(np.cross(f, self.up.astype(np.float64)))
        u = np.cross(s, f)
        m = np.eye(4, dtype=np.float64)
        m[0, :3] = s
        m[1, :3] = u
        m[2, :3] = -f
        m[:3, 3] = -m[:3, :3] @ self.pos.astype(np.float64)
        return m.astype(np.float32)

    @property
    def transform(self) -> np.ndarray:
        """The ``cam_transform`` uniform: view->world rotation (3x3)."""
        return np.linalg.inv(self.view[:3, :3]).astype(np.float32)

    def look_at(self, target: np.ndarray) -> None:
        self.dir = _normalize(np.asarray(target, np.float32) - self.pos)

    # ---- COLMAP helpers (cf. reference src/bindings.cpp:196-206) ----

    _GL_TO_COLMAP = np.linalg.inv(
        np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float64))
    )

    def colmap_view_trans(self) -> np.ndarray:
        m = self._GL_TO_COLMAP @ self.view.astype(np.float64)
        return m[:3, 3].astype(np.float32)

    def colmap_view_rot(self) -> np.ndarray:
        """Quaternion (w, x, y, z) of the COLMAP world->camera rotation."""
        m = (self._GL_TO_COLMAP @ self.view.astype(np.float64))[:3, :3]
        # rotation matrix -> quaternion
        t = np.trace(m)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            w, x, y, z = 0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            w, x, y, z = (m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            w, x, y, z = (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
            w, x, y, z = (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s
        q = np.array([w, x, y, z], dtype=np.float64)
        return (q / np.linalg.norm(q)).astype(np.float32)

    def colmap_focal_length(self, height: int) -> float:
        return height / (2.0 * np.tan(0.5 * np.radians(self.fov_degree)))
