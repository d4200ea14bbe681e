"""The inputs a run makes, handed alike to the program and to the
reference: the sky (from the configuration's own seed), and from the run's
seed the temperature grid, the seeds of the renders, the camera's orbit
and the pixels the check reads.

``procedural_sky`` is a frozen copy of
``volren_tpu_torch.scene.environment.procedural_sky`` and
``temperature_grid`` of ``volren_tpu_torch.measure.temperature_grid`` (as
a bare array: the caller gives it its transform). Pure numpy; nothing
here imports the program.
"""

from __future__ import annotations

import numpy as np


def procedural_sky(width: int = 1024, height: int = 512, seed: int = 0) -> np.ndarray:
    """A (height, width, 3) float32 equirect sky in image order (row 0 =
    zenith): a zenith-to-horizon gradient over a dark ground, plus a sun
    disc whose direction is drawn from ``seed``."""
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


def temperature_grid(w: int, h: int, d: int, seed: int) -> np.ndarray:
    """A smooth hot core, clip(1 - r / (0.35 * w), 0, 1)^2 around a point
    near the box centre (jittered by ``seed``), as a (d, h, w) float32
    array."""
    c = (np.array([w, h, d]) * 0.5 * (1.0 + 0.1 * np.random.default_rng(seed).uniform(-1, 1, 3)))
    z, y, x = np.meshgrid(np.arange(d, dtype=np.float32), np.arange(h, dtype=np.float32),
                          np.arange(w, dtype=np.float32), indexing="ij")
    r = np.sqrt((x + 0.5 - c[0]) ** 2 + (y + 0.5 - c[1]) ** 2 + (z + 0.5 - c[2]) ** 2)
    hot = np.clip(1.0 - r / (0.35 * w), 0.0, 1.0) ** 2
    return hot.astype(np.float32)


# the grid's transform: a half-resolution grid over the density's index box
TEMPERATURE_TRANSFORM = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


class Seeds:
    """Independent streams drawn from one run seed (any non-negative
    integer): the temperature grid's, the renders', the orbit's and the
    check's."""

    def __init__(self, seed: int):
        if seed < 0:
            raise ValueError(f"the seed is a non-negative integer, not {seed}")
        temp, render, orbit, check = np.random.SeedSequence(int(seed)).spawn(4)
        self.temperature = int(temp.generate_state(1, np.uint32)[0])
        self._render = np.random.default_rng(render)
        self.orbit = np.random.default_rng(orbit)
        self.check = np.random.default_rng(check)

    def render_seeds(self, n: int) -> list[int]:
        """``n`` render seeds, each a uint32 (``Renderer.seed``)."""
        return [int(v) for v in self._render.integers(0, 2**32, n, dtype=np.uint64)]


def orbit_increments(lo_deg: float, hi_deg: float, n: int, rng: np.random.Generator):
    """The orbit's steps in degrees: the same ``n`` evenly spaced values in
    [lo_deg, hi_deg] for every seed, in the order ``rng`` draws, so every
    seed orbits through the same angles."""
    return rng.permutation(np.linspace(lo_deg, hi_deg, n))


def orbit_camera(pos0: np.ndarray, degrees: float):
    """The camera position ``pos0`` turned by ``degrees`` about the world's
    y axis through the origin, and its unit direction towards the origin."""
    a = np.radians(degrees)
    c, s = np.cos(a), np.sin(a)
    p = np.asarray(pos0, np.float64)
    pos = np.array([c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]])
    d = -pos / np.linalg.norm(pos)
    return pos.astype(np.float32), d.astype(np.float32)
