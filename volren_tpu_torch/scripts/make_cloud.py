"""Procedural cumulus volume generator (the port of scripts/make_cloud.py).

Synthesises a heavyweight cloud scene (hundreds of MB dense, a sparse
brick occupancy like a cumulus) as a .brick file: an fbm-displaced union
of ellipsoids with low-density wisps, the same numbers as the JAX script
for the same seed.

Usage: python -m volren_tpu_torch.scripts.make_cloud [--res 512] [--seed 7]
       [--output cloud.brick]
"""

import argparse
import os

import numpy as np

from ..voldata import build_brick_grid, write_brick


def value_noise_3d(shape, cell, rng):
    """Trilinear-interpolated lattice noise."""
    gz = shape[0] // cell + 2
    gy = shape[1] // cell + 2
    gx = shape[2] // cell + 2
    lattice = rng.random((gz, gy, gx)).astype(np.float32)
    z = np.arange(shape[0], dtype=np.float32) / cell
    y = np.arange(shape[1], dtype=np.float32) / cell
    x = np.arange(shape[2], dtype=np.float32) / cell
    z0, y0, x0 = np.floor(z).astype(int), np.floor(y).astype(int), np.floor(x).astype(int)
    fz, fy, fx = z - z0, y - y0, x - x0
    fz = fz[:, None, None]
    fy = fy[None, :, None]
    fx = fx[None, None, :]

    def g(dz, dy, dx):
        return lattice[np.ix_(z0 + dz, y0 + dy, x0 + dx)]

    n = (
        g(0, 0, 0) * (1 - fz) * (1 - fy) * (1 - fx)
        + g(0, 0, 1) * (1 - fz) * (1 - fy) * fx
        + g(0, 1, 0) * (1 - fz) * fy * (1 - fx)
        + g(0, 1, 1) * (1 - fz) * fy * fx
        + g(1, 0, 0) * fz * (1 - fy) * (1 - fx)
        + g(1, 0, 1) * fz * (1 - fy) * fx
        + g(1, 1, 0) * fz * fy * (1 - fx)
        + g(1, 1, 1) * fz * fy * fx
    )
    return n.astype(np.float32)


def fbm(shape, rng, octaves=5, base_cell=None):
    base_cell = base_cell or max(shape) // 4
    out = np.zeros(shape, np.float32)
    amp, total = 1.0, 0.0
    cell = base_cell
    for _ in range(octaves):
        out += amp * value_noise_3d(shape, max(2, cell), rng)
        total += amp
        amp *= 0.5
        cell = max(2, cell // 2)
    return out / total


def make_cloud(res=512, seed=7):
    rng = np.random.default_rng(seed)
    shape = (res // 2, res, res)  # flat-ish cumulus
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, shape[0]),
        np.linspace(-1, 1, shape[1]),
        np.linspace(-1, 1, shape[2]),
        indexing="ij",
    )
    # union of a few ellipsoid puffs
    d = np.full(shape, 1e9, np.float32)
    for _ in range(6):
        c = rng.uniform(-0.45, 0.45, 3) * np.array([0.8, 1.0, 1.0])
        r = rng.uniform(0.25, 0.55, 3) * np.array([0.8, 1.0, 1.0])
        e = np.sqrt(
            ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 + ((xx - c[2]) / r[2]) ** 2
        )
        d = np.minimum(d, e)
    noise = fbm(shape, rng, octaves=5)
    surface = d - 0.35 * (noise - 0.5) - 1.0
    density = np.clip(-surface * 4.0, 0.0, 1.0)
    # hollow out towards the base, add interior variation
    density *= 0.4 + 0.6 * noise
    density[density < 0.01] = 0.0
    return density.astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--output", default="cloud.brick")
    args = p.parse_args(argv)
    dense = make_cloud(args.res, args.seed)
    occ = float((dense > 0).mean())
    print(f"cloud {dense.shape[::-1]}: occupancy {occ * 100:.1f}%, max {dense.max():.3f}")
    grid = build_brick_grid(dense)
    print(f"bricks: {grid.n_bricks}, atlas slots: {grid.atlas.shape[0]}")
    write_brick(args.output, grid)
    print(f"{args.output} written ({os.path.getsize(args.output) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
