"""Brick-grid lookups and stochastic filters of the oracle engine
(reference shader/common.glsl:217-328), in the operation order of
volren_tpu.ops.grid on the port's ``GridTables``: nearest, trilinear
(the 8-corner form) and stochastic-tricubic density lookups, majorant
pyramid lookups and the emission lookup. Integer coordinates clamp into
the padded brick extent. Positions are (N, 3) float32 index-space tensors;
draws go through ``rng_masked``, so a lane draws only where it is active.
volren_tpu's pre-decoded ``dense`` and ``dense_quad`` fetch layouts give
the same values as the brick decode, which is the only one here.
"""

from __future__ import annotations

import torch

from . import rng as _rng
from .geometry import device_const, transform_point
from .scene import GridTables


def _brick_index(grid: GridTables, ipos: torch.Tensor):
    """Clamped flat brick index and voxel offset of integer positions."""
    bx, by, bz = grid.n_bricks
    iipos = torch.floor(ipos).to(torch.int32)
    vx = torch.clamp(iipos[:, 0], 0, bx * 8 - 1)
    vy = torch.clamp(iipos[:, 1], 0, by * 8 - 1)
    vz = torch.clamp(iipos[:, 2], 0, bz * 8 - 1)
    bidx = (vz >> 3) * (by * bx) + (vy >> 3) * bx + (vx >> 3)
    voff = (vz & 7) * 64 + (vy & 7) * 8 + (vx & 7)
    return bidx.long(), voff.long()


def lookup_density_brick(grid: GridTables, ipos: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour voxel decode (common.glsl:268-275)."""
    bidx, voff = _brick_index(grid, ipos)
    slot = grid.slot[bidx].long()
    unorm = grid.atlas.reshape(-1)[slot * 512 + voff].to(torch.float32) * (1.0 / 255.0)
    lo = grid.lo[bidx]
    return lo + unorm * (grid.hi[bidx] - lo)


def _majorant_index(grid: GridTables, ipos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """Flat index into the majorant pyramid for (N,) mips in [0, 3]."""
    iipos = torch.floor(ipos).to(torch.int32)
    idx = torch.zeros(ipos.shape[0], dtype=torch.int32, device=ipos.device)
    for m in range(4):
        mz, my, mx = grid.mip_dims[m]
        bxm = torch.clamp(iipos[:, 0] >> (3 + m), 0, mx - 1)
        bym = torch.clamp(iipos[:, 1] >> (3 + m), 0, my - 1)
        bzm = torch.clamp(iipos[:, 2] >> (3 + m), 0, mz - 1)
        idx = torch.where(mip == m, grid.mip_offsets[m] + (bzm * my + bym) * mx + bxm, idx)
    return idx.long()


def lookup_majorant(grid: GridTables, ipos: torch.Tensor, mip: torch.Tensor,
                    density_scale: float) -> torch.Tensor:
    """Per-region majorant from the pyramid (common.glsl:278-281); mip 0
    reads the per-brick range max."""
    return density_scale * grid.mip_maj[_majorant_index(grid, ipos, mip)]


def lookup_density(grid: GridTables, ipos: torch.Tensor, density_scale: float) -> torch.Tensor:
    return density_scale * lookup_density_brick(grid, ipos)


def lookup_density_trilinear(grid: GridTables, ipos: torch.Tensor,
                             density_scale: float) -> torch.Tensor:
    """Trilinear decode (common.glsl:289-297): 8 corners, dx fastest."""
    p = ipos - 0.5
    base = torch.floor(p)
    f = p - base
    acc = torch.zeros(ipos.shape[0], dtype=torch.float32, device=ipos.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((f[:, 0] if dx else 1.0 - f[:, 0]) * (f[:, 1] if dy else 1.0 - f[:, 1])
                     * (f[:, 2] if dz else 1.0 - f[:, 2]))
                offs = device_const([dx, dy, dz], ipos.device)
                acc = acc + w * lookup_density_brick(grid, base + offs)
    return density_scale * acc


def stochastic_trilinear_filter(ipos: torch.Tensor, seed: torch.Tensor, active: torch.Tensor):
    seed, u = _rng.rng_masked(seed, active)
    seed, v = _rng.rng_masked(seed, active)
    seed, w = _rng.rng_masked(seed, active)
    return torch.floor(ipos - 0.5 + torch.stack([u, v, w], dim=-1)), seed


def stochastic_tricubic_filter(ipos: torch.Tensor, seed: torch.Tensor, active: torch.Tensor):
    """Weighted reservoir sampling of the tricubic B-spline taps
    (common.glsl:221-244): 9 draws, (x, y, z) for each of taps 1-3."""
    iipos = torch.floor(ipos - 0.5)
    t = (ipos - 0.5) - iipos
    t2 = t * t
    t3 = t * t2
    sum_wt = (1.0 / 6.0) * (-t3 + 3.0 * t2 - 3.0 * t + 1.0)
    idx = torch.zeros_like(ipos)
    taps = (
        (1.0, (1.0 / 6.0) * (3.0 * t3 - 6.0 * t2 + 4.0)),
        (2.0, (1.0 / 6.0) * (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0)),
        (3.0, (1.0 / 6.0) * t3),
    )
    for tap_idx, w in taps:
        sum_wt = w + sum_wt
        seed, r3 = _rng.rng3_masked(seed, active)
        take = r3 < w / torch.clamp(sum_wt, min=1e-3)
        idx = torch.where(take, tap_idx, idx)
    return iipos + idx - 1.0, seed


def lookup_density_stochastic(grid: GridTables, ipos: torch.Tensor, seed: torch.Tensor,
                              active: torch.Tensor, density_scale: float):
    """Stochastic tricubic density (common.glsl:300-304). Returns (d, seed)."""
    tap, seed = stochastic_tricubic_filter(ipos, seed, active)
    return lookup_density(grid, tap, density_scale), seed


def lookup_emission(emission_grid: GridTables, density_transform, ipos: torch.Tensor,
                    seed: torch.Tensor, active: torch.Tensor, emission_scale: float,
                    emission_norm: float):
    """Blackbody-ish emission from the temperature grid (common.glsl:324-328).
    ``ipos`` is in DENSITY index space: mapped to world through
    ``density_transform``, then into the emission grid's index space, two
    steps as volren_tpu.ops.grid takes them. Returns ((N, 3), seed)."""
    world = transform_point(density_transform, ipos)
    epos = transform_point(emission_grid.inv_transform, world)
    tap, seed = stochastic_tricubic_filter(epos, seed, active)
    t = lookup_density_brick(emission_grid, tap) * emission_norm
    t2 = t * t
    e = torch.stack([t2, t2 * t2, t2 * t2 * t2 * t2], dim=-1)
    return emission_scale * e, seed
