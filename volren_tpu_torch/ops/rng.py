"""Counter-based stateless RNG: TEA-32 seeding + LCG stream, bit-exact
with volren_tpu.ops.rng (reference shader/common.glsl:40-67).

The uint32 arithmetic runs in int64 tensors with explicit ``& 0xFFFFFFFF``
(torch's CPU uint32 lacks shifts and xor in many builds). Every value
kept between operations lies in [0, 2^32).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_INV_2_24 = 1.0 / float(0x01000000)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def tea(v0: torch.Tensor, v1: torch.Tensor, n_rounds: int = 32) -> torch.Tensor:
    """TEA hash of two uint32 lanes (common.glsl:40-50); int64 in and out."""
    v0, v1 = torch.broadcast_tensors(v0.to(torch.int64), v1.to(torch.int64))
    s0 = 0
    for _ in range(n_rounds):
        s0 = (s0 + 0x9E3779B9) & MASK
        # the terms exceed 32 bits (by at most 5), but the low 32 bits of
        # their xor and sum depend only on their low 32 bits: mask once
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4))) & MASK
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761E))) & MASK
    return v0


def rng(state: torch.Tensor):
    """Advance the LCG; returns (new_state, uniform in [0, 1) as float32)."""
    state = (state * 1664525 + 1013904223) & MASK
    u = (state & 0x00FFFFFF).to(torch.float32) * _INV_2_24
    return state, u


def rng_masked(state: torch.Tensor, active: torch.Tensor):
    """Advance only active lanes. The uniform is computed for every lane,
    as the kernel's ``_rng`` does."""
    new_state, u = rng(state)
    return torch.where(active, new_state, state), u


def rng2_masked(state: torch.Tensor, active: torch.Tensor):
    """Two masked draws; returns (state, (N, 2) uniforms)."""
    state, a = rng_masked(state, active)
    state, b = rng_masked(state, active)
    return state, torch.stack([a, b], dim=-1)


def rng2(state: torch.Tensor):
    state, a = rng(state)
    state, b = rng(state)
    return state, torch.stack([a, b], dim=-1)


def rng3_masked(state: torch.Tensor, active: torch.Tensor):
    """Three masked draws; returns (state, (N, 3) uniforms)."""
    state, a = rng_masked(state, active)
    state, b = rng_masked(state, active)
    state, c = rng_masked(state, active)
    return state, torch.stack([a, b, c], dim=-1)
