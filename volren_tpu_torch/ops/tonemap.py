"""Hable (Uncharted 2) filmic tonemap + gamma (reference
shader/tonemap.glsl:13-36; volren_tpu.ops.tonemap)."""

from __future__ import annotations

import torch

from .geometry import sanitize

_A, _B, _C, _D, _E, _F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
_W = 11.2


def _hable(x):
    return ((x * (_A * x + _C * _B) + _D * _E) / (x * (_A * x + _B) + _D * _F)) - _E / _F


def hable_tonemap(rgb: torch.Tensor, exposure: float) -> torch.Tensor:
    return _hable(exposure * rgb) / _hable(torch.full_like(rgb, _W))


def tonemap(rgba: torch.Tensor, exposure: float, gamma: float) -> torch.Tensor:
    """Filmic + gamma on rgb of an (..., 4) framebuffer, alpha untouched
    (tonemap.glsl:29-36)."""
    rgb = torch.pow(torch.clamp(hable_tonemap(rgba[..., :3], exposure), min=0.0), 1.0 / gamma)
    return sanitize(torch.cat([rgb, rgba[..., 3:]], dim=-1))
