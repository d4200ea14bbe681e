"""Henyey-Greenstein phase function (reference shader/common.glsl:170-190),
in the operation order of volren_tpu.ops.pallas.kernel."""

from __future__ import annotations

import torch

from .geometry import INV_4PI, M_PI, align


def hg_phase(cos_t, g):
    denom = 1.0 + g * g + 2.0 * g * cos_t
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp(denom, min=1e-12)))


def sample_hg(direction, g, u0, u1):
    """Sample a scattered direction around ``direction`` (common.glsl:184-190)."""
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u0)
    small = torch.abs(g) < 1e-4
    cos_aniso = (1.0 + g * g - sqr * sqr) / (2.0 * torch.where(small, torch.ones_like(g), g))
    cos_t = torch.where(small, 1.0 - 2.0 * u0, cos_aniso)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * M_PI) * u1
    local = (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    return align(direction, local)
