"""Henyey-Greenstein phase function (reference shader/common.glsl:170-190),
in the operation order of volren_tpu.ops.pallas.kernel (``hg_phase``,
``sample_hg``) and of volren_tpu.ops.phase (the oracle engine's
``phase_henyey_greenstein``, the same expression as ``hg_phase``, and
``sample_phase_henyey_greenstein``)."""

from __future__ import annotations

import torch

from .geometry import INV_4PI, M_PI, align, cols, normalize3


def hg_phase(cos_t, g):
    denom = 1.0 + g * g + 2.0 * g * cos_t
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp(denom, min=1e-12)))


def _hg_local(g, u0, u1):
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u0)
    small = torch.abs(g) < 1e-4
    cos_aniso = (1.0 + g * g - sqr * sqr) / (2.0 * torch.where(small, torch.ones_like(g), g))
    cos_t = torch.where(small, 1.0 - 2.0 * u0, cos_aniso)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * M_PI) * u1
    return (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def sample_hg(direction, g, u0, u1):
    """Sample a scattered direction around ``direction`` (common.glsl:184-190)."""
    return align(direction, _hg_local(g, u0, u1))


def sample_phase_henyey_greenstein(direction: torch.Tensor, g, u2: torch.Tensor) -> torch.Tensor:
    """volren_tpu.ops.phase's form of ``sample_hg``: (N, 3) direction,
    (N, 2) uniforms, (N, 3) result. It differs from ``sample_hg`` only in
    the last normalisation, a division here (volren_tpu.ops.geometry.align)."""
    local = _hg_local(g, u2[:, 0], u2[:, 1])
    return torch.stack(align(cols(direction), local, norm=normalize3), dim=-1)
