"""Environment importance sampling through the alias table (the
counterpart of volren_tpu.ops.envmap.sample_environment_alias,
reference shader/common.glsl:100-152)."""

from __future__ import annotations

import torch

from .geometry import M_PI
from .scene import EnvTables


def sample_environment_alias(env: EnvTables, u2: torch.Tensor):
    """O(1) environment texel sampling for (N, 2) uniforms: draws the texel
    distribution w / (N * avg) of the importance map with a uniform
    in-texel jitter. Returns (uv_x, uv_y, pdf, w_i (N, 3), le_texel (N, 3)),
    where le_texel is the chosen texel's box-filtered radiance."""
    table = env.alias_packed
    n = int(table.shape[0])
    dim = int(round(n ** 0.5))
    scaled = u2[:, 0] * n
    j = torch.clamp(scaled.to(torch.int32), 0, n - 1)
    frac_x = scaled - j.to(torch.float32)
    row = table[j.long()]
    prob = row[:, 0]
    keep = u2[:, 1] < prob
    texel = torch.where(keep, j, row[:, 1].to(torch.int32))
    pdf = torch.where(keep, row[:, 2], row[:, 3])
    le_texel = torch.where(keep[:, None], row[:, 4:7], row[:, 7:10])
    frac_y = torch.where(
        keep,
        u2[:, 1] / torch.clamp(prob, min=1e-12),
        (u2[:, 1] - prob) / torch.clamp(1.0 - prob, min=1e-12),
    )
    px = texel % dim
    py = texel // dim
    inv_dim = 1.0 / dim
    uv_x = (px.to(torch.float32) + frac_x) * inv_dim
    uv_y = (py.to(torch.float32) + torch.clamp(frac_y, 0.0, 1.0)) * inv_dim
    theta = torch.clamp(1.0 - uv_y, 0.0, 1.0) * M_PI
    phi = (torch.clamp(uv_x, 0.0, 1.0) * 2.0 - 1.0) * M_PI
    sin_t = torch.sin(theta)
    w_local = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)
    transform = torch.as_tensor(env.transform, device=w_local.device)
    w_i = w_local @ transform.T
    return uv_x, uv_y, pdf, w_i, le_texel
