"""Environment lookup, importance sampling and pdf (reference
shader/common.glsl:93-152): the alias-table sampler of the render kernel's
NEE pool (volren_tpu.ops.envmap.sample_environment_alias) and the oracle
engine's functions, in volren_tpu.ops.envmap's operation order: the GL
bilinear lookup, the equirect mapping, the hierarchical warp down the
importance pyramid and its pdf. Matrix products are written out, and every
division divides by a tensor on the lanes' device (torch on CUDA turns a
division by a Python float into a product with its reciprocal)."""

from __future__ import annotations

import torch

from .geometry import INV_4PI, M_PI, cols, luma, matvec
from .scene import EnvTables


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """GL-style bilinear fetch of (H, W, C) ``img`` (rows in v-order): u
    wraps, v clamps. Returns (N, C)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    x = u * float(w) - 0.5
    y = v * float(h) - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0.to(torch.float32))[:, None]
    fy = (y - y0.to(torch.float32))[:, None]
    x0w = torch.remainder(x0, w)   # floored, as jnp.mod
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    flat = img.reshape(h * w, -1)

    def tap(yy, xx):
        return flat[(yy * w + xx).long()]

    top = tap(y0c, x0w) * (1 - fx) + tap(y0c, x1w) * fx
    bot = tap(y1c, x0w) * (1 - fx) + tap(y1c, x1w) * fx
    return top * (1 - fy) + bot * fy


def texture_env(env: EnvTables, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return env.strength * _bilinear(env.envmap, u, v)[:, :3]


def dir_to_uv(inv_transform, direction: torch.Tensor):
    """World direction (N, 3) -> equirect (u, v) (common.glsl:93-96)."""
    idir = cols(matvec(inv_transform, direction))
    u = torch.atan2(idir[2], idir[0]) / _t(2.0 * M_PI, direction) + 0.5
    v = 1.0 - torch.acos(torch.clamp(idir[1], -1.0, 1.0)) / _t(M_PI, direction)
    return u, v


def lookup_environment(env: EnvTables, direction: torch.Tensor) -> torch.Tensor:
    """Radiance along (N, 3) world directions (common.glsl:93-98)."""
    u, v = dir_to_uv(env.inv_transform, direction)
    return texture_env(env, u, v)


def sample_environment(env: EnvTables, u2: torch.Tensor):
    """The hierarchical warp over the importance pyramid
    (common.glsl:100-146), from the coarse levels to the fine ones, four
    fetches per level. Returns (Le (N, 3), pdf (N,), w_i (N, 3))."""
    mips = env.imp_mips
    if not mips:
        raise ValueError("the environment carries no importance pyramid (EnvTables.imp_mips)")
    n = u2.shape[0]
    px = torch.zeros(n, dtype=torch.int32, device=u2.device)
    py = torch.zeros_like(px)
    p0, p1 = u2[:, 0], u2[:, 1]
    # imp_mips[m] is GL mip m; walk from base_mip - 1 down to 0
    for mip in range(len(mips) - 2, -1, -1):
        flat = mips[mip].reshape(-1)
        dim = int(mips[mip].shape[0])
        px = px * 2
        py = py * 2
        idx = (py * dim + px).long()
        w0, w1, w2, w3 = flat[idx], flat[idx + 1], flat[idx + dim], flat[idx + dim + 1]
        q0 = w0 + w2
        q1 = w1 + w3
        d = q0 / torch.clamp(q0 + q1, min=1e-8)
        go_right = p0 >= d
        new_px = torch.where(go_right, (p0 - d) / (1.0 - d), p0 / d)
        px = px + go_right.to(torch.int32)
        e = torch.where(go_right, w1 / torch.clamp(q1, min=1e-20),
                        w0 / torch.clamp(q0, min=1e-20))
        go_up = p1 >= e
        new_py = torch.where(go_up, (p1 - e) / (1.0 - e), p1 / e)
        py = py + go_up.to(torch.int32)
        p0, p1 = new_px, new_py
    dim0 = int(mips[0].shape[0])
    inv_dim = 1.0 / dim0
    uv_x = (px.to(torch.float32) + p0) * inv_dim
    uv_y = (py.to(torch.float32) + p1) * inv_dim
    theta = torch.clamp(1.0 - uv_y, 0.0, 1.0) * M_PI
    phi = (torch.clamp(uv_x, 0.0, 1.0) * 2.0 - 1.0) * M_PI
    sin_t = torch.sin(theta)
    w_local = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)],
                          dim=-1)
    w_i = matvec(env.transform, w_local)
    le = texture_env(env, uv_x, uv_y)
    avg_w = mips[-1].reshape(())
    pdf = mips[0].reshape(-1)[(py * int(mips[0].shape[1]) + px).long()] / avg_w
    return le, pdf * INV_4PI, w_i


def pdf_environment(env: EnvTables, direction: torch.Tensor) -> torch.Tensor:
    """MIS pdf of the warp for (N, 3) directions (common.glsl:148-152)."""
    avg_w = env.imp_mips[-1].reshape(())
    return luma(cols(lookup_environment(env, direction))) / avg_w * INV_4PI


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
