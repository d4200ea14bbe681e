"""Ray/geometry helpers on torch lanes (reference shader/common.glsl:17-165).

3-vectors are tuples of three same-shape tensors, the structure-of-arrays
form the render kernel uses; each expression keeps the operation order of
volren_tpu.ops.pallas.kernel so the CUDA kernel can repeat it exactly.
"""

from __future__ import annotations

import torch

M_PI = 3.14159265358979323846
INV_4PI = 1.0 / (4.0 * M_PI)
LUMA_W = (0.212671, 0.715160, 0.072169)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm3(v, eps: float = 1e-20):
    inv = 1.0 / torch.clamp(torch.sqrt(dot3(v, v)), min=eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def mat3_vec(m, v):
    """out_i = sum_j v_j * m[i, j]; ``m`` is 9 row-major scalars."""
    return (v[0] * m[0] + v[1] * m[1] + v[2] * m[2],
            v[0] * m[3] + v[1] * m[4] + v[2] * m[5],
            v[0] * m[6] + v[1] * m[7] + v[2] * m[8])


def xform_point(m16, p):
    """(4,4) @ point; ``m16`` is 16 row-major scalars."""
    return (p[0] * m16[0] + p[1] * m16[1] + p[2] * m16[2] + m16[3],
            p[0] * m16[4] + p[1] * m16[5] + p[2] * m16[6] + m16[7],
            p[0] * m16[8] + p[1] * m16[9] + p[2] * m16[10] + m16[11])


def xform_vec(m16, v):
    """(4,4) @ direction (w=0, not normalized: index-space marching relies
    on the non-unit length, common.glsl:339)."""
    return (v[0] * m16[0] + v[1] * m16[1] + v[2] * m16[2],
            v[0] * m16[4] + v[1] * m16[5] + v[2] * m16[6],
            v[0] * m16[8] + v[1] * m16[9] + v[2] * m16[10])


def luma(c):
    return c[0] * LUMA_W[0] + c[1] * LUMA_W[1] + c[2] * LUMA_W[2]


def sanitize(x):
    """Non-finite -> 0."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def intersect_box(org, direction, bb_min, bb_max):
    """Slab test (common.glsl:157-165). Returns (hit, near, far)."""
    tmins, tmaxs = [], []
    for k in range(3):
        inv = 1.0 / direction[k]
        lo = (bb_min[k] - org[k]) * inv
        hi = (bb_max[k] - org[k]) * inv
        tmins.append(torch.minimum(lo, hi))
        tmaxs.append(torch.maximum(lo, hi))
    near = torch.clamp(torch.maximum(tmins[0], torch.maximum(tmins[1], tmins[2])), min=0.0)
    far = torch.minimum(tmaxs[0], torch.minimum(tmaxs[1], tmaxs[2]))
    return near <= far, near, far


def align(n, v):
    """Rotate tangent-space vector v into the frame around normal n
    (common.glsl:25-33)."""
    cond = torch.abs(n[0]) > torch.abs(n[1])
    inv_xz = 1.0 / torch.sqrt(torch.where(cond, n[0] * n[0] + n[2] * n[2],
                                          n[1] * n[1] + n[2] * n[2]))
    zero = torch.zeros_like(n[0])
    t = (torch.where(cond, -n[2], zero) * inv_xz,
         torch.where(cond, zero, n[2]) * inv_xz,
         torch.where(cond, n[0], -n[1]) * inv_xz)
    b = (n[1] * t[2] - n[2] * t[1],
         n[2] * t[0] - n[0] * t[2],
         n[0] * t[1] - n[1] * t[0])
    out = (v[0] * t[0] + v[1] * b[0] + v[2] * n[0],
           v[0] * t[1] + v[1] * b[1] + v[2] * n[1],
           v[0] * t[2] + v[1] * b[2] + v[2] * n[2])
    return norm3(out)
