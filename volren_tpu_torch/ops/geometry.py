"""Ray/geometry helpers on torch lanes (reference shader/common.glsl:17-165).

3-vectors are tuples of three same-shape tensors, the structure-of-arrays
form the render kernel uses; each expression keeps the operation order of
volren_tpu.ops.pallas.kernel so the CUDA kernel can repeat it exactly.
The (N, 3)-tensor helpers below them (``normalize``, ``view_dir``,
``transform_point``, ``transform_vector``, ``matvec``) are the oracle
engine's: they keep the operation order of volren_tpu.ops.geometry, with
every matrix product written out as multiply-adds in a fixed order
(``torch.matmul`` fixes none) and every division a division (never a
product with a reciprocal), so that csrc/oracle.cu can repeat them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

M_PI = 3.14159265358979323846
INV_4PI = 1.0 / (4.0 * M_PI)
LUMA_W = (0.212671, 0.715160, 0.072169)

_CONSTS: dict = {}
_CONSTS_LOCK = threading.Lock()


def device_const(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``, copied there once a process
    and value: a copy from host data waits for the device, and a CUDA graph
    of the chunked schedule (ops/chunked.py) reads the tensor after the call
    that asked for it. For a scene's constants, which the loops' steps
    read, not for values that change from call to call. Never write to
    it."""
    a = np.asarray(x, np.float32)
    key = (a.tobytes(), a.shape, str(torch.device(device)))
    with _CONSTS_LOCK:
        t = _CONSTS.get(key)
        if t is None:
            t = _CONSTS[key] = torch.tensor(a, device=device)
    return t


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


def align(n, v, norm=norm3):
    """Rotate tangent-space vector v into the frame around normal n
    (common.glsl:25-33). ``norm`` makes the result unit length: ``norm3``
    (the render kernel's product with a reciprocal) or ``normalize3``
    (volren_tpu.ops.geometry's division)."""
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
    return norm(out)


# ---- the oracle engine's helpers (volren_tpu.ops.geometry's order)

def cols(v: torch.Tensor):
    """(N, 3) -> the tuple of its three columns."""
    return v[:, 0], v[:, 1], v[:, 2]


def power_heuristic(a, b):
    return a * a / (a * a + b * b)


def normalize3(v, eps: float = 1e-20):
    """v / max(|v|, eps) on a tuple 3-vector (a division, as
    volren_tpu.ops.geometry.normalize divides)."""
    n = torch.clamp(torch.sqrt(dot3(v, v)), min=eps)
    return (v[0] / n, v[1] / n, v[2] / n)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """(N, 3) -> v / max(|v|, eps)."""
    return torch.stack(normalize3(cols(v), eps), dim=-1)


def matvec(m, v: torch.Tensor) -> torch.Tensor:
    """``v @ m.T`` for a (3, 3) host matrix ``m`` and (N, 3) ``v``:
    out_j = (v_0 m[j,0] + v_1 m[j,1]) + v_2 m[j,2]."""
    m = [[float(x) for x in row] for row in m]
    x, y, z = cols(v)
    return torch.stack([x * m[j][0] + y * m[j][1] + z * m[j][2] for j in range(3)], dim=-1)


def transform_point(m, p: torch.Tensor) -> torch.Tensor:
    """(4, 4) host matrix @ (N, 3) points: p @ m[:3, :3].T + m[:3, 3]."""
    return matvec(np.asarray(m)[:3, :3], p) + device_const(np.asarray(m, np.float32)[:3, 3],
                                                           p.device)


def transform_vector(m, v: torch.Tensor) -> torch.Tensor:
    """(4, 4) host matrix @ (N, 3) directions (w = 0, not normalized:
    index-space marching relies on the non-unit length,
    common.glsl:339)."""
    return matvec(np.asarray(m)[:3, :3], v)


def view_dir(xy: torch.Tensor, wh, pixel_sample: torch.Tensor, cam_transform,
             cam_fov) -> torch.Tensor:
    """Jittered pinhole camera ray (common.glsl:76-80). xy: (N, 2) int
    pixel coordinates (x right, y up), wh: (width, height), pixel_sample:
    (N, 2) in [0, 1), cam_transform: (3, 3) view -> world, cam_fov in
    degrees."""
    dev = pixel_sample.device
    f32 = torch.float32
    t = lambda x: torch.tensor(float(x), dtype=f32, device=dev)  # noqa: E731
    w, h = (int(v) for v in wh)
    px = (xy[:, 0].to(f32) + pixel_sample[:, 0] - float(w) * 0.5) / t(h)
    py = (xy[:, 1].to(f32) + pixel_sample[:, 1] - float(h) * 0.5) / t(h)
    z = t(-0.5) / torch.tan((0.5 * M_PI) * t(cam_fov) / t(180.0))
    d = normalize3((px, py, torch.zeros_like(px) + z))
    return normalize(matvec(cam_transform, torch.stack(d, dim=-1)))
