"""Ray-marching estimators and direct volume rendering (reference
shader/common.glsl:506-591), plain torch in the operation order of
volren_tpu.ops.raymarch: fixed-step (64) jittered ray marching beside the
null-collision estimators of ops/tracking.py, and the emission-absorption
``direct_volume_rendering`` of classic TF-coloured DVR. No render path of
either package reaches them; they have no CUDA kernel.
"""

from __future__ import annotations

import torch

from . import rng as _rng
from .envmap import lookup_environment
from .grid import lookup_density_stochastic, lookup_density_trilinear
from .tracking import _box, _t, _tf_tensors, _to_index_space
from .transfer import tf_lookup

RAYMARCH_STEPS = 64  # common.glsl:506


def _march_start(params, org, direction, seed, active):
    hit_box, near, far = _box(params, org, direction)
    run = active & hit_box
    dt = (far - near) / _t(RAYMARCH_STEPS, org)
    seed, u0 = _rng.rng_masked(seed, run)
    return run, near + u0 * dt, far, dt, seed


def transmittance_raymarch(scene, params, cfg, org, direction, seed, active):
    """exp(-sum tau) over 64 jittered steps (common.glsl:508-527).
    Returns (Tr, seed)."""
    ipos, idir = _to_index_space(scene.density, org, direction)
    run, t0, far, dt, seed = _march_start(params, org, direction, seed, active)
    tf = _tf_tensors(scene.tf, org)
    tau = torch.zeros_like(t0)
    for i in range(RAYMARCH_STEPS):
        t = torch.minimum(t0 + i * dt, far)
        pos = ipos + t[:, None] * idir
        d, seed = lookup_density_stochastic(scene.density, pos, seed, run, params.density_scale)
        if cfg.use_tf:
            a = tf_lookup(tf, d * params.inv_majorant)[:, 3]
            tau = tau + torch.where(run, a * params.majorant * dt, 0.0)
        else:
            tau = tau + torch.where(run, d * dt, 0.0)
    return torch.where(run, torch.exp(-tau), 1.0), seed


def direct_volume_rendering(scene, params, cfg, org, direction, seed, active):
    """Emission-absorption DVR through the transfer function
    (common.glsl:571-591). Returns ((N, 3) radiance, seed)."""
    ipos, idir = _to_index_space(scene.density, org, direction)
    run, t0, far, dt, seed = _march_start(params, org, direction, seed, active)
    tf = _tf_tensors(scene.tf, org)
    radiance = torch.zeros_like(org)
    tr = torch.ones_like(t0)
    for i in range(RAYMARCH_STEPS):
        t = torch.minimum(t0 + i * dt, far)
        pos = ipos + t[:, None] * idir
        d = lookup_density_trilinear(scene.density, pos, params.density_scale)
        rgba = tf_lookup(tf, d * params.inv_majorant)
        dtau = rgba[:, 3] * params.majorant * dt
        radiance = radiance + torch.where(run[:, None], rgba[:, :3] * (dtau * tr)[:, None], 0.0)
        tr = torch.where(run, tr * torch.exp(-dtau), tr)
    # GLSL returns env directly on a miss and L + env * Tr otherwise; a miss
    # has radiance 0 and tr 1, so one expression covers both
    if scene.env is not None:
        env = lookup_environment(scene.env, direction)
        radiance = radiance + torch.where(active[:, None], env * tr[:, None], 0.0)
    return radiance, seed
