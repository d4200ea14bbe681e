"""The oracle engine's path tracer in plain torch: volren_tpu.ops.tracer
(``trace_path``, ``trace_sample``, ``trace_pass``), reference
shader/common.glsl:596-652 and the trace entry kernels
(pathtracer_brick(_tf).glsl): NEE with MIS against the hierarchically
warped environment, HG phase scattering, Russian roulette, and the
progressive running mean ``fb + (sanitize(rgba) - fb) * (1 / n)``.

All pixels are lanes of a tensor; the bounce loop is a masked loop whose
body runs the (also masked) tracking loops of ops/tracking.py, so every
lane draws the GLSL stream draw for draw. csrc/oracle.cu runs the same
function one thread per pixel (ops/kernels/oracle.py), operation for
operation; this module is its plain version, and it runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng as _rng
from .envmap import lookup_environment, pdf_environment, sample_environment
from .geometry import cols, dot3, luma, power_heuristic, sanitize, view_dir
from .phase import hg_phase, sample_phase_henyey_greenstein
from .tracking import (run_loop, sample_volume, sample_volume_dda, transmittance,
                       transmittance_dda)

# the most lanes, (pixel, pass) pairs, that trace_passes traces at once
PLAIN_LANES = 1 << 18


def _neg_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(-a * b) over the last axis, in order."""
    return dot3(cols(-a), cols(b))


def trace_path(scene, params, cfg, org, direction, seed, stats=None):
    """Trace one path per lane. Returns (L (N, 3), alpha (N,), seed)."""
    n, dev = org.shape[0], org.device
    f32 = torch.float32
    g = torch.tensor(np.float32(params.phase_g), device=dev)
    show = int(params.show_environment) > 0
    sample_fn = sample_volume_dda if cfg.use_dda else sample_volume
    trans_fn = transmittance_dda if cfg.use_dda else transmittance
    if stats is not None:
        stats["paths"] = stats.get("paths", 0) + n

    def body(c):
        active, direction = c["running"], c["dir"]
        hit, t, throughput, le, seed = sample_fn(scene, params, cfg, c["org"], direction,
                                                 c["th"], c["L"], c["seed"], active, stats)
        # lanes whose ray left the volume become free paths and stop bouncing
        active = active & hit
        org = torch.where(active[:, None], c["org"] + t[:, None] * direction, c["org"])

        # --- next-event estimation (common.glsl:614-626) ---
        seed, u2 = _rng.rng2_masked(seed, active)
        le_env, pdf_env, w_i = sample_environment(scene.env, u2)
        nee = active & (pdf_env > 0.0)
        f_p = hg_phase(_neg_dot(direction, w_i), g)
        mis_weight = power_heuristic(pdf_env, f_p) if show else torch.ones_like(f_p)
        tr, seed = trans_fn(scene, params, cfg, org, w_i, seed, nee, stats)
        contrib = (throughput * (mis_weight * f_p * tr / torch.clamp(pdf_env, min=1e-20))[:, None]
                   * le_env)
        le = le + torch.where(nee[:, None], contrib, 0.0)

        # --- termination: bounce cap + russian roulette (common.glsl:629-636)
        n_paths = c["n_paths"] + active.to(torch.int32)
        capped = active & (n_paths >= int(params.bounces))
        active = active & ~capped
        rr_val = luma(cols(throughput))
        rr = active & (rr_val < 0.1)
        seed, u_rr = _rng.rng_masked(seed, rr)
        killed = rr & (u_rr < 1.0 - rr_val)
        active = active & ~killed
        throughput = torch.where((rr & ~killed)[:, None],
                                 throughput / torch.clamp(rr_val, min=1e-20)[:, None], throughput)

        # --- scatter (common.glsl:639-641) ---
        seed, u2s = _rng.rng2_masked(seed, active)
        scatter_dir = sample_phase_henyey_greenstein(direction, g, u2s)
        f_p_scatter = hg_phase(_neg_dot(direction, scatter_dir), g)
        return dict(running=active, org=org,
                    dir=torch.where(active[:, None], scatter_dir, direction),
                    th=throughput, L=le, seed=seed, n_paths=n_paths,
                    last_f_p=torch.where(active, f_p_scatter, c["last_f_p"]),
                    free=c["free"] & ~(capped | killed))

    state = dict(running=torch.ones(n, dtype=torch.bool, device=dev), org=org, dir=direction,
                 th=torch.ones(n, 3, dtype=f32, device=dev),
                 L=torch.zeros(n, 3, dtype=f32, device=dev), seed=seed,
                 n_paths=torch.zeros(n, dtype=torch.int32, device=dev),
                 last_f_p=torch.zeros(n, dtype=f32, device=dev),
                 free=torch.ones(n, dtype=torch.bool, device=dev))
    state = run_loop(state, body, 1 << 62, stats, "bounce")

    # free path -> environment contribution (common.glsl:645-649)
    le, throughput, n_paths, direction = state["L"], state["th"], state["n_paths"], state["dir"]
    free = state["free"] & show
    env_le = lookup_environment(scene.env, direction)
    mis = torch.where(n_paths > 0,
                      power_heuristic(state["last_f_p"], pdf_environment(scene.env, direction)),
                      1.0)
    le = le + torch.where(free[:, None], throughput * mis[:, None] * env_le, 0.0)
    alpha = torch.clamp(n_paths.to(f32), 0.0, 1.0)
    return le, alpha, state["seed"]


def trace_sample(scene, params, cfg, xy, wh, current_sample, stats=None):
    """One progressive sample for a batch of pixels
    (pathtracer_brick.glsl:23-37). xy: (N, 2) int pixel coordinates,
    wh: (width, height), current_sample: an int or an (N,) int tensor (the
    pass of each lane). Returns (N, 4) rgba."""
    dev = xy.device
    pixel_idx = (xy[:, 1].to(torch.int64) * int(wh[0]) + xy[:, 0]) & _rng.MASK
    sample = torch.as_tensor(current_sample, dtype=torch.int64, device=dev) & _rng.MASK
    seed = _rng.tea(_rng.mul32(pixel_idx, int(params.seed) & _rng.MASK), sample, 32)
    seed, u2 = _rng.rng2(seed)
    direction = view_dir(xy, wh, u2, params.cam_transform, params.cam_fov)
    org = torch.tensor(np.asarray(params.cam_pos, np.float32), device=dev).expand_as(direction)
    le, alpha, _ = trace_path(scene, params, cfg, org, direction, seed, stats)
    return torch.cat([le, alpha[:, None]], dim=-1)


def pass_weight(current_sample: int) -> np.float32:
    """1 / current_sample in float32, the running mean's weight."""
    return np.float32(1.0) / np.float32(current_sample)


def _pixels(width, height, dev):
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int32, device=dev),
                            torch.arange(width, dtype=torch.int32, device=dev), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def trace_pass(scene, params, cfg, framebuffer, current_sample, width, height, stats=None):
    """One full-frame progressive pass: the (H, W, 4) running mean
    ``framebuffer + (sanitize(rgba) - framebuffer) * (1 / current_sample)``."""
    return trace_passes(scene, params, cfg, framebuffer, current_sample, 1, width, height, stats)


def trace_passes(scene, params, cfg, framebuffer, first_sample, n_passes, width, height,
                 stats=None, frames: list | None = None):
    """``n_passes`` passes, samples first_sample .. first_sample +
    n_passes - 1, each folded into the running mean in turn: the same as
    that many calls of ``trace_pass``. Several passes' lanes are traced
    together, at most PLAIN_LANES (pixel, pass) lanes at a time. A
    ``frames`` list gets the framebuffer after each pass."""
    dev = framebuffer.device
    n_pix = width * height
    xy = _pixels(width, height, dev)
    per = max(1, PLAIN_LANES // n_pix)
    fb = framebuffer
    for k0 in range(0, n_passes, per):
        k = min(per, n_passes - k0)
        samples = torch.arange(first_sample + k0, first_sample + k0 + k, device=dev)
        rgba = trace_sample(scene, params, cfg, xy.repeat(k, 1), (width, height),
                            samples.repeat_interleave(n_pix), stats)
        rgba = sanitize(rgba).reshape(k, height, width, 4)
        for j in range(k):
            w = torch.tensor(pass_weight(first_sample + k0 + j), device=dev)
            fb = fb + (rgba[j] - fb) * w
            if frames is not None:
                frames.append(fb)
    return fb
