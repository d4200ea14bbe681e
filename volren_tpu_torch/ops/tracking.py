"""Null-collision and DDA volume tracking of the oracle engine
(reference shader/common.glsl:333-501), the plain torch version of
volren_tpu.ops.tracking: every lane (ray) carries its own progress through
a masked loop, and every draw is masked, so each lane draws exactly the
stream the divergent GLSL control flow would. The DDA pair marches the
8^3-brick min/max majorant pyramid with the reference's mip schedule
(MIP_START 3, +0.25 up, -2 down).

Each loop stops a lane once the loop's iteration counter reaches
``cfg.max_steps`` (volren_tpu: the while_loop's shared counter, which every
lane of a call starts at 0): the lane keeps its state as it stands
mid-loop. A lane that stops running is frozen by the masks, so the loop
sets it aside and runs on the others (``run_loop``); the result is the
same. With a ``stats`` dict, each loop adds the lanes it ran in each
iteration (``<loop>_iters``), the density tests of a DDA loop
(``<loop>_tests``) and the lanes the cap stopped (``capped``).

The reference's estimator quirks are kept, as volren_tpu keeps them
(tracking.py:12-19): transmittance_dda's ratio factor
``1 - vol_majorant / majorant`` is <= 0 whenever a real collision is
sampled, so it acts as a binary (delta-tracking) visibility estimator
(common.glsl:443); sample_volume_dda weights emission with the global
inverse majorant while collisions are tested at the local majorant's rate
(common.glsl:489).
"""

from __future__ import annotations

import torch

from . import chunked as _chunked
from . import rng as _rng
from .geometry import cols, device_const, intersect_box, transform_point, transform_vector
from .grid import (lookup_density_stochastic, lookup_density_trilinear, lookup_emission,
                   lookup_majorant)
from .transfer import tf_lookup

MIP_START = 3.0
MIP_SPEED_UP = 0.25
MIP_SPEED_DOWN = 2.0


def run_loop(state: dict, body, max_steps: int, stats=None, name: str = "loop",
             graph: bool = True) -> dict:
    """Run ``body`` (state dict -> state dict, lane axis first,
    ``state["running"]`` the lane mask) while any lane runs and fewer than
    ``max_steps`` iterations have run. Lanes that stopped are set aside
    once they are half of the current set. Returns the final state.

    ``stats``: None, a dict, or a ``chunked.Schedule``, which runs the loop
    on its chunked schedule: a check every ``chunked.chunk(lanes)``
    iterations (the cap's last iteration after a check of its own, as the
    per-step loop runs it only while a lane runs), the chunks replayed as
    CUDA graphs unless ``graph`` is False (a body with loops of its own)."""
    sched = stats if isinstance(stats, _chunked.Schedule) else None

    def step(c):
        sched.count(f"{name}_iters", c["running"])
        return body(c)

    full, sel, cur, i = state, None, state, 0
    while i < max_steps:
        running = cur["running"]
        n_run = int(running.sum())
        if n_run == 0:
            break
        n = running.shape[0]
        m = n_run if sched is None else _chunked.cut(n_run, n)
        if 2 * n_run <= n and m < n:
            keep = running.nonzero().squeeze(1) if sched is None else _chunked.keep(running, m)
            full = _put(full, sel, cur)
            sel = keep if sel is None else sel[keep]
            cur = {k: v[keep] for k, v in cur.items()}
        if sched is None:
            _chunked.count(stats, f"{name}_iters", n_run)
            cur = body(cur)
            i += 1
            continue
        steps = min(_chunked.chunk(m), max_steps - i)
        if 1 < steps == max_steps - i:
            steps -= 1
        cur = sched.run(name, step, cur, steps, graph)
        i += steps
    if i == max_steps:
        _chunked.count(stats, "capped", cur["running"])
    if sched is not None and sel is None:
        # the caller owns what it gets: a graph's next replay overwrites it
        return {k: v.clone() for k, v in cur.items()}
    return _put(full, sel, cur)


def _put(full: dict, sel, cur: dict) -> dict:
    if sel is None:
        return cur
    return {k: full[k].index_copy(0, sel, cur[k]) for k in full}


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return device_const(x, like.device)


def _tf_tensors(tf, like):
    """The TF with its window as tensors on the lanes' device: torch on
    CUDA turns a division by a Python float into a product with its
    reciprocal, where the kernel divides."""
    if tf is None:
        return None
    return tf._replace(window_left=_t(tf.window_left, like),
                       window_width=_t(tf.window_width, like))


def _to_index_space(grid, org, direction):
    return transform_point(grid.inv_transform, org), transform_vector(grid.inv_transform, direction)


def _box(params, org, direction):
    return intersect_box(cols(org), cols(direction), [float(v) for v in params.bb_min],
                         [float(v) for v in params.bb_max])


def _density_at(scene, tf, params, cfg, pos, seed, active):
    """Collision-test density (and the TF rgba when enabled). Returns
    (d, rgba or None, seed)."""
    if cfg.use_tf:
        d_raw = lookup_density_trilinear(scene.density, pos, params.density_scale)
        rgba = tf_lookup(tf, d_raw * params.inv_majorant)
        return params.majorant * rgba[:, 3], rgba, seed
    d, seed = lookup_density_stochastic(scene.density, pos, seed, active, params.density_scale)
    return d, None, seed


def _add_emission(scene, params, cfg, pos, weight, throughput, le, seed, active, stats):
    """le += throughput * (1 - albedo) * emission * weight (masked)."""
    if not cfg.has_emission:
        return le, seed
    _chunked.count(stats, "emission", active)
    e, seed = lookup_emission(scene.emission, scene.density.transform, pos, seed, active,
                              params.emission_scale, params.emission_norm)
    one_minus_albedo = 1.0 - _t(params.albedo, pos)
    contrib = throughput * one_minus_albedo * e * weight[:, None]
    return le + torch.where(active[:, None], contrib, 0.0), seed


def _albedo_mult(params, cfg, rgba, like):
    albedo = _t(params.albedo, like)
    return albedo * rgba[:, :3] if cfg.use_tf else albedo * 1.0


# ---------------------------------------------------------------------------
# global-majorant null-collision estimators (common.glsl:333-394)
# ---------------------------------------------------------------------------

def transmittance(scene, params, cfg, org, direction, seed, active, stats=None):
    """Ratio tracking with the global majorant. Returns (Tr, seed)."""
    hit_box, near, far = _box(params, org, direction)
    ipos, idir = _to_index_space(scene.density, org, direction)
    run0 = active & hit_box
    tf = _tf_tensors(scene.tf, org)
    inv_maj = params.inv_majorant

    seed, u = _rng.rng_masked(seed, run0)
    t0 = near - torch.log(1.0 - u) * inv_maj

    def body(c):
        running = c["running"] & (c["t"] < c["far"])
        pos = c["ipos"] + c["t"][:, None] * c["idir"]
        d, _rgba, seed = _density_at(scene, tf, params, cfg, pos, c["seed"], running)
        tr = torch.where(running, c["tr"] * (1.0 - d * inv_maj), c["tr"])
        # russian roulette below 0.1: prob = 1 - Tr; survivors divide by
        # 1 - prob = Tr, i.e. continue with Tr = 1 (common.glsl:351-356)
        rr = running & (tr < 0.1)
        seed, u_rr = _rng.rng_masked(seed, rr)
        killed = rr & (u_rr < (1.0 - tr))
        tr = torch.where(killed, 0.0, torch.where(rr, 1.0, tr))
        running = running & ~killed
        seed, u_adv = _rng.rng_masked(seed, running)
        t = torch.where(running, c["t"] - torch.log(1.0 - u_adv) * inv_maj, c["t"])
        return dict(c, running=running, t=t, tr=tr, seed=seed)

    out = run_loop(dict(running=run0, t=t0, tr=torch.ones_like(t0), seed=seed, ipos=ipos,
                        idir=idir, far=far), body, cfg.max_steps, stats, "transmittance")
    return torch.where(active, out["tr"], 1.0), out["seed"]


def sample_volume(scene, params, cfg, org, direction, throughput, le, seed, active, stats=None):
    """Delta tracking with the global majorant. Returns
    (hit, t, throughput, le, seed)."""
    hit_box, near, far = _box(params, org, direction)
    ipos, idir = _to_index_space(scene.density, org, direction)
    run0 = active & hit_box
    tf = _tf_tensors(scene.tf, org)
    inv_maj = params.inv_majorant

    seed, u = _rng.rng_masked(seed, run0)
    t0 = near - torch.log(1.0 - u) * inv_maj

    def body(c):
        running = c["running"] & (c["t"] < c["far"])
        pos = c["ipos"] + c["t"][:, None] * c["idir"]
        d, rgba, seed = _density_at(scene, tf, params, cfg, pos, c["seed"], running)
        p_real = d * inv_maj
        le, seed = _add_emission(scene, params, cfg, pos, p_real, c["th"], c["le"], seed,
                                 running, stats)
        seed, u_cls = _rng.rng_masked(seed, running)
        hit_now = running & (u_cls < p_real)
        mult = _albedo_mult(params, cfg, rgba, pos)
        th = torch.where(hit_now[:, None], c["th"] * mult, c["th"])
        running = running & ~hit_now
        seed, u_adv = _rng.rng_masked(seed, running)
        t = torch.where(running, c["t"] - torch.log(1.0 - u_adv) * inv_maj, c["t"])
        return dict(c, running=running, t=t, th=th, le=le, hit=c["hit"] | hit_now, seed=seed)

    out = run_loop(dict(running=run0, t=t0, th=throughput, le=le, hit=torch.zeros_like(run0),
                        seed=seed, ipos=ipos, idir=idir, far=far),
                   body, cfg.max_steps, stats, "sample_volume")
    return out["hit"], out["t"], out["th"], out["le"], out["seed"]


# ---------------------------------------------------------------------------
# DDA estimators over the min/max brick majorant pyramid (common.glsl:399-501)
# ---------------------------------------------------------------------------

def step_dda(pos: torch.Tensor, inv_dir: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """Distance to the next (8 << mip)-aligned cell boundary
    (common.glsl:404-409). mip: (N,) int32."""
    dim = (8 << mip).to(torch.float32)[:, None]
    offs = torch.where(inv_dir >= 0.0, dim + 0.5, -0.5)
    tmax = cols((torch.floor(pos / dim) * dim + offs - pos) * inv_dir)
    return torch.minimum(tmax[0], torch.minimum(tmax[1], tmax[2]))


def _local_majorant(scene, tf, params, cfg, pos, mip_round):
    maj = lookup_majorant(scene.density, pos, mip_round, params.density_scale)
    if cfg.use_tf:
        return params.majorant * tf_lookup(tf, maj * params.inv_majorant)[:, 3]
    return maj


def _dda_loop(scene, params, cfg, org, direction, seed, active, collide_fn, extra: dict,
              stats, name):
    """The shared DDA march. ``collide_fn(c, seed, pos, d, rgba, maj, real,
    do_test)`` takes a sampled collision point, updates the estimator's
    entries of the state ``c`` in place and returns (seed, terminate).
    Returns the final state."""
    hit_box, near, far = _box(params, org, direction)
    ipos, idir = _to_index_space(scene.density, org, direction)
    ri = 1.0 / idir
    run0 = active & hit_box
    tf = _tf_tensors(scene.tf, org)

    seed, u0 = _rng.rng_masked(seed, run0)
    t0 = near + 1e-6
    tau0 = -torch.log(1.0 - u0)
    mip0 = torch.full_like(t0, MIP_START)

    def body(c):
        running, t, tau, mip = c["running"], c["t"], c["tau"], c["mip"]
        curr = c["ipos"] + t[:, None] * c["idir"]
        mip_round = torch.round(mip).to(torch.int32)
        maj = _local_majorant(scene, tf, params, cfg, curr, mip_round)
        dt = step_dda(curr, c["ri"], mip_round)
        t_adv = t + dt
        tau_adv = tau - maj * dt
        mip_up = torch.clamp(mip + MIP_SPEED_UP, max=3.0)

        collide = running & (tau_adv <= 0.0)
        t_col = t_adv + tau_adv / torch.clamp(maj, min=1e-20)
        t = torch.where(collide, t_col, torch.where(running, t_adv, t))
        exited = collide & (t >= c["far"])
        do_test = collide & ~exited
        _chunked.count(stats, f"{name}_tests", do_test)

        pos = c["ipos"] + t[:, None] * c["idir"]
        c = dict(c)
        d, rgba, seed = _density_at(scene, tf, params, cfg, pos, c["seed"], do_test)
        seed, u_cls = _rng.rng_masked(seed, do_test)
        real = do_test & (u_cls * maj < d)
        seed, terminate = collide_fn(c, seed, pos, d, rgba, maj, real, do_test)

        # no-hit collisions: redraw tau, drop mips
        redraw = do_test & ~terminate
        seed, u_tau = _rng.rng_masked(seed, redraw)
        c["tau"] = torch.where(redraw, -torch.log(1.0 - u_tau), torch.where(running, tau_adv, tau))
        c["mip"] = torch.where(redraw, torch.clamp(mip_up - MIP_SPEED_DOWN, min=0.0),
                               torch.where(running, mip_up, mip))
        c["running"] = running & ~exited & ~terminate & (t < c["far"])
        c["t"], c["seed"] = t, seed
        return c

    state = dict(running=run0, t=t0, tau=tau0, mip=mip0, seed=seed, ipos=ipos, idir=idir,
                 ri=ri, far=far, **extra)
    return run_loop(state, body, cfg.max_steps, stats, name)


def transmittance_dda(scene, params, cfg, org, direction, seed, active, stats=None):
    """DDA transmittance (common.glsl:412-455). Returns (Tr, seed)."""
    majorant = _t(params.majorant, org)

    def collide(c, seed, pos, d, rgba, maj, real, do_test):
        # ratio of global to local majorant, <= 0 in practice: a real
        # collision zeroes Tr (see the module docstring)
        tr = c["tr"]
        tr_new = tr * torch.clamp(1.0 - majorant / torch.clamp(maj, min=1e-20), min=0.0)
        tr = torch.where(real, tr_new, tr)
        rr = real & (tr < 0.1)
        seed, u_rr = _rng.rng_masked(seed, rr)
        killed = rr & (u_rr < 1.0 - tr)
        # survivors: tr /= (1 - prob) = tr / tr = 1
        c["tr"] = torch.where(killed, 0.0, torch.where(rr, 1.0, tr))
        return seed, killed

    out = _dda_loop(scene, params, cfg, org, direction, seed, active, collide,
                    {"tr": torch.ones(org.shape[0], dtype=torch.float32, device=org.device)},
                    stats, "transmittance_dda")
    return torch.where(active, out["tr"], 1.0), out["seed"]


def sample_volume_dda(scene, params, cfg, org, direction, throughput, le, seed, active,
                      stats=None):
    """DDA volume sampling (common.glsl:458-501). Returns
    (hit, t, throughput, le, seed)."""

    def collide(c, seed, pos, d, rgba, maj, real, do_test):
        c["le"], seed = _add_emission(scene, params, cfg, pos, d * params.inv_majorant, c["th"],
                                      c["le"], seed, do_test, stats)
        mult = _albedo_mult(params, cfg, rgba, pos)
        c["th"] = torch.where(real[:, None], c["th"] * mult, c["th"])
        c["hit"] = c["hit"] | real
        return seed, real

    out = _dda_loop(scene, params, cfg, org, direction, seed, active, collide,
                    {"th": throughput, "le": le,
                     "hit": torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)},
                    stats, "sample_volume_dda")
    return out["hit"], out["t"], out["th"], out["le"], out["seed"]
