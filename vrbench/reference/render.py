"""The reference render: the render kernel's plain version, frozen, in torch.

A frozen copy of ``volren_tpu_torch.ops.kernels.megakernel.render_plain``
on its per-step schedule, for the two variants the benchmark's scenes run
(density alone, and density with an emission grid; no transfer function,
no packed table), with the helpers it calls (``ops/geometry.py``,
``ops/rng.py``, ``ops/phase.py``) and the NEE pool's draw
(``pack.pool_uniforms``, ``envmap.sample_environment_alias``) written in.
It imports nothing of the program.

Its lanes are any set of (pixel, sample) pairs of a frame, each with its
own camera and its own dispatch's pool: ``Job`` lists the dispatches of one
framebuffer state, and ``render_states`` traces every (pixel, sample) of
every state in one lane set, then folds each pixel's samples in sample
order and each dispatch into the running mean as ``Renderer.trace`` does.
A lane's draws depend only on its pixel, its sample and its seed, so the
result is the program's bit for bit wherever the program computes what it
states.

``dtype`` sets the floating-point type of every table and every
operation: float32 is the reference; bfloat16 is the control, the same
computation in the precision below the configuration's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .scene import (DISPATCH_SPP, PF_ALBEDO, PF_BB_MAX, PF_BB_MIN, PF_DENSITY_SCALE,
                    PF_EMI_NORM, PF_EMI_SCALE, PF_EMI_X, PF_ENV_INV, PF_ENV_STRENGTH,
                    PF_IMP_AVG, PF_INV_MAJORANT, PF_INV_XFORM, PF_PHASE_G, PF_SHOW_ENV,
                    POOL_N, STEP_BUDGET, Scene, camera_slots)

M_PI = 3.14159265358979323846
INV_4PI = 1.0 / (4.0 * M_PI)
LUMA_W = (0.212671, 0.715160, 0.072169)
MASK = 0xFFFFFFFF
_INV_2_24 = 1.0 / float(0x01000000)
MODE_INACTIVE, MODE_REGEN, MODE_EXTEND, MODE_SHADOW = 0, 1, 2, 3
EV_NONE, EV_EXT_HIT, EV_EXT_EXIT, EV_SH_HIT, EV_SH_EXIT = 0, 1, 2, 3, 4
EV_SCATTER, EV_TEST = 5, 6


class Job(NamedTuple):
    """One framebuffer state to work out: the camera it was rendered from,
    the render seed, the frame's size, the dispatches since the last reset
    as (first sample, samples), and the flat pixel indices (y * width + x)
    to trace."""

    cam_pos: np.ndarray
    cam_dir: np.ndarray
    cam_up: np.ndarray
    fov: float
    seed: int
    width: int
    height: int
    dispatches: tuple
    pixels: np.ndarray


def dispatches_of(spp_per_trace: list[int]) -> tuple:
    """The dispatches of trace calls of these sample counts from a reset:
    each trace splits into dispatches of at most DISPATCH_SPP."""
    out, sample = [], 0
    for spp in spp_per_trace:
        while spp > 0:
            n = min(DISPATCH_SPP, spp)
            out.append((sample, n))
            sample += n
            spp -= n
    return tuple(out)


# ---- helpers (ops/geometry.py, ops/rng.py, ops/phase.py) ----

def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _tea(v0, v1, n_rounds: int = 32):
    v0, v1 = torch.broadcast_tensors(v0.to(torch.int64), v1.to(torch.int64))
    s0 = 0
    for _ in range(n_rounds):
        s0 = (s0 + 0x9E3779B9) & MASK
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4))) & MASK
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761E))) & MASK
    return v0


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm3(v, eps: float = 1e-20):
    inv = 1.0 / torch.clamp(torch.sqrt(_dot3(v, v)), min=eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _mat3_vec(m, v):
    return (v[0] * m[0] + v[1] * m[1] + v[2] * m[2],
            v[0] * m[3] + v[1] * m[4] + v[2] * m[5],
            v[0] * m[6] + v[1] * m[7] + v[2] * m[8])


def _xform_point(m16, p):
    return (p[0] * m16[0] + p[1] * m16[1] + p[2] * m16[2] + m16[3],
            p[0] * m16[4] + p[1] * m16[5] + p[2] * m16[6] + m16[7],
            p[0] * m16[8] + p[1] * m16[9] + p[2] * m16[10] + m16[11])


def _xform_vec(m16, v):
    return (v[0] * m16[0] + v[1] * m16[1] + v[2] * m16[2],
            v[0] * m16[4] + v[1] * m16[5] + v[2] * m16[6],
            v[0] * m16[8] + v[1] * m16[9] + v[2] * m16[10])


def _luma(c):
    return c[0] * LUMA_W[0] + c[1] * LUMA_W[1] + c[2] * LUMA_W[2]


def _sanitize(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _intersect_box(org, direction, bb_min, bb_max):
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


def _align(n, v):
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
    return _norm3(out)


def _hg_phase(cos_t, g):
    denom = 1.0 + g * g + 2.0 * g * cos_t
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp(denom, min=1e-12)))


def _sample_hg(direction, g, u0, u1):
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u0)
    small = torch.abs(g) < 1e-4
    cos_aniso = (1.0 + g * g - sqr * sqr) / (2.0 * torch.where(small, torch.ones_like(g), g))
    cos_t = torch.where(small, 1.0 - 2.0 * u0, cos_aniso)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * M_PI) * u1
    return _align(direction, (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t))


def _w3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


# ---- the NEE pool (pack.pool_uniforms, envmap.sample_environment_alias) ----

def pool_uniforms(seed: int, spp_base: int) -> np.ndarray:
    """The (POOL_N, 2) float32 uniforms of the pool of (seed, spp_base)."""
    rng = np.random.default_rng((int(seed) * 2654435761 + int(spp_base)) % 2**63)
    out = np.empty((POOL_N, 2), np.float32)
    rng.random(dtype=np.float32, out=out)
    return out


def draw_pool(sky, u2: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The (n, 8) pool [w, pdf, strength * texel radiance, 0] of the
    uniforms ``u2`` over the sky's alias rows."""
    table = sky.alias.to(dtype)
    n = int(table.shape[0])
    dim = int(round(n ** 0.5))
    scaled = u2[:, 0] * n
    j = torch.clamp(scaled.to(torch.int32), 0, n - 1)
    frac_x = scaled - j.to(dtype)
    row = table[j.long()]
    prob = row[:, 0]
    keep = u2[:, 1] < prob
    texel = torch.where(keep, j, row[:, 1].to(torch.int32))
    pdf = torch.where(keep, row[:, 2], row[:, 3])
    le_texel = torch.where(keep[:, None], row[:, 4:7], row[:, 7:10])
    frac_y = torch.where(keep, u2[:, 1] / torch.clamp(prob, min=1e-12),
                         (u2[:, 1] - prob) / torch.clamp(1.0 - prob, min=1e-12))
    px = texel % dim
    py = texel // dim
    inv_dim = 1.0 / dim
    uv_x = (px.to(dtype) + frac_x) * inv_dim
    uv_y = (py.to(dtype) + torch.clamp(frac_y, 0.0, 1.0)) * inv_dim
    theta = torch.clamp(1.0 - uv_y, 0.0, 1.0) * M_PI
    phi = (torch.clamp(uv_x, 0.0, 1.0) * 2.0 - 1.0) * M_PI
    sin_t = torch.sin(theta)
    w_local = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)],
                          dim=-1)
    m = [[float(x) for x in r] for r in sky.transform]
    x, y, z = w_local[:, 0], w_local[:, 1], w_local[:, 2]
    w_i = torch.stack([x * m[j][0] + y * m[j][1] + z * m[j][2] for j in range(3)], dim=-1)
    le = sky.strength * le_texel
    return torch.cat([w_i, pdf[:, None], le, torch.zeros_like(pdf)[:, None]], dim=1).contiguous()


# ---- the lanes ----

def trace_lanes(scene: Scene, cams: torch.Tensor, pools: torch.Tensor, lane_px, lane_py,
                lane_sample, lane_cam, lane_pool, lane_seed0, width: int, height: int,
                dtype=torch.float32):
    """Trace one sample on each lane: lane i is sample ``lane_sample[i]`` of
    pixel (``lane_px[i]``, ``lane_py[i]``) of a ``width`` x ``height``
    frame, seen from camera row ``lane_cam[i]`` of ``cams`` ((n_cams, 13):
    position, row-major view -> world rotation, z_cam) with the pool
    ``pools[lane_pool[i]]`` and the render seed ``lane_seed0[i]``. Returns
    ((n, 4) results (L.rgb, alpha), (n,) capped)."""
    pf = scene.pf
    dev = scene.density.atlas.device
    f32, i32 = dtype, torch.int32

    def s(k):
        return torch.tensor(float(pf[k]), dtype=f32, device=dev)

    def s3(k, n=3):
        return tuple(s(k + d) for d in range(n))

    cams = cams.to(f32)
    bb_min, bb_max = s3(PF_BB_MIN), s3(PF_BB_MAX)
    albedo, phase_g = s3(PF_ALBEDO), s(PF_PHASE_G)
    density_scale = s(PF_DENSITY_SCALE)
    inv_x, env_inv = s3(PF_INV_XFORM, 16), s3(PF_ENV_INV, 9)
    env_strength, imp_avg = s(PF_ENV_STRENGTH), s(PF_IMP_AVG)
    inv_majorant = s(PF_INV_MAJORANT)
    emi_scale, emi_norm, emi_x = s(PF_EMI_SCALE), s(PF_EMI_NORM), s3(PF_EMI_X, 16)
    show_env = bool(pf[PF_SHOW_ENV] > 0.0)
    has_emi = scene.emission is not None
    W, H, bounces = int(width), int(height), int(scene.bounces)
    g = scene.density
    mip_dims = np.asarray(g.mip_dims).reshape(4, 3)
    mip_offsets = [int(v) for v in g.mip_offsets]
    budget = STEP_BUDGET

    def grid_of(t):
        return (t.atlas, t.slot, t.lo.to(f32), t.hi.to(f32), t.n_bricks, t.n_slots)

    density = grid_of(g)
    emission = grid_of(scene.emission) if has_emi else None
    mip_t, env_t = g.mip.to(f32), scene.sky.texels.to(f32)
    EH, EW = scene.sky.hw
    pools = pools.to(f32).reshape(-1, 8)

    def rng(state, active):
        new = (state * 1664525 + 1013904223) & MASK
        u = (new & 0x00FFFFFF).to(f32) * _INV_2_24
        return torch.where(active, new, state), u

    s_h = torch.tensor(float(H), dtype=f32, device=dev)
    dim_tab = torch.tensor([8.0, 16.0, 32.0, 64.0], dtype=f32, device=dev)
    inv_dim_tab = 1.0 / dim_tab

    def setup_ray(org, direction, mask):
        hit_box, near, far_new = _intersect_box(org, direction, bb_min, bb_max)
        ip = _xform_point(inv_x, org)
        idd = _xform_vec(inv_x, direction)
        st["seed"], u_tau = rng(st["seed"], mask & hit_box)
        st["t"] = torch.where(mask, near + 1e-6, st["t"])
        st["far"] = torch.where(mask, torch.where(hit_box, far_new, zero), st["far"])
        st["tau"] = torch.where(mask, -torch.log(1.0 - u_tau), st["tau"])
        st["mip"] = torch.where(mask, zero + 3.0, st["mip"])
        st["i0"] = _w3(mask, ip, st["i0"])
        st["id"] = _w3(mask, idd, st["id"])
        st["ri"] = _w3(mask, tuple(1.0 / d for d in idd), st["ri"])

    def pos_at():
        return tuple(st["i0"][k] + st["t"] * st["id"][k] for k in range(3))

    def majorant_at(curr, mip_i):
        ix, iy, iz = (torch.floor(c).to(i32) for c in curr)
        idx = torch.zeros(n, dtype=i32, device=dev)
        for m in range(4):
            mz, my, mx = (int(v) for v in mip_dims[m])
            bxm = torch.clamp(ix >> (3 + m), 0, mx - 1)
            bym = torch.clamp(iy >> (3 + m), 0, my - 1)
            bzm = torch.clamp(iz >> (3 + m), 0, mz - 1)
            idx = torch.where(mip_i == m, mip_offsets[m] + (bzm * my + bym) * mx + bxm, idx)
        return density_scale * mip_t[idx.long()]

    def stochastic_tricubic(pos, seed, active):
        iip = tuple(torch.floor(p - 0.5) for p in pos)
        t = tuple((p - 0.5) - ip for p, ip in zip(pos, iip))
        t3 = tuple(tt * (tt * tt) for tt in t)
        sum_wt = tuple((1.0 / 6.0) * (-tt * tt * tt + 3.0 * tt * tt - 3.0 * tt + 1.0)
                       for tt in t)
        idxf = (zero, zero, zero)
        taps = (
            (1.0, tuple((1.0 / 6.0) * (3 * c - 6 * tt * tt + 4.0) for tt, c in zip(t, t3))),
            (2.0, tuple((1.0 / 6.0) * (-3 * c + 3 * tt * tt + 3 * tt + 1.0)
                        for tt, c in zip(t, t3))),
            (3.0, tuple((1.0 / 6.0) * c for c in t3)),
        )
        for tap_idx, wv in taps:
            sum_wt = tuple(a + b for a, b in zip(wv, sum_wt))
            rs = []
            for _ in range(3):
                seed, r = rng(seed, active)
                rs.append(r)
            idxf = tuple(torch.where(rs[k] < wv[k] / torch.clamp(sum_wt[k], min=1e-3),
                                     zero + tap_idx, idxf[k]) for k in range(3))
        return tuple(iip[k] + idxf[k] - 1.0 for k in range(3)), seed

    def lookup_brick(tap, grid):
        atlas, slot_t, lo_t, hi_t, (nbx, nby, nbz), slots = grid
        vx = torch.clamp(tap[0].to(i32), 0, nbx * 8 - 1)
        vy = torch.clamp(tap[1].to(i32), 0, nby * 8 - 1)
        vz = torch.clamp(tap[2].to(i32), 0, nbz * 8 - 1)
        bidx = ((vz >> 3) * (nby * nbx) + (vy >> 3) * nbx + (vx >> 3)).long()
        voff = (vz & 7) * 64 + (vy & 7) * 8 + (vx & 7)
        slot = torch.clamp(slot_t[bidx], 0, slots - 1).long()
        unorm = atlas[slot * 512 + voff].to(f32) * (1.0 / 255.0)
        lo, hi = lo_t[bidx], hi_t[bidx]
        return lo + unorm * (hi - lo)

    def phase_regen():
        can = st["mode"] == MODE_REGEN
        st["mode"] = torch.where(can, MODE_EXTEND, st["mode"]).to(i32)
        st["seed"] = torch.where(can, lane_seed, st["seed"])
        st["seed"], u1 = rng(st["seed"], can)
        st["seed"], u2 = rng(st["seed"], can)
        wf, hf = float(W), float(H)
        pix_x = (px.to(f32) + u1 - wf * 0.5) / s_h
        pix_y = (py.to(f32) + u2 - hf * 0.5) / s_h
        cam = cams[cam_id]
        cam_pos = (cam[:, 0], cam[:, 1], cam[:, 2])
        cam_m = tuple(cam[:, 3 + k] for k in range(9))
        cam_local = (pix_x, pix_y, zero + 1.0 * cam[:, 12])
        nd = _norm3(_mat3_vec(cam_m, _norm3(cam_local)))
        org = _w3(can, tuple(zero + c for c in cam_pos), st["po"])
        st["po"] = org
        st["pd"] = _w3(can, nd, st["pd"])
        one = zero + 1.0
        st["th"] = _w3(can, (one, one, one), st["th"])
        st["L"] = _w3(can, (zero, zero, zero), st["L"])
        st["pn"] = _w3(can, (zero, zero, zero), st["pn"])
        st["n_paths"] = torch.where(can, 0, st["n_paths"]).to(i32)
        st["last_f_p"] = torch.where(can, zero, st["last_f_p"])
        st["free"] = torch.where(can, 1, st["free"]).to(i32)
        st["event"] = torch.where(can, EV_NONE, st["event"]).to(i32)
        st["steps"] = torch.where(can, 0, st["steps"]).to(i32)
        setup_ray(org, st["pd"], can)

    def phase_march():
        march = (((st["mode"] == MODE_EXTEND) | (st["mode"] == MODE_SHADOW))
                 & (st["event"] == EV_NONE))
        is_extend = st["mode"] == MODE_EXTEND
        st["steps"] = st["steps"] + march.to(i32)
        curr = pos_at()
        mip_i = torch.round(st["mip"]).to(i32)
        maj = majorant_at(curr, mip_i)
        dim = dim_tab[mip_i.long()]
        inv_dim = inv_dim_tab[mip_i.long()]
        dts = []
        for k in range(3):
            ri = st["ri"][k]
            offs = torch.where(ri >= 0.0, dim + 0.5, zero - 0.5)
            dts.append((torch.floor(curr[k] * inv_dim) * dim + offs - curr[k]) * ri)
        dt = torch.minimum(dts[0], torch.minimum(dts[1], dts[2]))
        t_adv = st["t"] + dt
        tau_adv = st["tau"] - maj * dt
        mip_up = torch.clamp(st["mip"] + 0.25, max=3.0)
        collide = march & (tau_adv <= 0.0)
        st["t"] = torch.where(march, torch.where(
            collide, t_adv + tau_adv / torch.clamp(maj, min=1e-20), t_adv), st["t"])
        exited = march & (st["t"] >= st["far"])
        test = collide & ~exited
        free_step = march & ~collide
        st["tau"] = torch.where(free_step, tau_adv, st["tau"])
        st["mip"] = torch.where(free_step, mip_up, st["mip"])
        st["tau"] = torch.where(test, maj, st["tau"])
        st["mip"] = torch.where(test, mip_up, st["mip"])
        st["event"] = torch.where(test, EV_TEST, torch.where(
            exited, torch.where(is_extend, EV_EXT_EXIT, EV_SH_EXIT), st["event"])).to(i32)

    def resolve_tests():
        act = st["event"] == EV_TEST
        if not bool(act.any()):
            return
        is_extend = st["mode"] == MODE_EXTEND
        maj = torch.where(act, st["tau"], zero)
        pos = _w3(act, pos_at(), (zero, zero, zero))
        tap, seed = stochastic_tricubic(pos, st["seed"], act)
        tap = _w3(act, tap, (zero, zero, zero))
        d = density_scale * lookup_brick(tap, density)
        if has_emi:
            act_e = act & is_extend
            etap, seed = stochastic_tricubic(_xform_point(emi_x, pos), seed, act_e)
            t_e = lookup_brick(etap, emission) * emi_norm
            t2 = t_e * t_e
            e3 = (t2, t2 * t2, (t2 * t2) * (t2 * t2))
            wgt_e = d * inv_majorant
            st["L"] = tuple(
                st["L"][k] + torch.where(
                    act_e, st["th"][k] * (1.0 - albedo[k]) * (emi_scale * e3[k]) * wgt_e, zero)
                for k in range(3))
        seed, u_cls = rng(seed, act)
        real = act & (u_cls * torch.clamp(maj, min=0.0) < d)
        redraw = act & ~real
        seed, u_tau = rng(seed, redraw)
        st["tau"] = torch.where(redraw, -torch.log(1.0 - u_tau), st["tau"])
        st["mip"] = torch.where(redraw, torch.clamp(st["mip"] - 2.0, min=0.0), st["mip"])
        st["event"] = torch.where(real & is_extend, EV_EXT_HIT, torch.where(
            real & ~is_extend, EV_SH_HIT,
            torch.where(redraw, EV_NONE, st["event"]))).to(i32)
        st["seed"] = seed

    def phase_nee():
        act = st["event"] == EV_EXT_HIT
        if not bool(act.any()):
            return
        mult = albedo
        seed, u0 = rng(st["seed"], act)
        seed, _u1 = rng(seed, act)
        st["seed"] = seed
        pidx = torch.clamp((u0 * POOL_N).to(i32), 0, POOL_N - 1).long()
        row = pools[pool_id * POOL_N + pidx]
        le = (row[:, 4], row[:, 5], row[:, 6])
        w_i = (row[:, 0], row[:, 1], row[:, 2])
        pdf_nee = row[:, 3]
        th = st["th"]
        thr = _w3(act, (th[0] * mult[0], th[1] * mult[1], th[2] * mult[2]), th)
        st["th"] = thr
        po, pd = st["po"], st["pd"]
        org = _w3(act, tuple(po[k] + st["t"] * pd[k] for k in range(3)), po)
        st["po"] = org
        st["n_paths"] = st["n_paths"] + act.to(i32)
        f_p = _hg_phase(-_dot3(pd, w_i), phase_g)
        if show_env:
            mis = (pdf_nee * pdf_nee) / torch.clamp(pdf_nee * pdf_nee + f_p * f_p, min=1e-32)
        else:
            mis = zero + 1.0
        has_nee = act & (pdf_nee > 0.0)
        wgt = mis * f_p / torch.clamp(pdf_nee, min=1e-20)
        pend = tuple(thr[k] * wgt * le[k] for k in range(3))
        st["pn"] = _w3(has_nee, pend, st["pn"])
        st["mode"] = torch.where(has_nee, MODE_SHADOW, st["mode"]).to(i32)
        st["event"] = torch.where(act, torch.where(has_nee, EV_NONE, EV_SCATTER),
                                  st["event"]).to(i32)
        setup_ray(org, _w3(has_nee, w_i, pd), has_nee)

    def phase_finish():
        event = st["event"]
        sh_hit = event == EV_SH_HIT
        seed, _u_rr_sh = rng(st["seed"], sh_hit)
        sh_vis = event == EV_SH_EXIT
        L = tuple(st["L"][k] + torch.where(sh_vis, st["pn"][k], zero) for k in range(3))
        thr, pd = st["th"], st["pd"]
        esc = event == EV_EXT_EXIT
        if bool(esc.any()):
            idir = _mat3_vec(env_inv, pd)
            uu = torch.atan2(idir[2], idir[0]) * (1.0 / (2.0 * M_PI)) + 0.5
            vv = 1.0 - torch.acos(torch.clamp(idir[1], -1.0, 1.0)) * (1.0 / M_PI)
            x = uu * EW - 0.5
            y = vv * EH - 0.5
            seed, rx = rng(seed, esc)
            seed, ry = rng(seed, esc)
            xt = torch.floor(x + rx).to(i32)
            yt = torch.floor(y + ry).to(i32)
            xw = torch.where(xt < 0, xt + EW, xt)
            xw = torch.clamp(torch.where(xw >= EW, xw - EW, xw), 0, EW - 1)
            yc = torch.clamp(yt, 0, EH - 1)
            eidx = torch.where(esc, yc * EW + xw, 0).long()
            e = env_t[eidx]
            le_env = tuple(env_strength * e[:, k] for k in range(3))
            pdf_esc = _luma(le_env) / imp_avg * INV_4PI
            a2 = st["last_f_p"] * st["last_f_p"]
            mis_esc = torch.where(st["n_paths"] > 0,
                                  a2 / torch.clamp(a2 + pdf_esc * pdf_esc, min=1e-32), zero + 1.0)
            add = esc & (st["free"] != 0)
            if show_env:
                L = tuple(L[k] + torch.where(add, thr[k] * mis_esc * le_env[k], zero)
                          for k in range(3))
        scatter = sh_hit | sh_vis | (event == EV_SCATTER)
        capped = scatter & (st["n_paths"] >= bounces)
        alive = scatter & ~capped
        rr_val = _luma(thr)
        rr = alive & (rr_val < 0.1)
        seed, u_rr = rng(seed, rr)
        killed = rr & (u_rr < 1.0 - rr_val)
        boost = 1.0 / torch.clamp(rr_val, min=1e-20)
        thr = _w3(rr & ~killed, tuple(c * boost for c in thr), thr)
        alive = alive & ~killed
        st["free"] = torch.where(capped | killed, 0, st["free"]).to(i32)
        seed, s0 = rng(seed, alive)
        seed, s1 = rng(seed, alive)
        sc = _sample_hg(pd, phase_g, s0, s1)
        f_p_sc = _hg_phase(-_dot3(pd, sc), phase_g)
        st["last_f_p"] = torch.where(alive, f_p_sc, st["last_f_p"])
        pd = _w3(alive, sc, pd)
        st["pd"] = pd
        end = esc | capped | killed
        alpha = torch.clamp(st["n_paths"].to(f32), 0.0, 1.0)
        sample = torch.stack([_sanitize(L[0]), _sanitize(L[1]), _sanitize(L[2]),
                              _sanitize(alpha)], dim=1)
        st["res"] = torch.where(end[:, None], sample, st["res"])
        st["L"] = _w3(end, (zero, zero, zero), L)
        st["mode"] = torch.where(end, MODE_INACTIVE,
                                 torch.where(alive, MODE_EXTEND, st["mode"])).to(i32)
        st["event"] = torch.where(scatter | esc, EV_NONE, st["event"]).to(i32)
        st["seed"] = seed
        st["th"] = thr
        setup_ray(st["po"], pd, alive)

    def phase_cap():
        over = (((st["mode"] == MODE_EXTEND) | (st["mode"] == MODE_SHADOW))
                & (st["steps"] >= budget))
        st["capped"] = st["capped"] | over
        st["mode"] = torch.where(over, MODE_INACTIVE, st["mode"]).to(i32)

    n = int(lane_px.shape[0])
    px, py = lane_px.to(dev), lane_py.to(dev)
    cam_id, pool_id = lane_cam.to(dev).long(), lane_pool.to(dev).long()
    lane_u = (_mul32(py, W) + px) & 0xFFFFFFFF
    lane_seed = _tea(_mul32(lane_u, lane_seed0.to(dev)), (lane_sample.to(dev) + 1) & 0xFFFFFFFF)
    zero = torch.zeros(n, dtype=f32, device=dev)
    zi = torch.zeros(n, dtype=i32, device=dev)
    st = {
        "mode": torch.full((n,), MODE_REGEN, dtype=i32, device=dev),
        "event": zi.clone(), "seed": torch.zeros(n, dtype=torch.int64, device=dev),
        "po": (zero, zero, zero), "pd": (zero, zero, zero + 1.0),
        "th": (zero, zero, zero), "L": (zero, zero, zero), "pn": (zero, zero, zero),
        "n_paths": zi.clone(), "last_f_p": zero, "free": zi.clone(),
        "t": zero, "far": zero, "tau": zero, "mip": zero,
        "i0": (zero, zero, zero), "id": (zero, zero, zero + 1.0),
        "ri": (zero, zero, zero + 1.0), "steps": zi.clone(),
        "res": torch.zeros(n, 4, dtype=f32, device=dev),
        "capped": torch.zeros(n, dtype=torch.bool, device=dev),
    }
    phase_regen()
    res, capped, sel = st["res"], st["capped"], None
    all_px, all_py, all_cam, all_pool = px, py, cam_id, pool_id
    for _ in range(budget):
        phase_march()
        resolve_tests()
        phase_nee()
        phase_finish()
        phase_cap()
        live = st["mode"] != MODE_INACTIVE
        n_live = int(live.sum())
        if n_live == 0:
            break
        if 2 * n_live <= n and n_live < n:     # set the ended samples aside
            res, capped = _put_lanes(res, capped, sel, st)
            keep = live.nonzero().squeeze(1)
            sel = keep if sel is None else sel[keep]
            st = {k: tuple(x[keep] for x in v) if isinstance(v, tuple) else v[keep]
                  for k, v in st.items()}
            px, py, cam_id, pool_id = (all_px[sel], all_py[sel], all_cam[sel], all_pool[sel])
            n = keep.shape[0]
            zero = torch.zeros(n, dtype=f32, device=dev)
    res, capped = _put_lanes(res, capped, sel, st)
    return res, capped


def _put_lanes(res, capped, sel, st):
    if sel is None:
        return st["res"], st["capped"]
    return res.index_copy(0, sel, st["res"]), capped.index_copy(0, sel, st["capped"])


def render_states(scene: Scene, jobs: list, dtype=torch.float32) -> list:
    """The framebuffer values (len(job.pixels), 4) of each job's pixels after
    its dispatches, as ``Renderer.trace`` leaves them: each dispatch's
    per-pixel sum of its samples in sample order (a capped sample adds
    nothing), then ``(band * prev + sum) / sample`` from a reset. All the
    jobs' lanes are traced together."""
    dev = scene.density.atlas.device
    cams, pools, lanes, spans = [], [], [], []
    n_lanes = 0
    for j, job in enumerate(jobs):
        cams.append(camera_slots(job.cam_pos, job.cam_dir, job.cam_up, job.fov))
        pix = np.asarray(job.pixels, np.int64)
        for spp_base, count in job.dispatches:
            pool_id = len(pools)
            pools.append(pool_uniforms(job.seed, spp_base))
            samples = np.repeat(np.arange(spp_base, spp_base + count, dtype=np.int64), len(pix))
            pp = np.tile(pix, count)
            lanes.append((pp % job.width, pp // job.width, samples,
                          np.full(pp.shape, j), np.full(pp.shape, pool_id),
                          np.full(pp.shape, job.seed, np.int64)))
            spans.append((j, count, n_lanes))
            n_lanes += pp.size
    cols = [torch.as_tensor(np.concatenate([lane[k] for lane in lanes]), dtype=torch.int64)
            for k in range(6)]
    u2 = torch.as_tensor(np.concatenate(pools), device=dev).to(dtype)
    pool_t = draw_pool(scene.sky, u2, dtype)
    cam_t = torch.as_tensor(np.stack(cams), device=dev)
    width = {job.width for job in jobs}
    height = {job.height for job in jobs}
    if len(width) != 1 or len(height) != 1:
        raise ValueError("the jobs of one call render one frame size")
    res, capped = trace_lanes(scene, cam_t, pool_t, *cols, width.pop(), height.pop(), dtype)
    out = []
    for j, job in enumerate(jobs):
        m = len(job.pixels)
        band = torch.zeros(m, 4, dtype=dtype, device=dev)
        sample = 0
        for (jj, count, off) in spans:
            if jj != j:
                continue
            acc = torch.zeros(m, 4, dtype=dtype, device=dev)
            for k in range(count):
                seg = slice(off + k * m, off + (k + 1) * m)
                acc = torch.where(capped[seg, None], acc, acc + res[seg])
            prev = sample
            sample += count
            band = (band * prev + acc) / sample
        out.append(band.float())
    return out
