"""The render megakernel: ``render`` launches the CUDA kernel
(``volren_tpu_torch/csrc/megakernel.cu``) on CUDA tensors and runs its
plain torch version, ``render_plain``, on CPU tensors.

Both compute what volren_tpu.ops.pallas.kernel computes: for every pixel,
``spp`` volumetric path samples, returned as the per-pixel SUM over
samples of (L.rgb, alpha). A sample is DDA null-collision tracking over
the 4-level majorant pyramid with a stochastic-tricubic density tap into
the u8 brick atlas, NEE from the pre-drawn alias pool with
HG/environment MIS and a shadow ray, a stochastic-bilinear environment
tap on escape, HG scatter, Russian roulette and a bounce cap. Each
sample's random stream is seeded from (pixel, sample index) with TEA, so a
sample's draws do not depend on the schedule; both versions make the
Pallas phases' draws in the Pallas order.

The scene selects one of four variants, as the Pallas kernel's
compile-time ``use_tf`` / ``has_emi`` do (kernel.py:635-636):

- TF (``ks.tf``): the null-collision test classifies the EXACT 8-corner
  trilinear density through the LUT alpha (``d = majorant * a_tf``, no
  tricubic draws), the NEE tints the throughput by ``albedo * tf(d).rgb``
  at the collision, and the march reads the TF-baked majorant table
  ``ks.mip_tf`` without a density_scale factor;
- emission (``ks.emi_atlas``): after the density fetch and before the
  classification draw, extend lanes take a stochastic-tricubic tap (9
  draws) of the emission grid and add
  ``th * (1 - albedo) * emission_scale * (t^2, t^4, t^8) * d / majorant``.

The plain version is the Pallas kernel's strip mode with one march
substep per step: every pixel is a lane, and each step runs
regen -> march -> resolve -> NEE -> finish on all lanes under masks. The
CUDA kernel runs the same state machine in one thread per pixel.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading

import numpy as np
import torch

from . import build as _build
from ..geometry import (INV_4PI, M_PI, dot3, intersect_box, luma, mat3_vec,
                        norm3, sanitize, xform_point, xform_vec)
from ..phase import hg_phase, sample_hg
from ..rng import mul32, rng_masked, tea
from ..transfer import tf_alpha_majorant, tf_lookup
from .pack import (
    PF_ALBEDO, PF_BB_MAX, PF_BB_MIN, PF_CAM_POS, PF_CAM_XFORM,
    PF_DENSITY_SCALE, PF_EMI_NORM, PF_EMI_SCALE, PF_EMI_X, PF_ENV_INV,
    PF_ENV_STRENGTH, PF_IMP_AVG, PF_INV_MAJORANT, PF_INV_XFORM, PF_MAJORANT,
    PF_PHASE_G, PF_SHOW_ENV, PF_TF_LEFT, PF_TF_WIDTH, PF_ZCAM, PI_BOUNCES,
    PI_EMI_N_BRICKS, PI_EMI_N_SLOTS, PI_ENV_H, PI_ENV_W, PI_HEIGHT,
    PI_MAX_ITERS, PI_MIP_DIMS, PI_MIP_OFFSETS, PI_N_BRICKS, PI_N_SLOTS,
    PI_SEED, PI_SPP, PI_SPP_BASE, PI_TF_SIZE, PI_WIDTH, POOL_N, PF_SIZE,
    PI_SIZE, KernelScene,
)

MODE_INACTIVE, MODE_REGEN, MODE_EXTEND, MODE_SHADOW = 0, 1, 2, 3
# what render_plain(stats=...) counts: lanes that started a sample, took a
# DDA substep, ran a null-collision test, an emission tap, an NEE, an
# environment escape, or an HG scatter
EVENTS = ("regen", "march", "test", "emission", "nee", "escape", "scatter")
EV_NONE, EV_EXT_HIT, EV_EXT_EXIT, EV_SH_HIT, EV_SH_EXIT = 0, 1, 2, 3, 4
EV_SCATTER, EV_TEST = 5, 6

SOURCE = os.path.join(_build.CSRC, "megakernel.cu")
NVCC_FLAGS = _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# the plain torch version
# ---------------------------------------------------------------------------

def _w3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _variant(ks: KernelScene, pi: np.ndarray):
    """(use_tf, has_emi) of a dispatch; the tables and the parameter block
    must agree on it."""
    use_tf, has_emi = ks.tf is not None, ks.emi_atlas is not None
    if use_tf != (int(pi[PI_TF_SIZE]) > 0) or has_emi != (int(pi[PI_EMI_N_SLOTS]) > 0):
        raise ValueError("the parameter block was built for another scene variant")
    if use_tf and ks.mip_tf is None:
        raise ValueError("a TF scene needs its baked majorant table (pack.bake_tf_majorant)")
    if use_tf and ks.tf.lut.shape[0] != int(pi[PI_TF_SIZE]):
        raise ValueError("the parameter block was built for another LUT size")
    return use_tf, has_emi


def render_plain(ks: KernelScene, pool: torch.Tensor, pf: np.ndarray,
                 pi: np.ndarray, stats: dict | None = None) -> torch.Tensor:
    """The render kernel in plain torch, vectorized over pixel lanes.
    Returns the (H*W, 4) float32 per-pixel sums of (L.rgb, alpha). With a
    ``stats`` dict, adds the number of lanes that ran each event (keys of
    EVENTS) to it."""
    use_tf, has_emi = _variant(ks, pi)
    dev = ks.atlas.device
    f32, i32 = torch.float32, torch.int32

    def s(k):  # f32 scalar parameter as a 0-d tensor (f32 arithmetic)
        return torch.tensor(float(pf[k]), dtype=f32, device=dev)

    def s3(k, n=3):
        return tuple(s(k + d) for d in range(n))

    cam_pos, cam_m, z_cam = s3(PF_CAM_POS), s3(PF_CAM_XFORM, 9), s(PF_ZCAM)
    bb_min, bb_max = s3(PF_BB_MIN), s3(PF_BB_MAX)
    albedo, phase_g = s3(PF_ALBEDO), s(PF_PHASE_G)
    density_scale = s(PF_DENSITY_SCALE)
    inv_x, env_inv = s3(PF_INV_XFORM, 16), s3(PF_ENV_INV, 9)
    env_strength, imp_avg = s(PF_ENV_STRENGTH), s(PF_IMP_AVG)
    majorant, inv_majorant = s(PF_MAJORANT), s(PF_INV_MAJORANT)
    emi_scale, emi_norm, emi_x = s(PF_EMI_SCALE), s(PF_EMI_NORM), s3(PF_EMI_X, 16)
    show_env = bool(pf[PF_SHOW_ENV] > 0.0)
    W, H = int(pi[PI_WIDTH]), int(pi[PI_HEIGHT])
    spp, spp_base, bounces = int(pi[PI_SPP]), int(pi[PI_SPP_BASE]), int(pi[PI_BOUNCES])
    seed0 = int(np.asarray(pi[PI_SEED]).view(np.uint32))
    bx, by, bz = (int(v) for v in pi[PI_N_BRICKS:PI_N_BRICKS + 3])
    n_slots = int(pi[PI_N_SLOTS])
    EH, EW = int(pi[PI_ENV_H]), int(pi[PI_ENV_W])
    mip_dims = np.asarray(pi[PI_MIP_DIMS:PI_MIP_DIMS + 12]).reshape(4, 3)
    mip_offsets = [int(v) for v in pi[PI_MIP_OFFSETS:PI_MIP_OFFSETS + 4]]
    max_iters = int(pi[PI_MAX_ITERS])
    tf = ks.tf
    if tf is not None:  # the window as the parameter block holds it
        tf = tf._replace(window_left=s(PF_TF_LEFT), window_width=s(PF_TF_WIDTH))
    density = (ks.atlas.reshape(-1), ks.slot, ks.lo, ks.hi, (bx, by, bz), n_slots)
    if has_emi:
        emission = (ks.emi_atlas.reshape(-1), ks.emi_slot, ks.emi_lo, ks.emi_hi,
                    tuple(int(v) for v in pi[PI_EMI_N_BRICKS:PI_EMI_N_BRICKS + 3]),
                    int(pi[PI_EMI_N_SLOTS]))
    mip_t, env_t = (ks.mip_tf if use_tf else ks.mip), ks.env

    def count(event, mask):
        if stats is not None:
            stats[event] = stats.get(event, 0) + int(mask.sum())

    n = W * H
    lane = torch.arange(n, device=dev, dtype=torch.int64)
    px, py = lane % W, lane // W
    lane_u = (mul32(py, W) + px) & 0xFFFFFFFF       # uint32 py * W + px
    dim_tab = torch.tensor([8.0, 16.0, 32.0, 64.0], dtype=f32, device=dev)
    inv_dim_tab = 1.0 / dim_tab
    zero = torch.zeros(n, dtype=f32, device=dev)
    zi = torch.zeros(n, dtype=i32, device=dev)
    st = {
        "mode": torch.full((n,), MODE_REGEN, dtype=i32, device=dev),
        "event": zi.clone(), "seed": torch.zeros(n, dtype=torch.int64, device=dev),
        "po": (zero, zero, zero), "pd": (zero, zero, zero + 1.0),
        "th": (zero, zero, zero), "L": (zero, zero, zero),
        "pn": (zero, zero, zero),
        "n_paths": zi.clone(), "last_f_p": zero, "free": zi.clone(),
        "t": zero, "far": zero, "tau": zero, "mip": zero,
        "i0": (zero, zero, zero), "id": (zero, zero, zero + 1.0),
        "ri": (zero, zero, zero + 1.0), "spp_done": zi.clone(),
    }
    acc = torch.zeros(n, 4, dtype=f32, device=dev)

    def setup_ray(org, direction, mask):
        hit_box, near, far_new = intersect_box(org, direction, bb_min, bb_max)
        ip = xform_point(inv_x, org)
        idd = xform_vec(inv_x, direction)
        st["seed"], u_tau = rng_masked(st["seed"], mask & hit_box)
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
        if use_tf:  # the baked table holds majorant * tf_alpha(...)
            return mip_t[idx.long()]
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
                seed, r = rng_masked(seed, active)
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

    def trilinear(pos):
        """Exact trilinear density (kernel.py trilinear_compact): corners
        summed dx fastest, acc + w * decode."""
        p = tuple(c - 0.5 for c in pos)
        base = tuple(torch.floor(c) for c in p)
        frac = tuple(c - b for c, b in zip(p, base))
        acc = zero
        for i in range(8):
            dx, dy, dz = i & 1, (i >> 1) & 1, i >> 2
            w = ((frac[0] if dx else 1.0 - frac[0]) * (frac[1] if dy else 1.0 - frac[1])
                 * (frac[2] if dz else 1.0 - frac[2]))
            tap = (base[0] + float(dx), base[1] + float(dy), base[2] + float(dz))
            acc = acc + w * lookup_brick(tap, density)
        return density_scale * acc

    def phase_regen():
        regen = st["mode"] == MODE_REGEN
        can = regen & (st["spp_done"] < spp)
        st["mode"] = torch.where(regen & ~can, MODE_INACTIVE,
                                 torch.where(can, MODE_EXTEND, st["mode"])).to(i32)
        if not bool(can.any()):
            return
        sample_idx = (spp_base + st["spp_done"].long() + 1) & 0xFFFFFFFF
        count("regen", can)
        sel = can.nonzero().squeeze(1)
        fresh = tea(mul32(lane_u[sel], seed0), sample_idx[sel])
        st["seed"] = st["seed"].index_put((sel,), fresh)
        st["seed"], u1 = rng_masked(st["seed"], can)
        st["seed"], u2 = rng_masked(st["seed"], can)
        wf, hf = float(W), float(H)
        pix_x = (px.to(f32) + u1 - wf * 0.5) / hf
        pix_y = (py.to(f32) + u2 - hf * 0.5) / hf
        cam_local = (pix_x, pix_y, zero + 1.0 * z_cam)
        nd = norm3(mat3_vec(cam_m, norm3(cam_local)))
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
        setup_ray(org, st["pd"], can)

    def phase_march():
        march = (((st["mode"] == MODE_EXTEND) | (st["mode"] == MODE_SHADOW))
                 & (st["event"] == EV_NONE))
        is_extend = st["mode"] == MODE_EXTEND
        count("march", march)
        curr = pos_at()
        mip_i = torch.round(st["mip"]).to(i32)
        maj = majorant_at(curr, mip_i)
        # dim = 2^(3 + mip) and its exact reciprocal (mip_i is in 0..3)
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
        count("test", act)
        maj = torch.where(act, st["tau"], zero)
        # idle lanes' stale positions are pinned to the origin
        pos = _w3(act, pos_at(), (zero, zero, zero))
        if use_tf:
            # classify the exact trilinear density through the LUT alpha;
            # no tricubic draws (kernel.py:1214-1223)
            seed = st["seed"]
            d = majorant * tf_alpha_majorant(tf, trilinear(pos) * inv_majorant)
        else:
            tap, seed = stochastic_tricubic(pos, st["seed"], act)
            tap = _w3(act, tap, (zero, zero, zero))
            d = density_scale * lookup_brick(tap, density)
        if has_emi:
            # emission after the density fetch, before u_cls, on extend
            # lanes only (kernel.py:1433-1449)
            act_e = act & is_extend
            count("emission", act_e)
            etap, seed = stochastic_tricubic(xform_point(emi_x, pos), seed, act_e)
            t_e = lookup_brick(etap, emission) * emi_norm
            t2 = t_e * t_e
            e3 = (t2, t2 * t2, (t2 * t2) * (t2 * t2))
            wgt_e = d * inv_majorant
            st["L"] = tuple(
                st["L"][k] + torch.where(
                    act_e, st["th"][k] * (1.0 - albedo[k]) * (emi_scale * e3[k]) * wgt_e, zero)
                for k in range(3))
        seed, u_cls = rng_masked(seed, act)
        real = act & (u_cls * torch.clamp(maj, min=0.0) < d)
        redraw = act & ~real
        seed, u_tau = rng_masked(seed, redraw)
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
        count("nee", act)
        if use_tf:
            # tint by the LUT colour of the trilinear density at the
            # collision (kernel.py:1590-1601); no draws
            rgb = tf_lookup(tf, trilinear(_w3(act, pos_at(), (zero, zero, zero)))
                            * inv_majorant)
            mult = tuple(albedo[k] * rgb[:, k] for k in range(3))
        else:
            mult = albedo
        seed, u0 = rng_masked(st["seed"], act)
        seed, _u1 = rng_masked(seed, act)
        st["seed"] = seed
        pidx = torch.clamp((u0 * POOL_N).to(i32), 0, POOL_N - 1).long()
        row = pool[pidx]
        w_i = (row[:, 0], row[:, 1], row[:, 2])
        pdf_nee = row[:, 3]
        le = (row[:, 4], row[:, 5], row[:, 6])
        th = st["th"]
        thr = _w3(act, (th[0] * mult[0], th[1] * mult[1], th[2] * mult[2]), th)
        st["th"] = thr
        po, pd = st["po"], st["pd"]
        org = _w3(act, tuple(po[k] + st["t"] * pd[k] for k in range(3)), po)
        st["po"] = org
        st["n_paths"] = st["n_paths"] + act.to(i32)
        f_p = hg_phase(-dot3(pd, w_i), phase_g)
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
        nonlocal acc
        event = st["event"]
        sh_hit = event == EV_SH_HIT
        seed, _u_rr_sh = rng_masked(st["seed"], sh_hit)
        sh_vis = event == EV_SH_EXIT
        L = tuple(st["L"][k] + torch.where(sh_vis, st["pn"][k], zero) for k in range(3))
        thr, pd = st["th"], st["pd"]
        esc = event == EV_EXT_EXIT
        count("escape", esc)
        if bool(esc.any()):
            idir = mat3_vec(env_inv, pd)
            uu = torch.atan2(idir[2], idir[0]) * (1.0 / (2.0 * M_PI)) + 0.5
            vv = 1.0 - torch.acos(torch.clamp(idir[1], -1.0, 1.0)) * (1.0 / M_PI)
            x = uu * EW - 0.5
            y = vv * EH - 0.5
            seed, rx = rng_masked(seed, esc)
            seed, ry = rng_masked(seed, esc)
            xt = torch.floor(x + rx).to(i32)
            yt = torch.floor(y + ry).to(i32)
            xw = torch.where(xt < 0, xt + EW, xt)
            xw = torch.clamp(torch.where(xw >= EW, xw - EW, xw), 0, EW - 1)
            yc = torch.clamp(yt, 0, EH - 1)
            eidx = torch.where(esc, yc * EW + xw, 0).long()
            e = env_t[eidx]
            le_env = tuple(env_strength * e[:, k] for k in range(3))
            pdf_esc = luma(le_env) / imp_avg * INV_4PI
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
        rr_val = luma(thr)
        rr = alive & (rr_val < 0.1)
        seed, u_rr = rng_masked(seed, rr)
        killed = rr & (u_rr < 1.0 - rr_val)
        boost = 1.0 / torch.clamp(rr_val, min=1e-20)
        thr = _w3(rr & ~killed, tuple(c * boost for c in thr), thr)
        alive = alive & ~killed
        count("scatter", alive)
        st["free"] = torch.where(capped | killed, 0, st["free"]).to(i32)
        seed, s0 = rng_masked(seed, alive)
        seed, s1 = rng_masked(seed, alive)
        sc = sample_hg(pd, phase_g, s0, s1)
        f_p_sc = hg_phase(-dot3(pd, sc), phase_g)
        st["last_f_p"] = torch.where(alive, f_p_sc, st["last_f_p"])
        pd = _w3(alive, sc, pd)
        st["pd"] = pd
        end = esc | capped | killed
        alpha = torch.clamp(st["n_paths"].to(f32), 0.0, 1.0)
        sample = torch.stack([sanitize(L[0]), sanitize(L[1]), sanitize(L[2]),
                              sanitize(alpha)], dim=1)
        acc = torch.where(end[:, None], acc + sample, acc)
        st["spp_done"] = st["spp_done"] + end.to(i32)
        st["L"] = _w3(end, (zero, zero, zero), L)
        st["mode"] = torch.where(end, MODE_REGEN,
                                 torch.where(alive, MODE_EXTEND, st["mode"])).to(i32)
        st["event"] = torch.where(scatter | esc, EV_NONE, st["event"]).to(i32)
        st["seed"] = seed
        st["th"] = thr
        setup_ray(st["po"], pd, alive)

    it = 0
    while it < max_iters:
        phase_regen()
        if not bool((st["mode"] != MODE_INACTIVE).any()):
            break
        phase_march()
        resolve_tests()
        phase_nee()
        phase_finish()
        it += 1
    return acc


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()


def build(flags: list[str] = NVCC_FLAGS) -> str:
    """Compile csrc/megakernel.cu with nvcc for sm_90a into
    ``build/libvolren_megakernel_<hash>.so`` (``kernels.build.build``) and
    return its path."""
    return _build.build(SOURCE, "volren_megakernel", flags)


def _variant_name(kernel: str) -> str:
    flags = re.search(r"ILb([01])ELb([01])E", kernel)
    return f"<{flags.group(1)},{flags.group(2)}>" if flags else kernel


def resource_usage(lib_path: str) -> str:
    """ptxas's register, stack and spill lines for the library at
    ``lib_path``, one entry per kernel instantiation, named by its
    <USE_TF, HAS_EMI> template arguments."""
    return "; ".join(_build.resource_usage(lib_path, _variant_name))


def load(lib_path: str) -> ctypes.CDLL:
    """Load a built library and declare its C entry point."""
    p = ctypes.c_void_p
    return _build.load(lib_path, {"volren_render": [p] * 15 + [ctypes.c_int, p]})


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = load(build())
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_grid(prefix, atlas, slot, lo, hi, n_bricks, n_slots):
    bx, by, bz = n_bricks
    _check(atlas, f"{prefix}atlas", torch.uint8, (n_slots, 512))
    _check(slot, f"{prefix}slot", torch.int32, (bx * by * bz,))
    _check(lo, f"{prefix}lo", torch.float32, (bx * by * bz,))
    _check(hi, f"{prefix}hi", torch.float32, (bx * by * bz,))


def _launch_cuda(ks: KernelScene, pool: torch.Tensor, pf: np.ndarray,
                 pi: np.ndarray, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    use_tf, has_emi = _variant(ks, pi)
    _check_grid("", ks.atlas, ks.slot, ks.lo, ks.hi, ks.n_bricks, int(pi[PI_N_SLOTS]))
    mip = ks.mip_tf if use_tf else ks.mip
    _check(mip, "mip_tf" if use_tf else "mip", torch.float32, tuple(ks.mip.shape))
    ptrs = [0] * 5   # tf_lut, emi_atlas, emi_slot, emi_lo, emi_hi
    if use_tf:
        _check(ks.tf.lut, "tf.lut", torch.float32, (int(pi[PI_TF_SIZE]), 4))
        ptrs[0] = ks.tf.lut.data_ptr()
    if has_emi:
        _check_grid("emi_", ks.emi_atlas, ks.emi_slot, ks.emi_lo, ks.emi_hi, ks.emi_n_bricks,
                    int(pi[PI_EMI_N_SLOTS]))
        ptrs[1:] = [t.data_ptr() for t in (ks.emi_atlas, ks.emi_slot, ks.emi_lo, ks.emi_hi)]
    _check(ks.env, "env", torch.float32, (int(pi[PI_ENV_H]) * int(pi[PI_ENV_W]), 3))
    _check(pool, "pool", torch.float32, (POOL_N, 8))
    n_pix = int(pi[PI_WIDTH]) * int(pi[PI_HEIGHT])
    out = torch.empty(n_pix, 4, dtype=torch.float32, device=ks.atlas.device)
    pf = np.ascontiguousarray(pf, np.float32)
    pi = np.ascontiguousarray(pi, np.int32)
    if pf.shape != (PF_SIZE,) or pi.shape != (PI_SIZE,):
        raise ValueError("parameter block has the wrong size")
    stream = torch.cuda.current_stream(ks.atlas.device).cuda_stream
    err = (lib or _lib()).volren_render(
        pf.ctypes.data, pi.ctypes.data, ks.atlas.data_ptr(), ks.slot.data_ptr(),
        ks.lo.data_ptr(), ks.hi.data_ptr(), mip.data_ptr(), ks.env.data_ptr(),
        pool.data_ptr(), *ptrs, out.data_ptr(), n_pix, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    return out


def render(ks: KernelScene, pool: torch.Tensor, pf: np.ndarray,
           pi: np.ndarray) -> torch.Tensor:
    """Render one dispatch; returns the (H*W, 4) per-pixel sums. CUDA
    tensors launch the CUDA kernel's variant for the scene (and add one to
    ``render.launches`` and to ``render.launches_by_variant[(use_tf,
    has_emi)]``); CPU tensors run ``render_plain``."""
    if ks.atlas.is_cuda:
        out = _launch_cuda(ks, pool, pf, pi)
        render.launches += 1
        variant = (ks.tf is not None, ks.emi_atlas is not None)
        render.launches_by_variant[variant] = render.launches_by_variant.get(variant, 0) + 1
        return out
    if ks.atlas.device.type != "cpu":
        raise ValueError(f"unsupported device {ks.atlas.device}")
    return render_plain(ks, pool, pf, pi)


render.launches = 0
render.launches_by_variant = {}
