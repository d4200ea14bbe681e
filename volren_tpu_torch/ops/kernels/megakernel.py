"""The render megakernel: ``render`` launches the CUDA kernel
(``volren_tpu_torch/csrc/megakernel.cu``) on CUDA tensors and runs its
plain torch version, ``render_plain``, on CPU tensors.

Both compute what volren_tpu.ops.pallas.kernel computes in its no-TF,
no-emission variant: for every pixel, ``spp`` volumetric path samples,
returned as the per-pixel SUM over samples of (L.rgb, alpha). A sample
is DDA null-collision tracking over the 4-level majorant pyramid with a
stochastic-tricubic density tap into the u8 brick atlas, NEE from the
pre-drawn alias pool with HG/environment MIS and a shadow ray, a
stochastic-bilinear environment tap on escape, HG scatter, Russian
roulette and a bounce cap. Each sample's random stream is seeded from
(pixel, sample index) with TEA, so a sample's draws do not depend on the
schedule; both versions make the Pallas phases' draws in the Pallas
order.

The plain version is the Pallas kernel's strip mode with one march
substep per step: every pixel is a lane, and each step runs
regen -> march -> resolve -> NEE -> finish on all lanes under masks. The
CUDA kernel runs the same state machine in one thread per pixel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..geometry import (INV_4PI, M_PI, dot3, intersect_box, luma, mat3_vec,
                        norm3, sanitize, xform_point, xform_vec)
from ..phase import hg_phase, sample_hg
from ..rng import mul32, rng_masked, tea
from .pack import (
    PF_ALBEDO, PF_BB_MAX, PF_BB_MIN, PF_CAM_POS, PF_CAM_XFORM,
    PF_DENSITY_SCALE, PF_ENV_INV, PF_ENV_STRENGTH, PF_IMP_AVG, PF_INV_XFORM,
    PF_PHASE_G, PF_SHOW_ENV, PF_ZCAM, PI_BOUNCES, PI_ENV_H, PI_ENV_W,
    PI_HEIGHT, PI_MAX_ITERS, PI_MIP_DIMS, PI_MIP_OFFSETS, PI_N_BRICKS,
    PI_N_SLOTS, PI_SEED, PI_SPP, PI_SPP_BASE, PI_WIDTH, POOL_N, PF_SIZE,
    PI_SIZE, KernelScene,
)

MODE_INACTIVE, MODE_REGEN, MODE_EXTEND, MODE_SHADOW = 0, 1, 2, 3
EV_NONE, EV_EXT_HIT, EV_EXT_EXIT, EV_SH_HIT, EV_SH_EXIT = 0, 1, 2, 3, 4
EV_SCATTER, EV_TEST = 5, 6

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
SOURCE = os.path.join(_REPO_ROOT, "volren_tpu_torch", "csrc", "megakernel.cu")
BUILD_DIR = os.path.join(_REPO_ROOT, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # no multiply-add contraction: the kernel rounds every
              # operation as the plain torch version's separate ops do
              "-fmad=false"]


# ---------------------------------------------------------------------------
# the plain torch version
# ---------------------------------------------------------------------------

def _w3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def render_plain(ks: KernelScene, pool: torch.Tensor, pf: np.ndarray,
                 pi: np.ndarray) -> torch.Tensor:
    """The render kernel in plain torch, vectorized over pixel lanes.
    Returns the (H*W, 4) float32 per-pixel sums of (L.rgb, alpha)."""
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

    atlas = ks.atlas.reshape(-1)
    slot_t, lo_t, hi_t, mip_t, env_t = ks.slot, ks.lo, ks.hi, ks.mip, ks.env

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

    def lookup_density_brick(tap):
        vx = torch.clamp(tap[0].to(i32), 0, bx * 8 - 1)
        vy = torch.clamp(tap[1].to(i32), 0, by * 8 - 1)
        vz = torch.clamp(tap[2].to(i32), 0, bz * 8 - 1)
        bidx = ((vz >> 3) * (by * bx) + (vy >> 3) * bx + (vx >> 3)).long()
        voff = (vz & 7) * 64 + (vy & 7) * 8 + (vx & 7)
        slot = torch.clamp(slot_t[bidx], 0, n_slots - 1).long()
        unorm = atlas[slot * 512 + voff].to(f32) * (1.0 / 255.0)
        lo, hi = lo_t[bidx], hi_t[bidx]
        return lo + unorm * (hi - lo)

    def phase_regen():
        regen = st["mode"] == MODE_REGEN
        can = regen & (st["spp_done"] < spp)
        st["mode"] = torch.where(regen & ~can, MODE_INACTIVE,
                                 torch.where(can, MODE_EXTEND, st["mode"])).to(i32)
        if not bool(can.any()):
            return
        sample_idx = (spp_base + st["spp_done"].long() + 1) & 0xFFFFFFFF
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
        maj = torch.where(act, st["tau"], zero)
        tap, seed = stochastic_tricubic(pos_at(), st["seed"], act)
        tap = _w3(act, tap, (zero, zero, zero))
        d = density_scale * lookup_density_brick(tap)
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
        seed, u0 = rng_masked(st["seed"], act)
        seed, _u1 = rng_masked(seed, act)
        st["seed"] = seed
        pidx = torch.clamp((u0 * POOL_N).to(i32), 0, POOL_N - 1).long()
        row = pool[pidx]
        w_i = (row[:, 0], row[:, 1], row[:, 2])
        pdf_nee = row[:, 3]
        le = (row[:, 4], row[:, 5], row[:, 6])
        th = st["th"]
        thr = _w3(act, (th[0] * albedo[0], th[1] * albedo[1], th[2] * albedo[2]), th)
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
    """Compile csrc/megakernel.cu with nvcc for sm_90a into a shared library
    under build/ and return its path. The library's name carries a
    hash of the source and the flags, so an edit always rebuilds. nvcc's
    output (with ptxas's resource usage) is kept beside it as ``.log``."""
    with open(SOURCE, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libvolren_megakernel_{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def resource_usage(lib_path: str) -> str:
    """ptxas's register, stack and spill lines for the library at ``lib_path``."""
    with open(f"{lib_path}.log") as f:
        return "; ".join(line.split(":", 1)[-1].strip() for line in f
                         if "registers" in line or "stack frame" in line)


def load(lib_path: str) -> ctypes.CDLL:
    """Load a built library and declare its C entry point."""
    lib = ctypes.CDLL(lib_path)
    p = ctypes.c_void_p
    lib.volren_render.argtypes = [p, p, p, p, p, p, p, p, p, p, ctypes.c_int, p]
    lib.volren_render.restype = ctypes.c_int
    return lib


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


def _launch_cuda(ks: KernelScene, pool: torch.Tensor, pf: np.ndarray,
                 pi: np.ndarray, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    bx, by, bz = ks.n_bricks
    n_bricks = bx * by * bz
    _check(ks.atlas, "atlas", torch.uint8, (int(pi[PI_N_SLOTS]), 512))
    for name in ("slot", "lo", "hi"):
        t = getattr(ks, name)
        _check(t, name, torch.int32 if name == "slot" else torch.float32, (n_bricks,))
    _check(ks.mip, "mip", torch.float32)
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
        ks.lo.data_ptr(), ks.hi.data_ptr(), ks.mip.data_ptr(), ks.env.data_ptr(),
        pool.data_ptr(), out.data_ptr(), n_pix, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    return out


def render(ks: KernelScene, pool: torch.Tensor, pf: np.ndarray,
           pi: np.ndarray) -> torch.Tensor:
    """Render one dispatch; returns the (H*W, 4) per-pixel sums. CUDA
    tensors launch the CUDA kernel (and add one to ``render.launches``);
    CPU tensors run ``render_plain``."""
    if ks.atlas.is_cuda:
        out = _launch_cuda(ks, pool, pf, pi)
        render.launches += 1
        return out
    if ks.atlas.device.type != "cpu":
        raise ValueError(f"unsupported device {ks.atlas.device}")
    return render_plain(ks, pool, pf, pi)


render.launches = 0
