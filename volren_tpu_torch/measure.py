"""Measurements of the port on one CUDA card, for PERF.md.

    python -m volren_tpu_torch.measure [--seed N] [--reps N]

Run from the repository root on a machine with a CUDA card. The scenes are
the end-to-end metric's: .scene_cache/cloud512.brick at 1024x1024, 100
bounces, under the procedural sky of ``--seed`` (chip_smoke.py's), in the
kernel's three user paths: the plain density render, the TF render
(cloud512 with the CLI's ``--fau`` LUT) and the emission render (cloud512
with the half-resolution temperature grid of ``temperature_grid``).
Prints:

1. spp/s of each path: the median of ``--reps`` x ``trace(256)`` after a
   warm-up, timed on the host clock with a device sync at both ends;
2. one trace(256) of each path taken apart: the kernel time of each of
   its four 64-spp dispatches (CUDA events), the host time of the NEE pool
   draw and of the parameter block, and the device busy share, the
   kernels' sum over the median trace(256);
3. the device time torch.profiler attributes over one plain trace(256);
4. multiply-add contraction: the kernel built without ``-fmad=false``
   against the shipped build, alternating off/on/on/off, at 16 spp, with
   the image difference against the seed-to-seed noise;
5. spp/s of the plain path against resolution and bounce cap (trace(64),
   median of 3);
6. the kernel's schedule, from its STATS instantiation
   (``megakernel.render_stats``) on one 64-spp dispatch of each path (and
   of TF + emission) at 1024x1024 and of the plain path at 512x512 and
   256x256: SIMT efficiency of the loop and of a march substep, the
   blocks' durations and the tail, capped samples, march substeps per
   sample and the dispatch's events, beside the render kernel's
   CUDA-event ms on the same dispatch and its work bound from those
   events;
7. the oracle engine (csrc/oracle.cu, ``engine = "oracle"``): with DDA
   tracking on the same three paths at 1024x1024, trace(16), and every
   <USE_DDA, USE_TF, HAS_EMI> instantiation at 256x256, trace(4) (the
   global-majorant ones are --no-dda's): spp/s, the median of 3 traces
   after a warm-up; the kernel's CUDA-event ms of the trace's launches
   from zero, per launch and per pass, with the tracking loop calls its
   8192-iteration cap stopped; the same passes through the kernel's STATS
   instantiation (``oracle.trace_stats``: SIMT efficiency of the bounce
   loop and of a tracking-loop iteration, the blocks' durations and the
   tail, the plain version's counts), and the work bound
   (``oracle_bound``) and its share from those counts.
   ``--oracle-only`` runs this section alone.

Every line carries the card's name and power limit as nvidia-smi gives
them. The module also holds what chip_smoke.py shares with it: the three
paths' renderers and the kernels' work bounds (``kernel_bound``,
``oracle_bound``).
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .cli import FAU_LUT
from .ops.kernels import megakernel, oracle
from .ops.kernels.pack import build_env_pool, build_params
from .renderer import DISPATCH_SPP, Renderer
from .scene.environment import Environment, procedural_sky
from .scene.transferfunc import TransferFunction
from .utils.hdr import write_hdr
from .voldata import DenseGrid, Volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOUD = os.path.join(REPO, ".scene_cache", "cloud512.brick")
OUT_DIR = os.path.join(REPO, "build", "measure")
RES, BOUNCES, METRIC_SPP = 1024, 100, 256

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12      # dense bf16 on the tensor cores

# float32 operations of one event, counted by hand from csrc/megakernel.cu
# (each add, multiply, divide, compare, min/max, conversion and
# transcendental is one): a march substep with the per-iteration
# bookkeeping of the finish phase, a null-collision test (plain or TF:
# 8-corner trilinear and the LUT alpha), an emission tap, an NEE (plain or
# with the TF tint: a second trilinear and 3 LUT channels), an escape with
# its accumulation, an HG scatter with its ray set-up, a sample start.
OPS_PER_EVENT = {
    "regen": 120, "march": 73, "test": 183, "test_tf": 154, "emission": 202,
    "nee": 116, "nee_tf": 268, "escape": 74, "scatter": 157,
}


def kernel_bound(ks, pool: torch.Tensor, pi: np.ndarray, stats: dict):
    """The least time the card could take for one dispatch:
    max(bytes / peak bytes/s, float32 operations / peak float32/s).
    Bytes: every table the kernel reads, once, and the (n_pix, 4) float32
    output, once. Operations: the events this dispatch's data needs, from
    ``render_plain(..., stats=stats)`` on the same inputs, times
    OPS_PER_EVENT. Returns (ms, "bytes" | "operations", bytes, operations)."""
    use_tf, has_emi = ks.tf is not None, ks.emi_atlas is not None
    tables = [ks.atlas, ks.slot, ks.lo, ks.hi, ks.mip_tf if use_tf else ks.mip, ks.env, pool]
    if use_tf:
        tables.append(ks.tf.lut)
    if has_emi:
        tables += [ks.emi_atlas, ks.emi_slot, ks.emi_lo, ks.emi_hi]
    n_pix = int(pi[0]) * int(pi[1])
    n_bytes = sum(t.numel() * t.element_size() for t in tables) + n_pix * 4 * 4
    weights = dict(OPS_PER_EVENT)
    if use_tf:
        weights["test"], weights["nee"] = weights["test_tf"], weights["nee_tf"]
    ops = sum(weights[k] * int(stats.get(k, 0)) for k in megakernel.EVENTS)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, ops)


def denoiser_bound(features, n: int, h: int, w: int, train: bool = False):
    """The least time the card could take for the UNet denoiser
    (models/denoiser.py) on n (3, h, w) images: max(bytes / peak bytes/s,
    operations / peak rate), the operations being its convolutions' 2
    multiply-add operations per weight and output pixel -- bf16 ones at the
    bf16 tensor-core peak, the f32 head at the f32 peak -- three times that
    for a training step (forward, the input's and the weights' gradients).
    Bytes: the input, the output (or the target) and the parameters, once.
    Returns (ms, "bytes" | "operations")."""
    levels = len(features) - 1
    convs = []                                     # (in, out, level)
    ch = 3
    for lvl, f in enumerate(features[:-1]):
        convs += [(ch, f, lvl), (f, f, lvl)]
        ch = f
    convs += [(ch, features[-1], levels), (features[-1], features[-1], levels)]
    ch = features[-1]
    for lvl, f in reversed(list(enumerate(features[:-1]))):
        convs += [(ch + f, f, lvl), (f, f, lvl)]
        ch = f

    # a level's pixels: avg_pool floors each halving
    bf16 = sum(2 * 9 * cin * cout * (h >> lvl) * (w >> lvl) for cin, cout, lvl in convs) * n
    f32 = 2 * 9 * ch * 3 * h * w * n
    params = sum(9 * cin * cout + cout for cin, cout, _ in convs) + 9 * ch * 3 + 3
    reps = 3 if train else 1
    t_ops = reps * (bf16 / PEAK_BF16_S + f32 / PEAK_F32_S)
    t_bytes = (2 * n * 3 * h * w * 4 + params * 4) / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# float32 operations of one counted unit of the oracle's plain version
# (ops/tracer.py, ``stats``), counted by hand from csrc/oracle.cu as
# OPS_PER_EVENT is: a path (TEA, camera ray, escape term, framebuffer
# update), a bounce (the 9-level warp with its lookup, two ray set-ups,
# phase functions, MIS, roulette, HG scatter), an iteration of a
# global-majorant loop (a stochastic-tricubic density tap; TF: the 8-corner
# trilinear and the LUT), an iteration of a DDA loop (majorant and step;
# TF: its LUT), a DDA density test, and an emission tap.
ORACLE_OPS = {"paths": 520, "bounce_iters": 500, "iter": 130, "iter_tf": 230,
              "dda_iter": 85, "dda_iter_tf": 105, "dda_test": 130, "dda_test_tf": 230,
              "emission": 155}


def oracle_bound(scene, n_pix: int, stats: dict):
    """The least time the card could take for one oracle launch, as
    ``kernel_bound`` works it out: max(bytes / peak bytes/s, float32
    operations / peak float32/s). Bytes: every table the kernel reads,
    once, and the (n_pix, 4) float32 framebuffer read and written once.
    Operations: the loop iterations, tests, bounces and paths counted on
    the same inputs (``stats``: the plain version's, or the STATS
    instantiation's, of the launch's passes) times ORACLE_OPS. Returns
    (ms, "bytes" | "operations", bytes, operations)."""
    g, env = scene.density, scene.env
    tables = [g.atlas, g.slot, g.lo, g.hi, g.mip_maj, env.envmap, *env.imp_mips]
    if scene.tf is not None:
        tables.append(scene.tf.lut)
    if scene.emission is not None:
        e = scene.emission
        tables += [e.atlas, e.slot, e.lo, e.hi]
    n_bytes = sum(t.numel() * t.element_size() for t in tables) + 2 * n_pix * 4 * 4
    tf = "_tf" if scene.tf is not None else ""
    w = ORACLE_OPS
    ops = w["paths"] * stats.get("paths", 0) + w["bounce_iters"] * stats.get("bounce_iters", 0)
    ops += w["emission"] * stats.get("emission", 0)
    for loop in ("sample_volume", "transmittance"):
        ops += w["iter" + tf] * stats.get(f"{loop}_iters", 0)
        ops += w["dda_iter" + tf] * stats.get(f"{loop}_dda_iters", 0)
        ops += w["dda_test" + tf] * stats.get(f"{loop}_dda_tests", 0)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, ops)


ORACLE_SPP = 16      # section 7's trace(16) at 1024x1024
ORACLE_RES_SMALL, ORACLE_SPP_SMALL = 256, 4   # and its trace(4) of every variant at 256x256
ORACLE_VARIANTS = [(dda, tf, emi) for dda in (True, False) for tf in (False, True)
                   for emi in (False, True)]


def oracle_metric(r: Renderer, label: str, card: str, spp: int = ORACLE_SPP,
                  reps: int = 3) -> dict:
    """Section 7 for one committed renderer with the oracle engine set: its
    spp/s over ``reps`` x trace(spp) after a warm-up; the kernel's
    CUDA-event ms of trace_passes(spp) from zero (the launches a trace(spp)
    makes), median of 3; the same passes through the STATS instantiation
    (the same framebuffer): its counters, and the work bound from them
    (``oracle_bound``, exact for these passes). Returns the numbers."""
    r.render(spp)
    walls = []
    for _ in range(reps):
        r.reset()
        walls.append(_wall(lambda: r.trace(spp)))
    scene, tp, cfg = r._scene_tables(), r._trace_params(), r._config()
    zero = torch.zeros_like(r.framebuffer())
    capped = torch.zeros(1, dtype=torch.int32, device=r.device)
    before = oracle.trace_pass.launches
    fb = oracle.trace_passes(scene, tp, cfg, zero, 1, spp, capped=capped)
    launches = oracle.trace_pass.launches - before
    ms = sorted(_event_ms(lambda: oracle.trace_passes(scene, tp, cfg, zero, 1, spp))[0]
                for _ in range(3))
    got, st = oracle.trace_stats(scene, tp, cfg, zero, 1, spp)
    if not torch.equal(got, fb):
        raise AssertionError(f"{label}: the STATS instantiation's framebuffer differs")
    w, h = r._width, r._height
    bound_ms, bound_by, _, n_ops = oracle_bound(scene, w * h, st)
    out = {"spp_s": spp / statistics.median(walls), "rates": [spp / x for x in walls],
           "launch_ms": ms[1] / launches, "pass_ms": ms[1] / spp,
           "launches": launches, "capped": int(capped), "bound_ms": bound_ms,
           "bound_by": bound_by, "share": bound_ms / ms[1], "stats": st,
           "mean": r.framebuffer().mean((0, 1)).tolist()}
    counts = {k: v for k, v in st.items() if isinstance(v, int)}
    print(f"oracle, {label} {w}x{h}, {r.bounces} bounces, {reps} x trace({spp}): spp/s median "
          f"{out['spp_s']!r}, all {out['rates']!r}; trace_passes(1, {spp}) from zero: "
          f"{launches} launch(es), kernel ms {ms!r} (CUDA events), {out['launch_ms']!r} ms a "
          f"launch, {out['pass_ms']!r} ms a pass; bound {bound_ms!r} ms by {bound_by} "
          f"({n_ops!r} f32 operations from the STATS counts), share {out['share']!r}; SIMT "
          f"efficiency bounce loop {st['simt_bounce']!r}, tracking loop {st['simt_track']!r}; "
          f"{st['blocks']} blocks, block ms min/median/max {st['block_ms']!r}, span "
          f"{st['span_ms']!r} ms, tail {st['tail_ms']!r} ms; counts "
          f"{counts}; loop calls capped at {cfg.max_steps}: {out['capped']}; framebuffer mean "
          f"{out['mean']!r}; engine {r.last_engine} [{card}]", flush=True)
    return out


def temperature_grid(w: int, h: int, d: int, seed: int) -> DenseGrid:
    """A smooth hot core, clip(1 - r / (0.35 * w), 0, 1)^2 around a point
    near the box centre (jittered by ``seed``), as a w x h x d DenseGrid
    with transform diag(2, 2, 2, 1): it covers a 2w x 2h x 2d density
    index box at half its resolution."""
    c = (np.array([w, h, d]) * 0.5 * (1.0 + 0.1 * np.random.default_rng(seed).uniform(-1, 1, 3)))
    z, y, x = np.meshgrid(np.arange(d, dtype=np.float32), np.arange(h, dtype=np.float32),
                          np.arange(w, dtype=np.float32), indexing="ij")
    r = np.sqrt((x + 0.5 - c[0]) ** 2 + (y + 0.5 - c[1]) ** 2 + (z + 0.5 - c[2]) ** 2)
    hot = np.clip(1.0 - r / (0.35 * w), 0.0, 1.0) ** 2
    return DenseGrid(w, h, d, hot.astype(np.float32), np.diag([2.0, 2.0, 2.0, 1.0]))


def path_renderer(volume: Volume, sky: Environment, res: int, seed: int, path: str = "plain",
                  bounces: int = BOUNCES, device="cuda") -> Renderer:
    """A committed Renderer for one of the kernel's paths: "plain", "tf"
    (the --fau LUT), "emission" (a temperature grid at half the density
    grid's resolution, from ``seed``) or "tf+emission"."""
    r = Renderer(device=device)
    r.volume = volume
    r.scale_and_move_to_unit_cube()
    r.set_environment(sky)
    r.bounces = bounces
    r.seed = seed
    if "tf" in path:
        r.set_transferfunc(TransferFunction(FAU_LUT))
    if "emission" in path:
        w, h, d = (int(v) // 2 for v in volume.current_grid().index_extent())
        volume.update_grid_frame(0, temperature_grid(w, h, d, seed), "temperature")
    r.init(res, res)
    r.commit()
    return r


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _sync():
    torch.cuda.synchronize()


def _wall(fn) -> float:
    """Seconds of ``fn()`` on the host clock, synced on the device."""
    _sync()
    t = time.perf_counter()
    fn()
    _sync()
    return time.perf_counter() - t


def _event_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _metric(r: Renderer, label: str, reps: int, seed: int, card: str):
    """Sections 1-2 for one path: spp/s over ``reps`` x trace(256), then one
    trace(256) taken apart."""
    r.render(DISPATCH_SPP)
    walls = []
    for _ in range(reps):
        r.reset()
        walls.append(_wall(lambda: r.trace(METRIC_SPP)))
    rates = [METRIC_SPP / w for w in walls]
    wall = statistics.median(walls)
    fb = r.framebuffer()
    print(f"spp/s, {label} {RES}x{RES}, {BOUNCES} bounces, {reps} x trace({METRIC_SPP}): "
          f"median {METRIC_SPP / wall!r}, all {rates!r}; framebuffer mean "
          f"{fb.mean((0, 1)).tolist()!r}; engine {r.last_engine} [{card}]", flush=True)

    ks, tp = r._kernel_scene(), r._trace_params()
    kernel_ms, pool_ms, params_ms = [], [], []
    for base in range(0, METRIC_SPP, DISPATCH_SPP):
        t = time.perf_counter()
        pool = build_env_pool(r._env_device, seed, base)
        _sync()
        pool_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        pf, pi = build_params(ks, tp, RES, RES, base, DISPATCH_SPP)
        params_ms.append((time.perf_counter() - t) * 1e3)
        kernel_ms.append(_event_ms(lambda: megakernel.render(ks, pool, pf, pi))[0])
    print(f"{label} trace({METRIC_SPP}) by dispatch: kernel ms {kernel_ms!r}, pool draw ms "
          f"{pool_ms!r}, parameter block ms {params_ms!r}; device busy share "
          f"{sum(kernel_ms) / (wall * 1e3)!r} of the median trace [{card}]", flush=True)
    return ks, tp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7, help="seed of the sky and the renders")
    ap.add_argument("--reps", type=int, default=5, help="trace(256) calls for the median")
    ap.add_argument("--oracle-only", action="store_true", help="run section 7 alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    lib_path = megakernel.build()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; ptxas: "
          f"{megakernel.resource_usage(lib_path)}", flush=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    sky_path = os.path.join(OUT_DIR, "sky.hdr")
    write_hdr(sky_path, procedural_sky(1024, 512, args.seed))
    sky = Environment(sky_path)

    def renderer(res, bounces=BOUNCES, path="plain"):
        return path_renderer(Volume(CLOUD), sky, res, args.seed, path, bounces)

    if args.oracle_only:
        oracle_section(renderer, card)
        return 0

    # ---- 1-2. the end-to-end metric of each path, and a trace taken apart
    r = renderer(RES)
    ks, tp = _metric(r, "cloud512", args.reps, args.seed, card)
    for path in ("tf", "emission"):
        rp = renderer(RES, path=path)
        _metric(rp, f"cloud512 {path}", args.reps, args.seed, card)
        del rp
        torch.cuda.empty_cache()

    # ---- 3. what torch.profiler sees over one trace(256)
    from torch.profiler import ProfilerActivity, profile

    r.reset()
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.trace(METRIC_SPP)
        _sync()
    rows = sorted(((getattr(e, "self_device_time_total", 0.0), e.key, e.count)
                   for e in prof.key_averages()), reverse=True)
    total = sum(row[0] for row in rows)
    print(f"torch.profiler over trace({METRIC_SPP}): self device time {total / 1e3!r} ms; top: "
          + "; ".join(f"{key[:48]} {us / 1e3!r} ms x{n}" for us, key, n in rows[:3])
          + f" [{card}]", flush=True)

    # ---- 4. multiply-add contraction on vs off
    fmad_path = megakernel.build([f for f in megakernel.NVCC_FLAGS if f != "-fmad=false"])
    libs = {"off": None, "on": megakernel.load(fmad_path)}
    pool = build_env_pool(r._env_device, args.seed, 0)
    pf, pi = build_params(ks, tp, RES, RES, 0, 16)

    def launch(which):
        return megakernel._launch_cuda(ks, pool, pf, pi, lib=libs[which])

    launch("off"), launch("on")
    times = {"off": [], "on": []}
    for _ in range(3):
        for which in ("off", "on", "on", "off"):
            times[which].append(_event_ms(lambda: launch(which))[0])
    a, b = (launch(w).cpu().numpy() / 16 for w in ("off", "on"))
    pf2, pi2 = build_params(ks, tp._replace(seed=args.seed + 1), RES, RES, 0, 16)
    other = megakernel._launch_cuda(ks, build_env_pool(r._env_device, args.seed + 1, 0),
                                    pf2, pi2).cpu().numpy() / 16
    print(f"16-spp kernel ms, -fmad=false {times['off']!r}, contraction on {times['on']!r} "
          f"(ptxas on: {megakernel.resource_usage(fmad_path)}); image on vs off: rmse "
          f"{float(np.sqrt(((a - b) ** 2).mean()))!r}, seed-to-seed noise "
          f"{float(np.sqrt(((other - a) ** 2).mean()))!r}, identical pixels "
          f"{float((a == b).all(1).mean())!r} [{card}]", flush=True)

    # ---- 5. resolution and bounce cap
    for res, bounces in ((256, 100), (512, 100), (1024, 100), (1024, 10), (1024, 1)):
        rr = renderer(res, bounces)
        rr.render(16)
        rates = []
        for _ in range(3):
            rr.reset()
            rates.append(DISPATCH_SPP / _wall(lambda: rr.trace(DISPATCH_SPP)))
        print(f"{res}x{res}, {bounces} bounces: spp/s median {statistics.median(rates)!r}, "
              f"all {rates!r}; alpha mean {float(rr.framebuffer()[..., 3].mean())!r} [{card}]",
              flush=True)
        del rr

    # ---- 6. the schedule's counters
    del r
    torch.cuda.empty_cache()
    for path, res in (("plain", RES), ("tf", RES), ("emission", RES), ("tf+emission", RES),
                      ("plain", 512), ("plain", 256)):
        schedule_stats(renderer(res, path=path), f"{path} {res}x{res}", args.seed, card)
        torch.cuda.empty_cache()

    # ---- 7. the oracle engine
    oracle_section(renderer, card)
    return 0


def oracle_section(renderer, card: str):
    print(f"ptxas oracle <USE_DDA,USE_TF,HAS_EMI>: {oracle.resource_usage(oracle.build())}",
          flush=True)
    paths = {(False, False): "plain", (True, False): "tf", (False, True): "emission",
             (True, True): "tf+emission"}
    runs = [(RES, (True, tf, emi), ORACLE_SPP) for tf, emi in list(paths)[:3]]
    runs += [(ORACLE_RES_SMALL, v, ORACLE_SPP_SMALL) for v in ORACLE_VARIANTS]
    for res, (dda, tf, emi), spp in runs:
        r = renderer(res, path=paths[(tf, emi)])
        r.engine = "oracle"
        r._use_dda = dda
        oracle_metric(r, f"cloud512 {paths[(tf, emi)]} <{int(dda)},{int(tf)},{int(emi)}>", card,
                      spp)
        del r
        torch.cuda.empty_cache()


def schedule_stats(r: Renderer, label: str, seed: int, card: str) -> dict:
    """Section 6 for one committed renderer: its first 64-spp dispatch
    through the render kernel (CUDA events, 3 runs) and once through the
    STATS instantiation; returns the counters."""
    ks, tp = r._kernel_scene(), r._trace_params()
    pool = build_env_pool(r._env_device, seed, 0)
    pf, pi = build_params(ks, tp, r._width, r._height, 0, DISPATCH_SPP)
    out = megakernel.render(ks, pool, pf, pi)
    ms = [_event_ms(lambda: megakernel.render(ks, pool, pf, pi))[0] for _ in range(3)]
    got, st = megakernel.render_stats(ks, pool, pf, pi)
    if not torch.equal(got, out):
        raise AssertionError(f"{label}: the STATS instantiation's image differs from render's")
    bound_ms, bound_by, _, _ = kernel_bound(ks, pool, pi, st)
    print(f"schedule, {label}, one {DISPATCH_SPP}-spp dispatch: kernel ms {ms!r}, bound "
          f"{bound_ms!r} ms by {bound_by}; SIMT efficiency loop {st['simt_loop']!r}, march "
          f"substep {st['simt_march']!r} ({st['loop']} loop and {st['march_issues']} substep "
          f"issues); {st['blocks']} blocks, block ms min/median/max {st['block_ms']!r}, span "
          f"{st['span_ms']!r} ms, tail {st['tail_ms']!r} ms; samples {st['regen']}, capped "
          f"{st['capped']}, march substeps {st['march']} (max of a sample {st['max_steps']}); "
          f"events {dict((k, st[k]) for k in megakernel.EVENTS)} [{card}]", flush=True)
    return st


if __name__ == "__main__":
    sys.exit(main())
