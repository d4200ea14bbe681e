"""Measurements of the port on one CUDA card, for PERF.md.

    python -m volren_tpu_torch.measure [--seed N] [--reps N]

Run from the repository root on a machine with a CUDA card. The scene is
the end-to-end metric's: .scene_cache/cloud512.brick at 1024x1024, 100
bounces, under the procedural sky of ``--seed`` (chip_smoke.py's). Prints:

1. spp/s: the median of ``--reps`` x ``trace(256)`` after a warm-up,
   timed on the host clock with a device sync at both ends;
2. one trace(256) taken apart: the kernel time of each of its four 64-spp
   dispatches (CUDA events), the host time of the NEE pool draw and of the
   parameter block, and the device busy share, the kernels' sum over the
   median trace(256);
3. the device time torch.profiler attributes over one trace(256);
4. multiply-add contraction: the kernel built without ``-fmad=false``
   against the shipped build, alternating off/on/on/off, at 16 spp, with
   the image difference against the seed-to-seed noise;
5. spp/s against resolution and bounce cap (trace(64), median of 3).

Every line carries the card's name and power limit as nvidia-smi gives
them.
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

from .ops.kernels import megakernel
from .ops.kernels.pack import build_env_pool, build_params
from .renderer import DISPATCH_SPP, Renderer
from .scene.environment import Environment, procedural_sky
from .utils.hdr import write_hdr
from .voldata import Volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOUD = os.path.join(REPO, ".scene_cache", "cloud512.brick")
OUT_DIR = os.path.join(REPO, "build", "measure")
RES, BOUNCES, METRIC_SPP = 1024, 100, 256


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7, help="seed of the sky and the renders")
    ap.add_argument("--reps", type=int, default=5, help="trace(256) calls for the median")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    lib_path = megakernel.build()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; ptxas: "
          f"{megakernel.resource_usage(lib_path)}", flush=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    sky_path = os.path.join(OUT_DIR, "sky.hdr")
    write_hdr(sky_path, procedural_sky(1024, 512, args.seed))
    sky = Environment(sky_path)

    def renderer(res, bounces=BOUNCES):
        r = Renderer(device="cuda")
        r.volume = Volume(CLOUD)
        r.scale_and_move_to_unit_cube()
        r.set_environment(sky)
        r.bounces = bounces
        r.seed = args.seed
        r.init(res, res)
        r.commit()
        return r

    # ---- 1. the end-to-end metric
    r = renderer(RES)
    r.render(DISPATCH_SPP)
    walls = []
    for _ in range(args.reps):
        r.reset()
        walls.append(_wall(lambda: r.trace(METRIC_SPP)))
    rates = [METRIC_SPP / w for w in walls]
    wall = statistics.median(walls)
    fb = r.framebuffer()
    print(f"spp/s, cloud512 {RES}x{RES}, {BOUNCES} bounces, {args.reps} x trace({METRIC_SPP}): "
          f"median {METRIC_SPP / wall!r}, all {rates!r}; framebuffer mean "
          f"{fb.mean((0, 1)).tolist()!r} [{card}]", flush=True)

    # ---- 2. one trace(256) taken apart
    ks, tp = r._kernel_scene(), r._trace_params()
    kernel_ms, pool_ms, params_ms = [], [], []
    for base in range(0, METRIC_SPP, DISPATCH_SPP):
        t = time.perf_counter()
        pool = build_env_pool(r._env_device, args.seed, base)
        _sync()
        pool_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        pf, pi = build_params(ks, tp, RES, RES, base, DISPATCH_SPP)
        params_ms.append((time.perf_counter() - t) * 1e3)
        kernel_ms.append(_event_ms(lambda: megakernel.render(ks, pool, pf, pi))[0])
    print(f"trace({METRIC_SPP}) by dispatch: kernel ms {kernel_ms!r}, pool draw ms "
          f"{pool_ms!r}, parameter block ms {params_ms!r}; device busy share "
          f"{sum(kernel_ms) / (wall * 1e3)!r} of the median trace [{card}]", flush=True)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
