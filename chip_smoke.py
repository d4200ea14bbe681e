#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volren_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card. Phases, each
of which raises on failure (exit code non-zero, no result line):

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power
   limit from nvidia-smi;
2. build: the CUDA megakernel, its four <USE_TF, HAS_EMI> instantiations,
   and the probe kernels, compiled with nvcc for sm_90a from
   volren_tpu_torch/csrc into build/ (one nvcc per source, in parallel),
   with ptxas's registers and stack of each;
3. kernel vs plain: the CUDA kernel against its plain torch version on the
   same CUDA tensors, on a random 16^3 grid and on a 64^3 crop of
   .scene_cache/cloud512.brick, at 64x64 and 16 spp, in all four variants
   (plain, TF with the CLI's --fau LUT, emission from a temperature grid
   at half resolution, TF + emission). The kernel is built to round as the
   plain version does, so the bar is bitwise equality, and two runs must be
   bitwise identical; for the plain variant, besides, its RMSE must stay
   below 1.5x the kernel's own seed-to-seed noise with the mean within 5%;
4. kernel vs plain at the paths' shapes: one 4-spp dispatch of the whole
   cloud512 at 1024x1024 through both, for the plain path, the TF path and
   the emission path (a 256x256x128 temperature grid made from --seed),
   timed (CUDA events for the kernel), bitwise equal; the plain run also
   counts the dispatch's events for the kernel's work bound;
5. the main path: volren_tpu_torch.cli renders cloud512 at 1024x1024,
   256 spp (four 64-spp dispatches), 100 bounces, under a procedural sky
   made from --seed;
6. the TF path: the same through the CLI with --fau;
7. the emission path: the same scene with the temperature grid, through
   Renderer.trace(256);
8. the probe kernels (volren_tpu_torch/csrc/probes.cu, built in phase 2
   beside the megakernel, ptxas's lines printed): for each of the 28 Pallas
   call sites they replace (volren_tpu_torch.probes.sites), one call at the
   probe's shapes held against its plain version on the same CUDA tensors
   (bitwise; row_scan allclose at rtol 1e-5), timed beside its bound, its
   plain version and the one PyTorch call that computes the same, if any;
   then the entry point python -m volren_tpu_torch.probes, run in-process
   one site's stages at a time, every stage ok and the site's kernel
   launched.
In phases 5-8 the launch count of the path's kernel, set to 0 just before
the run, must have risen during it; in phases 5-7 the framebuffer must be
finite with a positive mean and the run must have used the CUDA kernel.

The last three lines are the card line from nvidia-smi, a JSON object
describing each kernel, and the device record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
CLOUD = os.path.join(REPO, ".scene_cache", "cloud512.brick")
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
RES, SPP, BOUNCES = 1024, 256, 100         # the paths' shapes
MAIN_CMP_SPP = 4                           # kernel vs plain at those shapes
CMP_RES, CMP_SPP = 64, 16                  # kernel vs plain version
# the kernels line: name, the scene path that runs it, the TPU kernel it replaces
KERNELS = (("megakernel", "plain", "volren_tpu/ops/pallas/kernel.py:602"),
           ("megakernel_tf", "tf", "volren_tpu/ops/pallas/kernel.py:635"),
           ("megakernel_emission", "emission", "volren_tpu/ops/pallas/kernel.py:636"))
VARIANT = {"plain": (False, False), "tf": (True, False), "emission": (False, True),
           "tf+emission": (True, True)}


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7, help="seed of the sky, grids and renders")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from volren_tpu_torch import cli
    from volren_tpu_torch import probes as probe_entry
    from volren_tpu_torch.measure import kernel_bound, path_renderer
    from volren_tpu_torch.ops.kernels import megakernel
    from volren_tpu_torch.ops.kernels import probes as probe_kernels
    from volren_tpu_torch.probes._common import Context
    from volren_tpu_torch.probes.sites import SITES
    from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params
    from volren_tpu_torch.scene.environment import Environment, procedural_sky
    from volren_tpu_torch.utils.hdr import write_hdr
    from volren_tpu_torch.voldata import DenseGrid, Volume, read_brick

    # ---- 1. toolchain
    gpu_line = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        import triton
        triton_state = f"triton {triton.__version__} imports"
    except ImportError:
        triton_state = "triton does not import"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{_run([nvcc, '--version']).splitlines()[-1]}, {triton_state}")
    print(f"card: {gpu_line}", flush=True)

    # ---- 2. build
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = pool.submit(megakernel.build), pool.submit(probe_kernels.build)
        lib, probe_lib = (b.result() for b in builds)
    print(f"build: {os.path.relpath(lib, REPO)} and {os.path.relpath(probe_lib, REPO)} in "
          f"{time.time() - t0:.2f} s; ptxas <USE_TF,HAS_EMI>: {megakernel.resource_usage(lib)}",
          flush=True)
    for line in probe_kernels.resource_usage(probe_lib):
        print(f"    ptxas probes.cu {line}", flush=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    sky_path = os.path.join(OUT_DIR, "sky.hdr")
    write_hdr(sky_path, procedural_sky(1024, 512, args.seed))
    sky = Environment(sky_path)
    dev = torch.device("cuda")

    def scene(volume, res, seed, spp, path="plain", bounces=BOUNCES):
        r = path_renderer(volume, sky, res, seed, path, bounces, device=dev)
        ks = r._kernel_scene()
        pool = build_env_pool(r._env_device, seed, 0)
        pf, pi = build_params(ks, r._trace_params(), res, res, 0, spp)
        return ks, pool, pf, pi

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    def compare(name, kernel, plain):
        """Bitwise equality of kernel and plain output; returns max abs error."""
        err = float((kernel - plain).abs().max())
        same = float((kernel == plain).all(1).float().mean())
        print(f"kernel vs plain [{name}]: max abs {err!r}, bitwise identical pixels "
              f"{same!r}", flush=True)
        if not bool(torch.isfinite(kernel).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        if not torch.equal(kernel, plain):
            raise AssertionError(f"{name}: the kernel is not bitwise equal to its plain version")
        return err

    # ---- 3. kernel vs plain version, every variant
    rng = np.random.default_rng(7)
    g16 = rng.random((16, 16, 16)).astype(np.float32) * 3.0
    g16[:4] = 0.0
    cloud = read_brick(CLOUD)
    zz, yy, xx = np.meshgrid(np.arange(96, 160), np.arange(224, 288), np.arange(224, 288),
                             indexing="ij")
    crop = cloud.lookup(np.stack([xx, yy, zz], -1))
    for name, dense in (("random16", g16), ("cloud512_crop64", crop)):
        d, h, w = dense.shape
        for path in VARIANT:
            before = dict(megakernel.render.launches_by_variant)
            inputs = scene(Volume(DenseGrid(w, h, d, dense)), CMP_RES, args.seed, CMP_SPP, path)
            a = megakernel.render(*inputs)
            b = megakernel.render(*inputs)
            if megakernel.render.launches_by_variant.get(VARIANT[path], 0) != \
                    before.get(VARIANT[path], 0) + 2:
                raise AssertionError(f"{name} {path}: the variant's launch count did not rise")
            if not torch.equal(a, b):
                raise AssertionError(f"{name} {path}: the kernel is not bitwise deterministic")
            k_ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
            p_ms, plain = host_ms(lambda: megakernel.render_plain(*inputs))
            compare(f"{name} {path}, {CMP_RES}x{CMP_RES}, {CMP_SPP} spp", a, plain)
            print(f"    kernel {k_ms!r} ms, plain {p_ms!r} ms", flush=True)
            if path != "plain":
                continue
            other = megakernel.render(*scene(Volume(DenseGrid(w, h, d, dense)), CMP_RES,
                                             args.seed + 1, CMP_SPP))
            a, plain, other = (x.cpu().numpy() / CMP_SPP for x in (a, plain, other))
            noise = float(np.sqrt(((other - a) ** 2).mean()))
            rmse = float(np.sqrt(((a - plain) ** 2).mean()))
            mean_rel = float(abs(a[:, :3].mean() - plain[:, :3].mean()) / plain[:, :3].mean())
            print(f"    rmse {rmse!r} (bar 1.5 x seed-to-seed noise {noise!r}), mean rel "
                  f"{mean_rel!r} (bar 0.05)", flush=True)
            if not (rmse < 1.5 * noise and mean_rel < 0.05):
                raise AssertionError(f"{name}: kernel disagrees with its plain version")

    # ---- 4. kernel vs plain on one dispatch at each path's shapes
    record = {}
    for kname, path, _ in KERNELS:
        inputs = scene(Volume(CLOUD), RES, args.seed, MAIN_CMP_SPP, path)
        kernel_out = megakernel.render(*inputs)
        ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
        stats = {}
        plain_ms, plain_out = host_ms(lambda: megakernel.render_plain(*inputs, stats=stats))
        label = f"cloud512 {path} {RES}x{RES}, {MAIN_CMP_SPP} spp, {BOUNCES} bounces"
        max_abs_err = compare(label, kernel_out, plain_out)
        bound_ms, bound_by, n_bytes, n_ops = kernel_bound(inputs[0], inputs[1], inputs[3], stats)
        print(f"{label}: kernel {ms!r} ms, plain {plain_ms!r} ms per dispatch; bound "
              f"{bound_ms!r} ms by {bound_by} ({n_bytes} bytes, {n_ops} f32 operations from "
              f"events {stats}) on {gpu_line}", flush=True)
        record[kname] = {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        del inputs, kernel_out, plain_out
        torch.cuda.empty_cache()

    # ---- 5-7. the three paths through the entry points a user calls
    def check_path(kname, path, run):
        variant = VARIANT[path]
        megakernel.render.launches = 0
        megakernel.render.launches_by_variant.clear()
        r, seconds = run()
        launches = megakernel.render.launches_by_variant.get(variant, 0)
        if launches <= 0 or launches != megakernel.render.launches:
            raise AssertionError(f"the {path} path did not launch (only) its CUDA kernel "
                                 f"variant: {megakernel.render.launches_by_variant}")
        if r.last_engine != "cuda_kernel":
            raise AssertionError(f"the {path} path ran {r.last_engine}")
        fb = r.framebuffer()
        if tuple(fb.shape) != (RES, RES, 4) or not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"the {path} path's framebuffer is not a finite (H, W, 4) image")
        mean = fb.mean(dim=(0, 1)).tolist()
        if not mean[0] > 0.0:
            raise AssertionError(f"the {path} path's framebuffer is black: mean {mean}")
        print(f"{path} path: cloud512 {RES}x{RES}, {SPP} spp, {BOUNCES} bounces: "
              f"{SPP / seconds!r} spp/s ({seconds!r} s, {launches} kernel launch(es), "
              f"framebuffer mean {[round(m, 4) for m in mean]}) on {gpu_line}", flush=True)
        record[kname]["launches"] = launches

    def run_cli(*extra):
        def run():
            out_png = os.path.join(OUT_DIR, f"cloud512{''.join(extra).replace('-', '_')}.png")
            r, stats = cli.run([CLOUD, sky_path, "--render", "-w", str(RES), "-h", str(RES),
                                "--spp", str(SPP), "--bounces", str(BOUNCES), "--output",
                                out_png, "--device", "cuda", *extra])
            for png in stats["outputs"]:
                if not os.path.getsize(png):
                    raise AssertionError(f"{png} is empty")
            return r, stats["seconds"]
        return run

    def run_emission():
        r = path_renderer(Volume(CLOUD), sky, RES, args.seed, "emission", device=dev)
        emi_x = r._kernel_scene().emi_x
        if emi_x is None or not np.array_equal(np.diag(emi_x)[:3], [0.5, 0.5, 0.5]):
            raise AssertionError("the emission path has no half-resolution temperature grid")
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.trace(SPP)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    check_path("megakernel", "plain", run_cli())
    check_path("megakernel_tf", "tf", run_cli("--fau"))
    check_path("megakernel_emission", "emission", run_emission)

    # ---- 8. the probe kernels: kernel vs plain at each call site's shapes
    ctx = Context(dev)

    def reps_for(fn, launches_per_call=1):
        # enough calls for ~50 ms, and few enough launches for the launch
        # queue to hold them all behind time_ms's spin (else the window
        # waits for the host again)
        ms, _ = host_ms(fn)
        return max(3, min(100, int(50.0 / max(ms, 1e-3)), 512 // launches_per_call))

    def probe_launches():
        return sum(w.launches for w in probe_kernels.WRAPPERS.values())

    def compare_probe(name, got, want, exact):
        got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
        err = 0.0
        for a, b in zip(got, want):
            err = max(err, float((a.double() - b.double()).abs().max()))
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite kernel output")
            same = torch.equal(a, b) if exact else torch.allclose(a, b, rtol=1e-5, atol=0.0)
            if not same:
                raise AssertionError(f"{name}: the kernel disagrees with its plain version "
                                     f"(max abs {err!r}, {'bitwise' if exact else 'rtol 1e-5'})")
        return err

    for site in SITES:
        case = site.make(ctx)
        before = probe_launches()
        got = case.kernel()
        per_call = probe_launches() - before
        err = compare_probe(site.name, got, case.plain(), case.exact)
        ms = ctx.time_ms(case.kernel, reps_for(case.kernel, per_call))
        plain_ms, _ = host_ms(case.plain)
        library_ms = ctx.time_ms(case.library, reps_for(case.library)) if case.library else None
        bound_ms, bound_by = case.bound()
        print(f"{site.name} ({site.family}, {site.replaces}): kernel vs plain max abs {err!r} "
              f"({'bitwise' if case.exact else 'rtol 1e-5'}); kernel {ms!r} ms, plain "
              f"{plain_ms!r} ms, library {library_ms!r} ms, bound {bound_ms!r} ms by {bound_by} "
              f"({case.n_bytes} bytes, {case.n_ops} operations) on {gpu_line}", flush=True)
        record[site.name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        del case
    torch.cuda.empty_cache()

    # ---- 8. the probes' entry point, one site's stages at a time
    covered = []
    for site in SITES:
        for wrapper in probe_kernels.WRAPPERS.values():
            wrapper.launches = 0
        if probe_entry.main(["--only", site.stages]) != 0:
            raise AssertionError(f"probe stages of {site.name} failed: {site.stages}")
        launches = probe_kernels.WRAPPERS[site.family].launches
        if launches <= 0:
            raise AssertionError(f"the stages of {site.name} did not launch {site.family}")
        record[site.name]["launches"] = launches
        covered += [name for _m, name, _fn in probe_entry.select(site.stages)]
    every = [name for _m, name, _fn in probe_entry.select(None)]
    if sorted(covered) != sorted(every):
        raise AssertionError("the sites' stages are not every probe stage exactly once")
    print(f"probes: {len(every)} stages of python -m volren_tpu_torch.probes ok, in "
          f"{len(SITES)} call sites, on {gpu_line}", flush=True)

    kernels = [dict(name=kname, route="cuda", source="volren_tpu_torch/csrc/megakernel.cu",
                    replaces=replaces, library_ms=None, **record[kname])
               for kname, _path, replaces in KERNELS]
    kernels += [dict(name=site.name, route="cuda", source="volren_tpu_torch/csrc/probes.cu",
                     replaces=site.replaces, **record[site.name]) for site in SITES]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(gpu_line)
    print(json.dumps({"kernels": [{k: entry[k] for k in keys} for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
