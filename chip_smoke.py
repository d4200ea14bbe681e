#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volren_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card. Phases, each
of which raises on failure (exit code non-zero, no result line):

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power
   limit from nvidia-smi;
2. build: the CUDA megakernel, compiled with nvcc for sm_90a from
   volren_tpu_torch/csrc into build/;
3. kernel vs plain: the CUDA kernel against its plain torch version on the
   same CUDA tensors, on a random 16^3 grid and on a 64^3 crop of
   .scene_cache/cloud512.brick, at 64x64 and 16 spp. The kernel is built
   to round as the plain version does, so the bar is bitwise equality;
   besides, its RMSE must stay below 1.5x the kernel's own seed-to-seed
   noise with the mean within 5%, and two runs must be bitwise identical;
4. kernel vs plain at the main path's shapes: one 4-spp dispatch of the
   whole cloud512 at 1024x1024 through both, timed, and bitwise equal;
5. the main path: volren_tpu_torch.cli renders cloud512 at 1024x1024,
   256 spp (four 64-spp dispatches), 100 bounces, under a procedural sky
   made from --seed; the PNG must exist, the framebuffer must be finite
   with a positive mean, and the kernel's launch count must have risen
   during the run.

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

REPO = os.path.dirname(os.path.abspath(__file__))
CLOUD = os.path.join(REPO, ".scene_cache", "cloud512.brick")
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
RES, SPP, BOUNCES = 1024, 256, 100         # the main path
MAIN_CMP_SPP = 4                           # kernel vs plain at the main path's shapes
CMP_RES, CMP_SPP = 64, 16                  # kernel vs plain version


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7, help="seed of the sky and the renders")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from volren_tpu_torch import cli
    from volren_tpu_torch.ops.kernels import megakernel
    from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params
    from volren_tpu_torch.renderer import Renderer
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
    lib = megakernel.build()
    print(f"build: {os.path.relpath(lib, REPO)} in {time.time() - t0:.2f} s; ptxas: "
          f"{megakernel.resource_usage(lib)}", flush=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    sky_path = os.path.join(OUT_DIR, "sky.hdr")
    write_hdr(sky_path, procedural_sky(1024, 512, args.seed))
    sky = Environment(sky_path)
    dev = torch.device("cuda")

    def scene(volume, res, seed, spp, bounces=BOUNCES):
        r = Renderer(device=dev)
        r.volume = volume
        r.scale_and_move_to_unit_cube()
        r.set_environment(sky)
        r.bounces = bounces
        r.seed = seed
        r.init(res, res)
        r.commit()
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

    # ---- 3. kernel vs plain version
    rng = np.random.default_rng(7)
    g16 = rng.random((16, 16, 16)).astype(np.float32) * 3.0
    g16[:4] = 0.0
    cloud = read_brick(CLOUD)
    zz, yy, xx = np.meshgrid(np.arange(96, 160), np.arange(224, 288), np.arange(224, 288),
                             indexing="ij")
    crop = cloud.lookup(np.stack([xx, yy, zz], -1))
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

    for name, dense in (("random16", g16), ("cloud512_crop64", crop)):
        d, h, w = dense.shape
        inputs = scene(Volume(DenseGrid(w, h, d, dense)), CMP_RES, args.seed, CMP_SPP)
        a = megakernel.render(*inputs)
        b = megakernel.render(*inputs)
        k_ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
        p_ms, plain = host_ms(lambda: megakernel.render_plain(*inputs))
        other = megakernel.render(*scene(Volume(DenseGrid(w, h, d, dense)),
                                         CMP_RES, args.seed + 1, CMP_SPP))
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the kernel is not bitwise deterministic")
        compare(f"{name}, {CMP_RES}x{CMP_RES}, {CMP_SPP} spp", a, plain)
        a, plain, other = (x.cpu().numpy() / CMP_SPP for x in (a, plain, other))
        noise = float(np.sqrt(((other - a) ** 2).mean()))
        rmse = float(np.sqrt(((a - plain) ** 2).mean()))
        mean_rel = float(abs(a[:, :3].mean() - plain[:, :3].mean()) / plain[:, :3].mean())
        print(f"    rmse {rmse!r} (bar 1.5 x seed-to-seed noise {noise!r}), mean rel "
              f"{mean_rel!r} (bar 0.05); kernel {k_ms!r} ms, plain {p_ms!r} ms", flush=True)
        if not (rmse < 1.5 * noise and mean_rel < 0.05):
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
    if megakernel.render.launches <= 0:
        raise AssertionError("the kernel's launch counter did not rise")

    # ---- 4. kernel vs plain on one dispatch at the main path's shapes
    inputs = scene(Volume(CLOUD), RES, args.seed, MAIN_CMP_SPP)
    kernel_out = megakernel.render(*inputs)
    ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
    plain_ms, plain_out = host_ms(lambda: megakernel.render_plain(*inputs))
    max_abs_err = compare(f"cloud512 {RES}x{RES}, {MAIN_CMP_SPP} spp, {BOUNCES} bounces",
                          kernel_out, plain_out)
    print(f"cloud512 {RES}x{RES}, {MAIN_CMP_SPP} spp, {BOUNCES} bounces: kernel {ms!r} ms, "
          f"plain {plain_ms!r} ms per dispatch, on {gpu_line}", flush=True)
    del inputs, kernel_out, plain_out
    torch.cuda.empty_cache()

    # ---- 5. the main path, through the CLI
    megakernel.render.launches = 0
    out_png = os.path.join(OUT_DIR, "cloud512.png")
    r, stats = cli.run([CLOUD, sky_path, "--render", "-w", str(RES), "-h", str(RES),
                        "--spp", str(SPP), "--bounces", str(BOUNCES), "--output", out_png,
                        "--device", "cuda"])
    launches = megakernel.render.launches
    if launches <= 0:
        raise AssertionError("the main path did not launch the CUDA kernel")
    if r.last_engine != "cuda_kernel":
        raise AssertionError(f"the main path ran {r.last_engine}")
    for path in stats["outputs"]:
        if not os.path.getsize(path):
            raise AssertionError(f"{path} is empty")
    fb = r.framebuffer()
    if tuple(fb.shape) != (RES, RES, 4) or not bool(torch.isfinite(fb).all()):
        raise AssertionError("the framebuffer is not a finite (H, W, 4) image")
    mean = fb.mean(dim=(0, 1)).tolist()
    if not mean[0] > 0.0:
        raise AssertionError(f"the framebuffer is black: mean {mean}")
    print(f"main path: cloud512 {RES}x{RES}, {SPP} spp, {BOUNCES} bounces: "
          f"{stats['spp'] / stats['seconds']!r} spp/s ({stats['seconds']!r} s, "
          f"{launches} kernel launch(es), framebuffer mean {[round(m, 4) for m in mean]}) "
          f"on {gpu_line}", flush=True)

    print(gpu_line)
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "volren_tpu_torch/csrc/megakernel.cu",
        "replaces": "volren_tpu/ops/pallas/kernel.py:602",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
