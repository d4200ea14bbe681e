#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volren_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card. Phases, each
of which raises on failure (exit code non-zero, no result line):

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power
   limit from nvidia-smi;
2. build: the CUDA megakernel, its four <USE_TF, HAS_EMI> instantiations
   on the float32 tables (their registers must stay 62 / 64 / 70 / 80, with
   no spill) and,
   for each, its three packed ones (the RGBE environment and NEE pool under
   their flags; the u8 majorant pyramid with them; all three at compile
   time, volren_tpu's default; all with their STATS twins), the u8
   pyramid's build kernel, the probe kernels and the oracle engine's
   eight <USE_DDA, USE_TF, HAS_EMI> instantiations, compiled with nvcc for
   sm_90a from volren_tpu_torch/csrc into build/ (one nvcc per source, in
   parallel), with ptxas's registers, stack and spill of each;
3. kernel vs plain: the CUDA kernel against its plain torch version on the
   same CUDA tensors, on a random 16^3 grid and on a 64^3 crop of
   .scene_cache/cloud512.brick, at 64x64, at 4 spp (8 pixels to a warp)
   and at 64 spp (the main path's dispatch: one pixel to a warp), in all
   four variants (plain, TF with the CLI's --fau LUT, emission from a
   temperature grid at half resolution, TF + emission). The kernel is
   built to round as the plain version does, so the bar is bitwise
   equality, and two runs must be bitwise identical; for the plain variant
   at 4 spp, besides, its RMSE must stay below 1.5x the kernel's own
   seed-to-seed noise with the mean within 5%. The same with the packed
   tables (Renderer.pallas_mip_u8 / pallas_env_rgbe / pallas_pool_rgbe):
   all three on, in every variant, on both scenes at both spp, and each
   alone and the u8 pyramid with either RGBE read on the random grid at 4
   spp, each launching its instantiation;
4. kernel vs plain at the paths' shapes: one 4-spp dispatch of the whole
   cloud512 at 1024x1024 through both, for the plain path, the TF path,
   the emission path (a 256x256x128 temperature grid made from --seed) and
   TF + emission (phase 9's --turbo path),
   timed (CUDA events for the kernel), bitwise equal; the plain run also
   counts the dispatch's events for the kernel's work bound; the same
   with all three packs on (the plain path also with each pack alone);
   then a 4-spp and a 64-spp dispatch of each path at 256x256, bitwise
   equal; then 64-spp 1024x1024 dispatches of each path
   on the float32 tables and with all packs (the plain path also with each
   pack alone), timed in turns (CUDA events, PACK_ROUNDS rounds), each with its
   bound from its STATS twin's counts; the RGBE encode kernel (the packed
   tables' feeder) on a dispatch's pool radiance and the sky's texels,
   bitwise its plain version, timed, and its packed pool (rows and words in
   one launch) bitwise the plain version's; the NEE pool's draw kernel,
   f32 and packed, bitwise its plain version on the same CUDA uniforms at
   three (seed, spp_base), on the phases' sky and on the 4096x2048 one,
   timed (CUDA events) beside its bound, its plain version and
   build_env_pool's host ms; the u8 pyramid's build kernel
   bitwise its plain version on cloud512's pyramid (times density_scale and
   TF-baked), the random grid's and ragged levels with a level of one value
   and one of zeros, timed beside its bound; the TF majorant's bake kernel
   bitwise its plain version on cloud512's and the random grid's raw
   pyramids through the --fau LUT and a 4-bin LUT under a window whose
   ends both clamp, timed beside its bound (the feeders -- the RGBE
   encode, the u8 build, the bake -- by CUDA events over launches queued
   behind a spin kernel, the device's time, with their back-to-back rate
   beside it); the plain path's 64-spp
   dispatch on the float32 texels and on the RGBE environment under a
   4096x2048 procedural sky (its texels over the card's L2, its words under
   it), timed in turns, with the seconds the sky's tables took;
5. the main path: volren_tpu_torch.cli renders cloud512 at 1024x1024,
   256 spp (four 64-spp dispatches), 100 bounces, under a procedural sky
   made from --seed;
6. the TF path: the same through the CLI with --fau;
7. the emission path: the same scene with the temperature grid, through
   Renderer.trace(256); then each of the four paths through
   Renderer.render(256) at the same shapes on the float32 tables and with
   all three packs on, each in a Renderer of its own, one after the other:
   spp/s of each, the packed instantiation, the
   pool's draw kernel (once a dispatch, the packed pool with no encode
   launch) and the u8 pyramid's build kernel (once a trace) launched
   (counts set to 0 before a run, read after it; a packed Renderer's
   first dispatch also encodes the frame's texels, once; a TF path bakes
   its majorant table once a trace), 0 capped samples, the packed image's
   mean within 5% of the float32 image's, and the trace's TF majorant
   table and u8 pyramid baked again, and the f32 Renderer's trace set up,
   with no host sync, one bake launch each;
8. the probe kernels (volren_tpu_torch/csrc/probes.cu, built in phase 2
   beside the megakernel, ptxas's lines printed): for each of the 28 Pallas
   call sites they replace (volren_tpu_torch.probes.sites), one call at the
   probe's shapes held against its plain version on the same CUDA tensors
   (bitwise; row_scan allclose at rtol 1e-5), timed beside its bound, its
   plain version and the one PyTorch call that computes the same, if any
   (each site that has one in turns with that call, median and p10-p90:
   P0 and W4 101 rounds, the gathers P3a, P3c, P3d, Q1, Q2, Q4, W3 and the
   cumsum 31; the _scan_gather harness, one gather launch for both tables,
   31 rounds against the pair t1[r, c], t2[r, c], its library_ms two calls;
   Q3's five ops, 31 rounds against their six PyTorch calls);
   the gather's plan and carry30's pipeline, lcg_gather_sum's loads in
   flight a lane (from the built library), the staged rounds' and the
   direct mode's design, the affine loop kernel's blocks of steps, the
   march's thread a (row, column) and index_copy's plan at Q3's shapes,
   each with ptxas's registers; Q6's chain floor (a step's time on one
   warp alone, 64 -> 512 steps, times Q6's 64 steps, plus P0's time)
   beside its bound;
   the transpose of an 8192 x 8192 f32 array held bitwise to t.t() and
   timed in turns with .t().contiguous() beside its bound by bytes;
   tea8 (bitwise) and row_scan (rtol 1e-5) at ragged sizes, aligned and
   from a base one element past a 16-byte boundary (row_scan's word path
   beside its float4 path), and both at the probes' (8, 128) in turns
   with P0's launch floor, x * 2 and torch.cumsum, with ptxas's registers;
   then the entry point python -m volren_tpu_torch.probes, run in-process
   one site's stages at a time, every stage ok and the site's kernel
   launched.
9. the front ends, at full width, everything written under
   build/chip_smoke/frontends: (1) an animated folder of FRAMES .vdb files
   (volren_tpu_torch.voldata.vdb.write_vdb_grids), each the whole cloud512
   density (512x512x256, rolled 8 voxels along x per frame) with a
   256x256x128 temperature grid from --seed + k, timed to write and to
   load; (2) the CLI renders the folder offline at 1024x1024, 256 spp, 100
   bounces, --emission 100 --vol_rot_y 30 --vol_crop_max 1 0.8 1: one PNG
   and a finite, positive framebuffer per frame, through the emission
   kernel <0,1>, at least four launches per frame; (3) one frame with
   --turbo: the TF + emission kernel <1,1> on a user path; (4) a volpy
   script in the reference's style (import volpy) through the CLI; (5)
   the interactive loop with --serve 0 as a subprocess: /state.json until
   64 samples, /frame.png (a 256x256 PNG), a /set and a /nav that each
   reset the accumulation, a full-resolution /snapshot, then SIGINT and
   exit code 0; (6) a checkpoint after 128 spp loaded into a new Renderer
   and traced 128 more equals a straight trace(256) bitwise; (7) a touched
   (os.utime) megakernel.cu is rebuilt and swapped in by
   utils.hotreload.KernelWatcher, and the next dispatch equals the one
   before bitwise; (8) Renderer.profile writes a torch.profiler trace that
   names the megakernel. Each of (2)-(8) must launch the megakernel.
10. the oracle engine (csrc/oracle.cu, volren_tpu/ops/tracer.py's
   GLSL-order tracer; a launch traces all of a call's passes): (1) every
   instantiation against its plain torch version (ops/tracer.py) on the
   same CUDA tensors, on phase 3's two scenes at 64x64, 16 bounces (TF
   with --fau, emission with the half-resolution temperature grid), after
   launches of 1, 2, 5 and 33 passes one after another, bitwise, two runs
   bitwise identical, the kernel's count of capped loop calls equal to the
   plain version's; (2) the oracle path at full width: the CLI renders
   cloud512 at 1024x1024, 16 spp, 100 bounces with --engine oracle under
   phase 5's sky: a PNG, a finite framebuffer with a positive mean within
   5% of phase 5's megakernel image, ceil(16 / 64) = 1 launch of <1,0,0>,
   the CUDA oracle as the engine; on that renderer's scene, sky and
   bounces, the path's launch of 16 passes from zero again: bitwise the
   render's framebuffer, timed, through the STATS instantiation (the same
   framebuffer, 0 capped loop calls, the counts for the bound), and
   bitwise the plain version's 16 passes on 1 pixel in 64, picked to reach
   every position of a group tile (the launch's groups of 64 items, from
   the STATS counts); (3) the other
   seven instantiations on user paths at 256x256, 4 spp each through
   Renderer (--no-dda's delta and ratio tracking with and without --fau
   and emission, the DDA oracle with --fau, with emission and with both),
   one launch each, each image mean within 5% of the megakernel's at the
   same scene, size and 64 spp -- with emission, delta tracking's within
   [-5%, +10%], as the megakernel and the DDA oracle share the reference's
   emission weighting (volren_tpu/ops/tracking.py:12-19), which counts
   less emission -- and each renderer's launch held as in (2), against
   the plain version on 1 pixel in 4 for DDA and 1 in 256 for delta
   tracking (its plain loops run long; groups of 32 items). The kernels line's oracle entries
   come from (2) and (3): ms of the path's launch (CUDA events) and ms a
   pass, its bound from the STATS counts and the share, the launches of
   the path's run, and the plain version's host-clock ms.
11. rendering across devices (volren_tpu_torch.parallel): (1) 4-spp
   1024x1024 cloud512 dispatches of all four variants over 2, 3 (ragged:
   342, 342, 340 rows) and 4 row bands, concatenated, bitwise the whole
   dispatch, and so are the STATS twins' bands, with 0 capped; the band
   overhead (4 bands launched in turn against one dispatch, plain, 4 and 64
   spp); (2) distribute() in a world of one over NCCL: two trace(64)s,
   each bitwise the undistributed render (a world of one makes no
   collective), then NCCL's all_reduce and all_gather of the whole frame
   over the one rank, which must return it; (3) two spawned processes on the one card over gloo
   (parallel.dryrun), meshes (2, 1) and (1, 2) at 256x256, 64 spp, 100
   bounces: bands bitwise one process, the sample split within 1e-5, the
   CUDA kernel launched on every rank; (4) the CLI with --distribute under
   python -m torch.distributed.run --standalone --nproc_per_node 1. Its
   spp/s are printed with the remark that they are no scaling numbers: the
   smoke runs on one card.
12. the denoiser and the scripts: denoise_image on phase 5's 1024x1024
   framebuffer, 20 bf16 train_steps at batch 8, patch 64 on patches of
   that framebuffer and a 4-spp one of the same renderer (the loss must
   fall), then every script as python -m volren_tpu_torch.scripts.<name>
   on the card (make_cloud, styletransfer, datagen_colmap and compare_rmse
   at once; datagen_denoise, then train_denoiser on its output), and a
   256x256 --render denoised with the trained parameters, all under
   build/chip_smoke/scripts.
In phases 5-11 the launch count of the path's kernel, set to 0 just before
the run, must have risen during it, and in phases 5-7 and 9 (in process)
the NEE pool's draw kernel's too, once a dispatch, and in phases 5-7 the TF
majorant's bake kernel's, once a TF trace; in phases 5-7, 9 and 10 the
framebuffer must be finite with a positive mean and the run must have used
the CUDA kernel.
The plain versions that phases 3, 4 and 10 hold the kernels against
(megakernel.render_plain, the oracle's ops/tracer.py) run on the card on
their chunked schedule (volren_tpu_torch/ops/chunked.py): a host sync once
a chunk of steps, the chunks replayed as CUDA graphs; the tests hold it
bitwise to their per-step schedule.
Every dispatch of phases 3-7 is also run through the kernel's STATS
instantiation (megakernel.render_stats), which must render the same image
(phases 3-4), count 0 capped samples, and in phase 4 count the events the
plain version counts.

Each phase prints its seconds, and the line before the last three prints
every phase's seconds and the total. The last three lines are the card
line from nvidia-smi, a JSON object describing each kernel, and the
device record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
SMALL_RES, SMALL_CMP_SPP = 256, (4, 64)    # and at 256x256
CMP_RES, CMP_SPP = 64, (4, 64)             # kernel vs plain version
# the kernels line: name, the scene path that runs it, the TPU kernel it replaces
KERNELS = (("megakernel", "plain", "volren_tpu/ops/pallas/kernel.py:602"),
           ("megakernel_tf", "tf", "volren_tpu/ops/pallas/kernel.py:635"),
           ("megakernel_emission", "emission", "volren_tpu/ops/pallas/kernel.py:636"),
           ("megakernel_tf_emission", "tf+emission", "volren_tpu/ops/pallas/kernel.py:635"))
# the packed tables (mip_u8, env_rgbe, pool_rgbe) of a dispatch, and the
# parts of _make_kernel their instantiations replace (each KERNELS entry's
# packed twin is "<name>_packed")
NO_PACKS, ALL_PACKS = (False, False, False), (True, True, True)
PACK_SETS = {"u8": (True, False, False), "env_rgbe": (False, True, False),
             "pool_rgbe": (False, False, True), "all": ALL_PACKS}
# phase 3 also runs the u8 pyramid with either RGBE read (the flags of the
# u8 instantiation; all three are another instantiation)
CMP_PACK_SETS = {**PACK_SETS, "u8+env_rgbe": (True, True, False),
                 "u8+pool_rgbe": (True, False, True)}
PACKED_REPLACES = ("volren_tpu/ops/pallas/kernel.py:780-826, :952-958 (mip_u8), :833-838, "
                   ":1753-1794 (env_rgbe), :687, :1626-1635 (pool_rgbe)")
# phase 4: rounds of the 64-spp dispatches timed in turns (one: packs_measure
# times the same dispatches in its rounds)
PACK_ROUNDS = 1
# the RGBE encode kernel (the packed tables' feeder): what it replaces,
# and a row's float32 operations (an FMA two) for its bound
RGBE_ENCODE_REPLACES = "volren_tpu/ops/pallas/pack.py:118 (rgbe_encode; XLA, no pallas_call)"
RGBE_ENCODE_OPS = 87
# the u8 pyramid's build kernel: what it replaces, and an entry's float32
# operations for its bound (the scale's product, min and max, the
# subtraction, division, ceiling, clamps, FMA, comparison and bump)
MIP_U8_REPLACES = "volren_tpu/ops/pallas/pack.py:361-384 (_build_mip_u8_jit; XLA, no pallas_call)"
MIP_U8_OPS = 13
# the NEE pool's draw kernel: what it replaces, a sample's float32
# operations for its bound (the alias pick 5, the jitter 4, the texel's
# (px, py) 4, uv 6, theta 4, phi 5, sin and cos 4, the local direction 2,
# the rotation 15, the radiance 3; the packed pool adds RGBE_ENCODE_OPS),
# and the (seed, spp_base) pairs phase 4 holds it to its plain version at
ENV_POOL_REPLACES = ("volren_tpu/ops/pallas/pack.py:413-437 (build_env_pool) and "
                     "volren_tpu/ops/envmap.py:149-195 (sample_environment_alias); XLA, no "
                     "pallas_call")
ENV_POOL_OPS = 52
ENV_POOL_DRAWS = ((7, 0), (7, 192), (2024, 64))
# the TF majorant's bake kernel: what it replaces, and an entry's float32
# operations for its bound (the density's two products; the window's
# subtraction, division, two clamps and scale; the floor, its conversion and
# the fraction; the lerp's subtraction, two products and sum; the
# majorant's product)
BAKE_TF_REPLACES = ("volren_tpu/renderer.py:427-439 through volren_tpu/ops/transfer.py:26 "
                    "(tf_alpha_majorant, onehot=False); XLA, no pallas_call")
BAKE_TF_OPS = 15
# phase 4: the large sky (100.7 MB of float32 texels, over the card's 50 MB
# of L2; 33.6 MB of RGBE words, under it)
BIG_SKY = (4096, 2048)
FRAMES = 3                                 # phase 9's animated folder
ORACLE_SPP, ORACLE_BOUNCES = 16, 16        # phase 10: the full-width path; kernel vs plain
ORACLE_LAUNCHES = (1, 2, 5, 33)            # 10.1: passes of the launches, one after another
ORACLE_RES_SMALL, ORACLE_SPP_SMALL = 256, 4
# the plain version's pixels: 1 in ORACLE_STRIDE_* squared (10.2, 10.3 DDA, 10.3 delta)
ORACLE_STRIDE_MAIN, ORACLE_STRIDE_DDA, ORACLE_STRIDE_DELTA = 8, 2, 16
# the widest group tile (8 x 4 pixels): the picked pixels reach every
# position of a tile, so every lane that folds a pixel is checked
ORACLE_TILE_SPAN = 8
# a group's items on the launches held to the plain version (10.2: the
# launch keeps 8 groups a resident warp; 10.3: it does not)
ORACLE_ITEMS_MAIN, ORACLE_ITEMS_SMALL = 64, 32
ORACLE_REPLACES = "volren_tpu/ops/tracer.py:154 (trace_pass; XLA, no pallas_call)"
# phase 8: tea8's sizes and row_scan's shapes beyond the probes' (8, 128)
TEA8_SIZES = (3, 1024, 1025, 2 ** 20 + 3)
ROW_SCAN_SHAPES = ((1, 33), (3, 129), (8, 1024), (1000, 1000))
# phase 8: the sites timed in turns with their PyTorch call, and the rounds
PROBES_IN_TURNS = {"probe_P0": 101, "probe_W4": 101, "scan_gather_harness": 31, **{
    f"probe_{name}": 31 for name in ("P3a", "P3c", "P3d", "Q1", "Q2", "Q3", "Q4", "W3",
                                     "cumsum")}}
ORACLE_VARIANTS = [(dda, tf, emi) for dda in (True, False) for tf in (False, True)
                   for emi in (False, True)]
VARIANT = {"plain": (False, False), "tf": (True, False), "emission": (False, True),
           "tf+emission": (True, True)}


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


class _Lines:
    """Collects a subprocess's output lines (split at \r and \n) on a
    thread, so that the smoke can wait for one while the process runs."""

    def __init__(self, stream):
        import threading

        self.lines, self._cond = [], threading.Condition()
        self._thread = threading.Thread(target=self._read, args=(stream,), daemon=True)
        self._thread.start()

    def _read(self, stream):
        buf = ""
        for chunk in iter(lambda: stream.read(1), ""):
            if chunk in "\r\n":
                if buf:
                    with self._cond:
                        self.lines.append(buf)
                        self._cond.notify_all()
                buf = ""
            else:
                buf += chunk

    def wait_for(self, pattern: str, timeout: float):
        import re

        deadline = time.time() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    m = re.search(pattern, line)
                    if m:
                        return m
                left = deadline - time.time()
                if left <= 0:
                    raise AssertionError(f"no line matching {pattern!r} within {timeout} s; "
                                         f"last lines: {self.lines[-5:]}")
                self._cond.wait(left)


def front_ends(seed, sky_path, sky, gpu_line, scene, cuda_ms) -> int:
    """Phase 9 (see the module's docstring). Returns the launches of the
    TF + emission kernel <1,1> on the --turbo user path."""
    import signal
    import urllib.request

    import numpy as np
    import torch

    from volren_tpu_torch import cli
    from volren_tpu_torch.measure import path_renderer, temperature_grid
    from volren_tpu_torch.ops import scene as dscene
    from volren_tpu_torch.ops.kernels import megakernel
    from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params, decode_dense, \
        pack_scene
    from volren_tpu_torch.cli import INTERACTIVE_SPP
    from volren_tpu_torch.renderer import DISPATCH_SPP
    from volren_tpu_torch.utils.hotreload import KernelWatcher
    from volren_tpu_torch.voldata import Volume, read_brick
    from volren_tpu_torch.voldata.vdb import read_vdb, write_vdb_grids

    dev = torch.device("cuda")
    out = os.path.join(OUT_DIR, "frontends")
    folder = os.path.join(out, "anim")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(folder)

    def launched(label, before, variant=None, pools_before=None):
        """The megakernel (or its ``variant``) launched since ``before``,
        and, given ``pools_before``, the pool's draw kernel too."""
        now = (megakernel.render.launches if variant is None
               else megakernel.render.launches_by_variant.get(variant, 0))
        if now <= before:
            raise AssertionError(f"{label}: the megakernel did not launch")
        if pools_before is not None and megakernel.env_pool.launches <= pools_before:
            raise AssertionError(f"{label}: the NEE pool's draw kernel did not launch")
        return now - before

    def check_fb(label, fb, res):
        if tuple(fb.shape) != (res[1], res[0], 4) or not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"{label}: the framebuffer is not a finite (H, W, 4) image")
        mean = fb.mean(dim=(0, 1)).tolist()
        if not mean[0] > 0.0:
            raise AssertionError(f"{label}: the framebuffer is black: mean {mean}")
        return mean

    # ---- 9.1 an animated folder of cloud512-sized VDB frames
    cloud = read_brick(CLOUD)
    ks = pack_scene(dscene.upload_grid(cloud, np.eye(4, dtype=np.float32), dev),
                    dscene.upload_environment(sky, dev))
    ex, ey, ez = (int(v) for v in cloud.voxel_extent)
    dense = decode_dense(ks).reshape(ez, ey, ex).cpu().numpy()
    del ks
    frames = []
    for k in range(FRAMES):
        path = os.path.join(folder, f"cloud_{k}.vdb")
        temp = temperature_grid(ex // 2, ey // 2, ez // 2, seed + k)
        t0 = time.perf_counter()
        write_vdb_grids(path, [("density", np.roll(dense, 8 * k, axis=2), None),
                               ("temperature", temp.data, temp.transform)])
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = read_vdb(path, "density"), read_vdb(path, "temperature")
        t_load = time.perf_counter() - t0
        if got[0].data.shape != dense.shape or got[1].data.shape != temp.data.shape:
            raise AssertionError(f"{path}: the grids read back have other shapes")
        print(f"frame {k}: {path} ({os.path.getsize(path)} bytes, density {ex}x{ey}x{ez} + "
              f"temperature {ex // 2}x{ey // 2}x{ez // 2}) written in {t_write!r} s, loaded "
              f"in {t_load!r} s on the card's host ({gpu_line})", flush=True)
        frames.append(path)
    del dense, got

    # ---- 9.2 the folder through the CLI, offline
    base = ["--render", "-w", str(RES), "-h", str(RES), "--spp", str(SPP), "--bounces",
            str(BOUNCES), "--emission", "100", "--device", "cuda"]
    megakernel.render.launches = 0
    megakernel.render.launches_by_variant.clear()
    megakernel.env_pool.launches = 0
    t0 = time.perf_counter()
    r, stats = cli.run([folder, sky_path, *base, "--vol_rot_y", "30", "--vol_crop_max", "1",
                        "0.8", "1", "--output", os.path.join(out, "anim.png")])
    wall = time.perf_counter() - t0
    emission = launched("the animated folder", 0, (False, True), 0)
    if emission != megakernel.render.launches or emission < FRAMES * SPP // DISPATCH_SPP:
        raise AssertionError(f"the animated folder ran {megakernel.render.launches_by_variant}, "
                             f"not {FRAMES * SPP // DISPATCH_SPP}+ launches of <0,1>")
    if megakernel.env_pool.launches != emission:
        raise AssertionError(f"the animated folder drew {megakernel.env_pool.launches} pools "
                             f"with the draw kernel in {emission} dispatches")
    if len(stats["outputs"]) != FRAMES or r.last_engine != "cuda_kernel":
        raise AssertionError(f"the animated folder wrote {stats['outputs']} with {r.last_engine}")
    for k, (png, frame) in enumerate(zip(stats["outputs"], stats["frames"])):
        if not os.path.getsize(png) or not frame["finite"] or not frame["mean"][0] > 0.0:
            raise AssertionError(f"frame {k} of the animated folder: {png}, {frame}")
        print(f"animated folder frame {k}: {SPP / frame['seconds']!r} spp/s "
              f"({frame['seconds']!r} s, framebuffer mean "
              f"{[round(m, 4) for m in frame['mean']]}) on {gpu_line}", flush=True)
    print(f"animated folder: {FRAMES} frames of {RES}x{RES}, {SPP} spp in {wall!r} s of wall "
          f"time ({stats['seconds']!r} s tracing), {emission} launches of <0,1>", flush=True)
    del r
    torch.cuda.empty_cache()

    # ---- 9.3 one frame with --turbo: the TF + emission kernel on a user path
    megakernel.render.launches = 0
    megakernel.render.launches_by_variant.clear()
    megakernel.env_pool.launches = 0
    r, stats = cli.run([frames[0], sky_path, *base, "--turbo", "--output",
                        os.path.join(out, "turbo.png")])
    tf_emission = launched("--turbo", 0, (True, True), 0)
    if tf_emission != megakernel.render.launches or r.last_engine != "cuda_kernel" or \
            megakernel.env_pool.launches != tf_emission:
        raise AssertionError(f"--turbo ran {megakernel.render.launches_by_variant} and "
                             f"{megakernel.env_pool.launches} pool draws with {r.last_engine}")
    mean = check_fb("--turbo", r.framebuffer(), r.resolution)
    ks, tp = r._kernel_scene(), r._trace_params()
    inputs = (ks, build_env_pool(r._env_device, int(r.seed), 0),
              *build_params(ks, tp, RES, RES, 0, DISPATCH_SPP))
    ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
    print(f"--turbo frame: {SPP / stats['seconds']!r} spp/s, {tf_emission} launches of <1,1>, "
          f"{ms!r} ms per 64-spp dispatch (CUDA events), framebuffer mean "
          f"{[round(m, 4) for m in mean]} on {gpu_line}", flush=True)
    del r, ks, inputs
    torch.cuda.empty_cache()

    # ---- 9.4 a volpy script in the reference's style, through the CLI
    script = os.path.join(out, "script.py")
    script_png = os.path.join(out, "script.png")
    with open(script, "w") as f:
        f.write("import volpy\n\n"
                "renderer = volpy.Renderer()\n"
                f"renderer.volume = volpy.Volume({frames[0]!r})\n"
                "renderer.scale_and_move_to_unit_cube()\n"
                "renderer.commit()\n"
                "renderer.bounces = 100\n"
                "renderer.render(64)\n"
                f"renderer.save({script_png!r})\n")
    before, pools = megakernel.render.launches, megakernel.env_pool.launches
    r, _ = cli.run([script, "--render", "-w", "512", "-h", "512", "--spp", "4", "--device",
                    "cuda", "--output", os.path.join(out, "after_script.png")])
    launched("the volpy script", before, pools_before=pools)
    if not os.path.getsize(script_png) or r.last_engine != "cuda_kernel":
        raise AssertionError(f"the volpy script wrote no {script_png} or ran {r.last_engine}")
    check_fb("the volpy script", r.framebuffer(), r.resolution)
    print(f"volpy script: {script_png} written through the CLI ({r.last_engine})", flush=True)
    del r

    # ---- 9.5 the interactive loop and its viewer, in a process of its own
    serve_png = os.path.join(out, "serve.png")
    proc = subprocess.Popen([sys.executable, "-u", "-m", "volren_tpu_torch.cli", frames[0],
                             sky_path, "--serve", "0", "--output", serve_png],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        lines = _Lines(proc.stdout)
        port = int(lines.wait_for(r"viewer: http://127\.0\.0\.1:(\d+)/", 180).group(1))

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
                if resp.status != 200:
                    raise AssertionError(f"{path}: HTTP {resp.status}")
                return resp.read()

        def sample():
            return json.loads(get("/state.json"))["sample"]

        def wait_sample(n, timeout=120):
            deadline = time.time() + timeout
            while (s := sample()) < n:
                if time.time() > deadline:
                    raise AssertionError(f"the interactive loop is at {s} of {n} samples")
                time.sleep(0.02)
            return s

        wait_sample(64)
        png = get("/frame.png")
        w, h = (int.from_bytes(png[16 + 4 * i:20 + 4 * i], "big") for i in range(2))
        if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR" or (w, h) != (256, 256):
            raise AssertionError(f"/frame.png is not a 256x256 PNG: {png[:24]!r}")
        for edit in ("/set?seed=11", "/nav?fwd=1&right=0&up=0"):
            s0 = wait_sample(256)
            get(edit)
            s1 = sample()
            if not s1 < s0:
                raise AssertionError(f"{edit} did not reset the accumulation ({s0} -> {s1})")
            print(f"viewer {edit}: sample {s0} -> {s1}", flush=True)
        get("/snapshot")
        lines.wait_for(r"\(tonemapped snapshot\)", 300)
        if not os.path.getsize(serve_png):
            raise AssertionError(f"/snapshot wrote no {serve_png}")
        proc.send_signal(signal.SIGINT)
        if proc.wait(timeout=120) != 0:
            raise AssertionError(f"the interactive loop exited with {proc.returncode}")
        m = lines.wait_for(r"interactive: (\d+) spp at (\d+)x(\d+) in (\S+) s of tracing "
                           r"\((\S+) spp/s, (\w+)\)", 10)
        if m.group(6) != "cuda_kernel" or int(m.group(1)) < 64:
            raise AssertionError(f"the interactive loop: {m.group(0)}")
        print(f"interactive loop (--serve 0, port {port}): {m.group(1)} spp at "
              f"{m.group(2)}x{m.group(3)}, {m.group(5)} spp/s of tracing "
              f"({INTERACTIVE_SPP * 1e3 / float(m.group(5))!r} ms a {INTERACTIVE_SPP}-spp step); "
              f"/snapshot {serve_png}; SIGINT -> exit 0 on {gpu_line}", flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # ---- 9.6 checkpoints: 128 + 128 spp through a file = trace(256)
    def emission_renderer():
        return path_renderer(Volume(CLOUD), sky, RES, seed, "emission", device=dev)

    before, pools = megakernel.render.launches, megakernel.env_pool.launches
    ckpt = os.path.join(out, "checkpoint.npz")
    r = emission_renderer()
    r.trace(128)
    r.save_checkpoint(ckpt)
    resumed = emission_renderer()
    resumed.load_checkpoint(ckpt)
    resumed.trace(128)
    straight = emission_renderer()
    straight.trace(256)
    launched("the checkpoint round trip", before, pools_before=pools)
    if not resumed.last_engine == straight.last_engine == "cuda_kernel":
        raise AssertionError(f"the checkpoint round trip ran {resumed.last_engine}")
    check_fb("the checkpoint round trip", resumed.framebuffer(), resumed.resolution)
    if resumed.sample != 256 or not torch.equal(resumed.framebuffer(), straight.framebuffer()):
        raise AssertionError("128 + 128 spp through a checkpoint differ from trace(256)")
    print("checkpoint: 128 spp, save, load into a new Renderer, 128 spp = trace(256), bitwise",
          flush=True)
    del r, resumed

    # ---- 9.7 hot reload: a touched source is rebuilt and swapped in
    inputs = scene(Volume(CLOUD), SMALL_RES, seed, DISPATCH_SPP, "plain")
    first = megakernel.render(*inputs)
    watcher = KernelWatcher()
    old_lib = megakernel._LIB
    st = os.stat(megakernel.SOURCE)
    os.utime(megakernel.SOURCE, (st.st_atime, st.st_mtime + 1.0))
    if not watcher.reload_modified_kernels() or megakernel._LIB is old_lib:
        raise AssertionError("the touched megakernel.cu was not rebuilt and swapped in")
    before = megakernel.render.launches
    again = megakernel.render(*inputs)
    launched("the reloaded kernel", before)
    if not torch.equal(first, again):
        raise AssertionError("the reloaded kernel's dispatch differs from the one before")
    print("hot reload: touched megakernel.cu rebuilt, swapped in, the next dispatch bitwise "
          "equal", flush=True)
    del inputs, first, again

    # ---- 9.8 the profiler
    trace_dir = os.path.join(out, "profile")
    before, pools = megakernel.render.launches, megakernel.env_pool.launches
    with straight.profile(trace_dir):
        straight.trace(64)
    launched("the profiled trace", before, pools_before=pools)
    if straight.last_engine != "cuda_kernel":
        raise AssertionError(f"the profiled trace ran {straight.last_engine}")
    names = set()
    for name in os.listdir(trace_dir):
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f).get("traceEvents", [])
        names |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    kernels = sorted(n for n in names if "megakernel" in n)
    if not kernels:
        raise AssertionError(f"the profiler's trace names no megakernel kernel: {sorted(names)}")
    print(f"profile: {trace_dir} names {kernels}", flush=True)
    del straight
    torch.cuda.empty_cache()
    return tf_emission


def _ragged_pyramid(dev):
    """A flat pyramid of 4 levels of ragged sizes, with exact zeros where a
    level's minimum is 0, a level of one value (scale 0) and a level of
    zeros: (mip, dims, offsets)."""
    import numpy as np
    import torch

    dims = ((7, 5, 13), (4, 3, 7), (2, 2, 4), (1, 1, 2))
    counts = [int(np.prod(d)) for d in dims]
    offs = tuple(int(v) for v in np.cumsum([0] + counts[:-1]))
    mip = (np.random.default_rng(5).random(sum(counts)) ** 3 * 40.0).astype(np.float32)
    mip[offs[1]:offs[1] + 9] = 0.0
    mip[offs[2]:offs[3]] = 2.5
    mip[offs[3]:] = 0.0
    return torch.as_tensor(mip, device=dev), dims, offs


def _spread(n, stride):
    """Every ``stride``-th of ``n`` coordinates, each shifted within its
    stride so that the picks reach every residue mod ORACLE_TILE_SPAN."""
    import numpy as np

    k = np.arange(n // stride)
    return k * stride + (k // max(1, ORACLE_TILE_SPAN // stride)) % stride


def _path_name(tf, emi):
    return {(False, False): "plain", (True, False): "tf", (False, True): "emission",
            (True, True): "tf+emission"}[(tf, emi)]


def oracle_phase(seed, sky_path, sky, gpu_line, cuda_ms, host_ms, scenes, path_means) -> dict:
    """Phase 10 (see the module's docstring). ``scenes``: phase 3's
    (name, dense) pairs; ``path_means``: phase 5's megakernel image mean
    (rgb) of the plain path. Returns the kernels line's oracle entries."""
    import numpy as np
    import torch

    from volren_tpu_torch import cli
    from volren_tpu_torch.measure import oracle_bound, path_renderer
    from volren_tpu_torch.ops import tracer
    from volren_tpu_torch.ops.geometry import sanitize
    from volren_tpu_torch.ops.kernels import oracle
    from volren_tpu_torch.renderer import DISPATCH_SPP
    from volren_tpu_torch.voldata import DenseGrid, Volume

    dev = torch.device("cuda")
    t_phase = time.time()
    record = {v: {"max_abs_err": 0.0} for v in ORACLE_VARIANTS}

    def label(v):
        return f"<{int(v[0])},{int(v[1])},{int(v[2])}>"

    def oracle_renderer(volume, res, v, bounces):
        r = path_renderer(volume, sky, res, seed, _path_name(v[1], v[2]), bounces, device=dev)
        r.engine = "oracle"
        r._use_dda = v[0]
        return r

    def rgb_mean(fb):
        return float(fb[..., :3].mean())

    def hold(name, r, v, spp, stride, items):
        """The path's launch of ``spp`` passes from zero on its committed
        renderer (the launch its render made: bitwise its framebuffer),
        against the plain version's passes on 1 in ``stride`` pixels in x
        and y (``_spread``: every position of a group tile), bitwise; timed
        in CUDA events (the plain version on the host clock); and through
        the STATS instantiation, which must trace the same framebuffer in
        groups of ``items`` items. 0 capped loop calls in all three. The
        bound from the STATS counts. Records the kernels line's numbers."""
        scene, tp, cfg = r._scene_tables(), r._trace_params(), r._config()
        if (cfg.use_dda, cfg.use_tf, cfg.has_emission) != v:
            raise AssertionError(f"{name} {label(v)}: the renderer set up {cfg}")
        w, h = r._width, r._height
        zero = torch.zeros(h, w, 4, device=dev)
        capped = torch.zeros(1, dtype=torch.int32, device=dev)
        fb = oracle.trace_passes(scene, tp, cfg, zero, 1, spp, capped=capped)
        ms = cuda_ms(lambda: oracle.trace_passes(scene, tp, cfg, zero, 1, spp), 3)
        got, st = oracle.trace_stats(scene, tp, cfg, zero, 1, spp)
        if not (torch.equal(fb, r.framebuffer()) and torch.equal(got, fb)):
            raise AssertionError(f"{name} {label(v)}: the launch of {spp} passes, its STATS twin "
                                 f"and the render's framebuffer differ")
        if st["paths"] != items * st["groups"]:
            raise AssertionError(f"{name} {label(v)}: {st['paths']} items in {st['groups']} "
                                 f"groups, not groups of {items}")
        ys, xs = np.meshgrid(_spread(h, stride), _spread(w, stride), indexing="ij")
        span = ORACLE_TILE_SPAN
        if len(set(zip((ys % span).ravel(), (xs % span).ravel()))) != span * span:
            raise AssertionError(f"{name}: the picked pixels miss a position of a group tile")
        ys = torch.from_numpy(ys.reshape(-1)).to(dev)
        xs = torch.from_numpy(xs.reshape(-1)).to(dev)
        xy = torch.stack([xs, ys], -1).to(torch.int32).repeat(spp, 1)
        samples = torch.arange(1, spp + 1, device=dev).repeat_interleave(len(ys))
        stats = {}

        def plain():
            # tracer.trace_passes on the chosen pixels' (pixel, pass) lanes
            L = tracer.PLAIN_LANES
            rgba = torch.cat([tracer.trace_sample(scene, tp, cfg, xy[i:i + L], (w, h),
                                                  samples[i:i + L], stats)
                              for i in range(0, len(xy), L)])
            rgba = sanitize(rgba).reshape(spp, len(ys), 4)
            out = zero[ys, xs]
            for k in range(spp):
                out = out + (rgba[k] - out) * torch.tensor(tracer.pass_weight(k + 1), device=dev)
            return out

        plain_ms, p = host_ms(plain)
        k = fb[ys, xs]
        err = float((k - p).abs().max())
        same = float((k == p).all(-1).float().mean())
        bound_ms, bound_by, n_bytes, n_ops = oracle_bound(scene, w * h, st)
        counts = {key: n for key, n in st.items() if isinstance(n, int)}
        print(f"oracle kernel vs plain [{name} {label(v)}, {w}x{h}, {tp.bounces} bounces, a "
              f"launch of {spp} passes from zero in groups of {items} items, 1 in "
              f"{stride * stride} pixel(s) reaching every position of a tile: {len(ys)}]: "
              f"max abs {err!r}, bitwise identical pixels {same!r}; kernel {ms!r} ms a launch, "
              f"{ms / spp!r} ms a pass (CUDA events), plain {plain_ms!r} ms for its {len(xy)} "
              f"lanes (host clock); bound {bound_ms!r} ms by {bound_by} ({n_bytes} bytes, "
              f"{n_ops} f32 operations from the STATS counts {counts}), share {bound_ms / ms!r}; "
              f"SIMT bounce loop {st['simt_bounce']!r}, tracking loop {st['simt_track']!r}; "
              f"{st['blocks']} blocks, block ms {st['block_ms']!r}, tail {st['tail_ms']!r} ms; "
              f"loop calls capped at {cfg.max_steps}: kernel {int(capped)}, STATS "
              f"{st['capped']} (frame), plain {stats.get('capped', 0)} on {gpu_line}", flush=True)
        if not bool(torch.isfinite(fb).all()) or not torch.equal(k, p):
            raise AssertionError(f"{name} {label(v)}: the oracle kernel's launch is not bitwise "
                                 f"equal to its plain version's passes")
        if int(capped) != 0 or st["capped"] != 0 or stats.get("capped", 0) != 0:
            raise AssertionError(f"{name} {label(v)}: capped loop calls: kernel {int(capped)}, "
                                 f"STATS {st['capped']}, plain {stats.get('capped', 0)}")
        rec = record[v]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.update(ms=ms, ms_per_pass=ms / spp, passes_per_launch=spp, bound_ms=bound_ms,
                   bound_by=bound_by, share=bound_ms / ms, plain_ms=plain_ms,
                   plain_of=f"{spp} passes from zero on {len(ys)} pixels")

    # ---- 10.1 kernel vs plain version, every instantiation, launches of
    # 1, 2, 5 and 33 passes one after another
    n_total = sum(ORACLE_LAUNCHES)
    for name, dense in scenes:
        d, h, w = dense.shape
        for v in ORACLE_VARIANTS:
            r = oracle_renderer(Volume(DenseGrid(w, h, d, dense)), CMP_RES, v, ORACLE_BOUNCES)
            scene, tp, cfg = r._scene_tables(), r._trace_params(), r._config()
            if (cfg.use_dda, cfg.use_tf, cfg.has_emission) != v:
                raise AssertionError(f"{name} {label(v)}: the renderer set up {cfg}")
            zero = torch.zeros(CMP_RES, CMP_RES, 4, device=dev)
            capped = torch.zeros(1, dtype=torch.int32, device=dev)
            before = oracle.trace_pass.launches_by_variant.get(v, 0)
            runs = []
            for c in (capped, None):
                fb, first, fbs = zero, 1, []
                for n in ORACLE_LAUNCHES:
                    fb = oracle.trace_passes(scene, tp, cfg, fb, first, n, capped=c)
                    fbs.append(fb)
                    first += n
                runs.append(fbs)
            if oracle.trace_pass.launches_by_variant.get(v, 0) != before + 2 * len(ORACLE_LAUNCHES):
                raise AssertionError(f"{name} {label(v)}: the variant's launch count did not rise")
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"{name} {label(v)}: the kernel is not bitwise deterministic")
            # the plain version traces the passes' lanes together (the same
            # framebuffers as pass after pass)
            stats, frames = {}, []
            tracer.trace_passes(scene, tp, cfg, zero, 1, n_total, CMP_RES, CMP_RES, stats,
                                frames=frames)
            err, done = 0.0, 0
            for n, k in zip(ORACLE_LAUNCHES, runs[0]):
                done += n
                p = frames[done - 1]
                e = float((k - p).abs().max())
                err = max(err, e)
                print(f"oracle kernel vs plain [{name} {label(v)}, {CMP_RES}x{CMP_RES}, "
                      f"{ORACLE_BOUNCES} bounces, a launch of {n} pass(es), after {done}]: max "
                      f"abs {e!r}, bitwise identical pixels "
                      f"{float((k == p).all(-1).float().mean())!r}", flush=True)
                if not bool(torch.isfinite(k).all()) or not torch.equal(k, p):
                    raise AssertionError(f"{name} {label(v)}: the oracle kernel is not bitwise "
                                         f"equal to its plain version after {done} pass(es)")
            if int(capped) != stats.get("capped", 0):
                raise AssertionError(f"{name} {label(v)}: the kernel counts {int(capped)} capped "
                                     f"loop calls, the plain version {stats.get('capped', 0)}")
            record[v]["max_abs_err"] = max(record[v]["max_abs_err"], err)
            del r, scene
    torch.cuda.empty_cache()

    # ---- 10.2 the oracle path at full width, through the CLI
    main_v = (True, False, False)
    want = -(-ORACLE_SPP // DISPATCH_SPP)
    out_png = os.path.join(OUT_DIR, "cloud512_oracle.png")
    oracle.trace_pass.launches = 0
    oracle.trace_pass.launches_by_variant.clear()
    r, stats = cli.run([CLOUD, sky_path, "--render", "-w", str(RES), "-h", str(RES), "--spp",
                        str(ORACLE_SPP), "--bounces", str(BOUNCES), "--engine", "oracle",
                        "--output", out_png, "--device", "cuda"])
    launches = oracle.trace_pass.launches_by_variant.get(main_v, 0)
    if launches != want or oracle.trace_pass.launches != want:
        raise AssertionError(f"the oracle path ran {oracle.trace_pass.launches_by_variant}, not "
                             f"{want} launch(es) of {label(main_v)}")
    record[main_v]["launches"] = launches
    if r.last_engine != "cuda_oracle" or not all(os.path.getsize(p) for p in stats["outputs"]):
        raise AssertionError(f"the oracle path ran {r.last_engine}, wrote {stats['outputs']}")
    fb = r.framebuffer()
    if tuple(fb.shape) != (RES, RES, 4) or not bool(torch.isfinite(fb).all()):
        raise AssertionError("the oracle path's framebuffer is not a finite (H, W, 4) image")
    mean, ref = rgb_mean(fb), path_means["plain"]
    print(f"oracle path: cloud512 {RES}x{RES}, {ORACLE_SPP} spp, {BOUNCES} bounces through the "
          f"CLI (--engine oracle): {ORACLE_SPP / stats['seconds']!r} spp/s "
          f"({stats['seconds'] / ORACLE_SPP * 1e3!r} ms a pass on the host clock), {launches} "
          f"launch(es) of {label(main_v)}; image mean {mean!r} against the megakernel's {ref!r} "
          f"(rel {abs(mean - ref) / ref!r}) on {gpu_line}", flush=True)
    if not (mean > 0.0 and abs(mean - ref) / ref < 0.05):
        raise AssertionError(f"the oracle path's image mean {mean!r} is not within 5% of the "
                             f"megakernel's {ref!r}")
    # the path's launch, scene, sky and bounces against the plain version
    hold("cloud512 oracle path", r, main_v, ORACLE_SPP, ORACLE_STRIDE_MAIN, ORACLE_ITEMS_MAIN)
    del r, fb
    torch.cuda.empty_cache()

    # ---- 10.3 the other instantiations on user paths at 256x256
    mk_means = {}
    want = -(-ORACLE_SPP_SMALL // DISPATCH_SPP)
    for v in ORACLE_VARIANTS:
        if v == main_v:
            continue
        path = _path_name(v[1], v[2])
        if path not in mk_means:
            mk = path_renderer(Volume(CLOUD), sky, ORACLE_RES_SMALL, seed, path, device=dev)
            mk.trace(64)
            mk_means[path] = rgb_mean(mk.framebuffer())
            del mk
        r = oracle_renderer(Volume(CLOUD), ORACLE_RES_SMALL, v, BOUNCES)
        oracle.trace_pass.launches = 0
        oracle.trace_pass.launches_by_variant.clear()
        t0 = time.perf_counter()
        r.trace(ORACLE_SPP_SMALL)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = oracle.trace_pass.launches_by_variant.get(v, 0)
        if launches != want or oracle.trace_pass.launches != launches:
            raise AssertionError(f"{path} {label(v)}: ran {oracle.trace_pass.launches_by_variant}")
        record[v]["launches"] = launches
        fb = r.framebuffer()
        mean, ref = rgb_mean(fb), mk_means[path]
        # the megakernel, like the DDA oracle, weighs emission by the global
        # inverse majorant at the local majorant's test rate (the reference's
        # quirk, volren_tpu/ops/tracking.py:12-19; tests/test_torch_tracking.py
        # shows the JAX functions' gap), so it counts less emission than
        # delta tracking: with emission, delta tracking's image may be up to
        # 10% brighter
        quirk = (not v[0]) and v[2]
        rel = (mean - ref) / ref
        print(f"oracle {'DDA' if v[0] else 'delta/ratio'} {path} {label(v)}: cloud512 "
              f"{ORACLE_RES_SMALL}x{ORACLE_RES_SMALL}, {ORACLE_SPP_SMALL} spp through Renderer in "
              f"{seconds!r} s; image mean {mean!r} against the megakernel's {ref!r} at 64 spp "
              f"(rel {rel!r}, bar {'[-0.05, 0.10], the DDA emission weight' if quirk else '0.05'})"
              f" on {gpu_line}", flush=True)
        agrees = -0.05 < rel < (0.10 if quirk else 0.05)
        if r.last_engine != "cuda_oracle" or not bool(torch.isfinite(fb).all()) or \
                not (mean > 0.0 and agrees):
            raise AssertionError(f"{path} {label(v)}: {r.last_engine}, image mean {mean!r} "
                                 f"against the megakernel's {ref!r}")
        # half the pixels in x and y for DDA; delta tracking's long loops
        # keep its plain version to 1 pixel in 256
        hold(f"cloud512 {path}", r, v, ORACLE_SPP_SMALL,
             ORACLE_STRIDE_DDA if v[0] else ORACLE_STRIDE_DELTA, ORACLE_ITEMS_SMALL)
        del r, fb
        torch.cuda.empty_cache()
    print(f"phase 10 (the oracle engine) took {time.time() - t_phase!r} s", flush=True)
    return {f"oracle{label(v)}": rec for v, rec in record.items()}


BAND_SPLITS = (2, 3, 4)                    # phase 11: row bands of a dispatch
DIST_RES, DIST_SPP = 256, 64               # 11.3: two processes over gloo
DIST_CASES = ((2, 1, DIST_RES, DIST_RES, DIST_SPP), (1, 2, DIST_RES, DIST_RES, DIST_SPP))
TRAIN_STEPS, TRAIN_BATCH, TRAIN_PATCH = 20, 8, 64   # phase 12
# ptxas registers of <USE_TF,HAS_EMI> before the kernel took a row band
PREV_REGISTERS = {"<0,0>": 62, "<1,0>": 64, "<0,1>": 70, "<1,1>": 80}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharding_phase(seed, sky_path, sky, gpu_line, cuda_ms) -> dict:
    """Phase 11 (see the module's docstring). Returns the numbers PERF.md
    cites: the band overhead, the world-of-one spp/s, the NCCL merge's ms
    and the two-process runs' records."""
    import torch
    import torch.distributed as dist

    from volren_tpu_torch.measure import PEAK_BYTES_S, path_renderer
    from volren_tpu_torch.ops.kernels import megakernel
    from volren_tpu_torch.ops.kernels.pack import DISPATCH_SPP, build_env_pool, build_params
    from volren_tpu_torch.parallel import dryrun, sharding
    from volren_tpu_torch.voldata import Volume

    t_phase = time.time()
    out = {}

    def merge_bound_ms(width, height, n_tiles):
        # a rank's band read once and the whole (H, W, 4) f32 sum written once
        rows = sharding.band_rows(height, n_tiles, 0)[1]
        return (rows + height) * width * 16 / PEAK_BYTES_S * 1e3

    # 11.1 row bands of 4-spp 1024^2 dispatches, every variant, and its twin
    for path in VARIANT:
        r = path_renderer(Volume(CLOUD), sky, RES, seed, path, device="cuda")
        ks, tp = r._kernel_scene(), r._trace_params()
        pool = build_env_pool(r._env_device, seed, 0)
        pf, pi = build_params(ks, tp, RES, RES, 0, MAIN_CMP_SPP)
        whole = megakernel.render(ks, pool, pf, pi)
        for n in BAND_SPLITS:
            parts, twins = [], []
            for t in range(n):
                row0, rows = sharding.band_rows(RES, n, t)
                _pf, bpi = build_params(ks, tp, RES, RES, 0, MAIN_CMP_SPP, row0, rows)
                parts.append(megakernel.render(ks, pool, pf, bpi))
                img, st = megakernel.render_stats(ks, pool, pf, bpi)
                if st["capped"] != 0:
                    raise AssertionError(f"{path} band {t}/{n}: {st['capped']} capped samples")
                twins.append(img)
            if not torch.equal(torch.cat(parts), whole):
                raise AssertionError(f"{path}: {n} row bands are not bitwise the whole dispatch")
            if not torch.equal(torch.cat(twins), whole):
                raise AssertionError(f"{path}: the STATS twin's {n} bands are not the whole")
        print(f"bands [{path}]: cloud512 {RES}x{RES}, {MAIN_CMP_SPP} spp over {BAND_SPLITS} row "
              f"bands (ragged: {[sharding.band_rows(RES, 3, t)[1] for t in range(3)]} rows), "
              f"kernel and STATS twin bitwise the whole dispatch, 0 capped", flush=True)
        if path == "plain":
            for spp in (MAIN_CMP_SPP, DISPATCH_SPP):
                _pf, spi = build_params(ks, tp, RES, RES, 0, spp)
                bands = [build_params(ks, tp, RES, RES, 0, spp, *sharding.band_rows(RES, 4, t))[1]
                         for t in range(4)]
                one = cuda_ms(lambda: megakernel.render(ks, pool, pf, spi), 3)
                four = cuda_ms(lambda: [megakernel.render(ks, pool, pf, b) for b in bands], 3)
                out[f"band_ms_{spp}"] = (one, four)
                print(f"    band overhead, plain {spp} spp: one dispatch {one!r} ms, 4 bands in "
                      f"turn {four!r} ms ({four / one!r}x) on {gpu_line}", flush=True)
        del r, ks, pool, whole, parts, twins
        torch.cuda.empty_cache()

    # 11.2 distribute() in a world of one over NCCL
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        one = path_renderer(Volume(CLOUD), sky, RES, seed, "plain", device="cuda")
        one.render(DISPATCH_SPP)
        r = path_renderer(Volume(CLOUD), sky, RES, seed, "plain", device="cuda")
        r.distribute()
        if r.mesh.group is None or dist.get_backend(r.mesh.gather_group) != "nccl":
            raise AssertionError("distribute() did not take the NCCL group")
        for run in ("first", "second"):
            megakernel.render.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(DISPATCH_SPP)
            seconds = time.perf_counter() - t0
            launches = megakernel.render.launches
            if launches <= 0 or r.last_engine != "cuda_kernel":
                raise AssertionError(f"the distributed path launched {launches} "
                                     f"({r.last_engine})")
            if not torch.equal(r.framebuffer(), one.framebuffer()):
                raise AssertionError("distribute() in a world of one is not bitwise trace(64)")
            out[f"world_of_one_{run}"] = {"spp_s": DISPATCH_SPP / seconds, "launches": launches}
            print(f"distribute(), {run} render: a world of one over NCCL, cloud512 {RES}x{RES}, "
                  f"trace({DISPATCH_SPP}) bitwise the undistributed one, {launches} launch(es), "
                  f"no collective, {DISPATCH_SPP / seconds!r} spp/s (one process: not a "
                  f"scaling number) on {gpu_line}", flush=True)
        # a world of one makes no collective, so NCCL itself is held on the
        # whole frame: an all_reduce and an all_gather over one rank return it
        g = r.mesh.group
        frame = one.framebuffer().reshape(-1, 4)
        summed, parts = frame.clone(), [torch.empty_like(frame)]

        def nccl_merge():
            dist.all_reduce(summed, group=g)
            dist.all_gather(parts, frame, group=g)

        nccl_merge()   # makes the communicator
        if not (torch.equal(summed, frame) and torch.equal(parts[0], frame)):
            raise AssertionError("NCCL's all_reduce / all_gather over one rank changed the frame")
        out["nccl_ms"] = cuda_ms(nccl_merge, 5)
        print(f"NCCL in a world of one: all_reduce + all_gather of the {RES}x{RES}x4 f32 frame "
              f"{out['nccl_ms']!r} ms (CUDA events; bound {2 * merge_bound_ms(RES, RES, 1)!r} ms "
              f"by bytes) on {gpu_line}", flush=True)
        del one, r, frame, summed, parts
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 11.3 two spawned processes on the one card over gloo
    records = dryrun.dryrun(2, DIST_CASES, device="cuda", volume=CLOUD, sky=sky_path,
                            bounces=BOUNCES, seed=seed, timeout=300)
    for rec in records:
        print(f"gloo, 2 processes on one card, mesh {rec['mesh']}: {DIST_RES}x{DIST_RES}, "
              f"{DIST_SPP} spp: ok {rec['ok']}, bitwise {rec['bitwise']}, max abs "
              f"{rec['max_abs']!r}, {rec['launches']} launch(es) per rank, {rec['engines']}, "
              f"{DIST_SPP / rec['seconds']!r} spp/s of the slowest rank, a merge alone "
              f"{rec['merge_ms']!r} ms (bound {merge_bound_ms(DIST_RES, DIST_RES, rec['mesh'][0])!r}"
              f" ms by bytes; two processes share one card: not a scaling number) on "
              f"{gpu_line}", flush=True)
        if not rec["ok"] or rec["launches"] <= 0 or rec["engines"] != ["cuda_kernel"]:
            raise AssertionError(f"the two-process render disagrees with one process: {rec}")
    out["gloo"] = records

    # 11.4 the CLI under torch.distributed.run
    png = os.path.join(OUT_DIR, "distributed.png")
    for old in (png, png.replace(".png", "_000000.png")):
        if os.path.exists(old):
            os.remove(old)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "volren_tpu_torch.cli", CLOUD,
                           sky_path, "--render", "-w", str(DIST_RES), "-h", str(DIST_RES),
                           "--spp", str(DIST_SPP), "--bounces", str(BOUNCES), "--distribute",
                           "--output", png], capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    written = png.replace(".png", "_000000.png")
    if proc.returncode != 0 or "cuda_kernel" not in proc.stdout or not os.path.getsize(written):
        raise AssertionError(f"the CLI under torch.distributed.run failed ({proc.returncode}): "
                             f"{proc.stdout[-800:]}{proc.stderr[-1500:]}")
    print(f"CLI --distribute under torch.distributed.run --nproc_per_node 1: {written} in "
          f"{time.perf_counter() - t0!r} s of wall, "
          f"{[ln for ln in proc.stdout.splitlines() if 'spp/s' in ln][-1].strip()}", flush=True)
    print(f"phase 11 (rendering across devices) took {time.time() - t_phase!r} s", flush=True)
    return out


def denoiser_phase(seed, sky_path, gpu_line, clean_fb, noisy_fb) -> dict:
    """Phase 12 (see the module's docstring). ``clean_fb`` / ``noisy_fb``:
    phase 5's 256-spp framebuffer and a 4-spp one of the same renderer."""
    import numpy as np
    import torch

    from volren_tpu_torch import cli
    from volren_tpu_torch.measure import denoiser_bound
    from volren_tpu_torch.models import denoiser
    from volren_tpu_torch.utils.image import read_png, save_ldr

    t_phase = time.time()
    out = {}
    model, opt, sched = denoiser.create_train_state(seed, device="cuda")
    denoiser.denoise_image(model, clean_fb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    den = denoiser.denoise_image(model, clean_fb)
    torch.cuda.synchronize()
    out["denoise_ms"] = (time.perf_counter() - t0) * 1e3
    if den.shape != clean_fb.shape or not bool(torch.isfinite(den).all()) or \
            not bool((den >= 0).all()):
        raise AssertionError("denoise_image gave no finite, non-negative image")
    bound_ms, bound_by = denoiser_bound(model.features, 1, RES, RES)
    print(f"denoise_image: {RES}x{RES} framebuffer, bf16, {out['denoise_ms']!r} ms (host clock, "
          f"synced); bound {bound_ms!r} ms by {bound_by} on {gpu_line}", flush=True)
    # 20 steps on one batch of patches of the 4-spp / 256-spp pair
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, RES - TRAIN_PATCH + 1, TRAIN_BATCH)
    xs = rng.integers(0, RES - TRAIN_PATCH + 1, TRAIN_BATCH)

    def patches(fb):
        chw = fb.permute(2, 0, 1)
        return torch.stack([chw[:, y:y + TRAIN_PATCH, x:x + TRAIN_PATCH] for y, x in zip(ys, xs)])

    noisy, clean = patches(noisy_fb), patches(clean_fb)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(denoiser.train_step(model, opt, sched, noisy, clean)))
        times.append((time.perf_counter() - t0) * 1e3)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")
    out["train_step_ms"] = float(np.median(times[1:]))
    bound_ms, bound_by = denoiser_bound(model.features, TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH,
                                        train=True)
    print(f"train_step: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, patch {TRAIN_PATCH}, bf16: "
          f"loss {losses[0]!r} -> {losses[-1]!r}, median {out['train_step_ms']!r} ms a step "
          f"(first {times[0]!r} ms; host clock, synced); bound {bound_ms!r} ms by {bound_by} "
          f"on {gpu_line}", flush=True)

    # every script as python -m volren_tpu_torch.scripts.<name> on the card
    sdir = os.path.join(OUT_DIR, "scripts")
    shutil.rmtree(sdir, ignore_errors=True)
    os.makedirs(sdir)

    def script(name, *args):
        return [sys.executable, "-m", f"volren_tpu_torch.scripts.{name}", *args]

    content, style = os.path.join(sdir, "content.png"), os.path.join(sdir, "style.png")
    save_ldr(content, clean_fb.cpu().numpy()[::4, ::4] * 0.5, flip=True)
    save_ldr(style, noisy_fb.cpu().numpy()[::4, ::4] * 0.5, flip=True)
    t0 = time.perf_counter()
    side = {  # independent scripts, all at once
        "make_cloud": script("make_cloud", "--res", "64", "--output",
                             os.path.join(sdir, "cloud64.brick")),
        "styletransfer": script("styletransfer", content, style, "--epochs", "20",
                                "--save_epochs", "20", "--image_size", "256", "--output",
                                os.path.join(sdir, "styled.png")),
        "datagen_colmap": script("datagen_colmap", "--views", "2", "--spp", "64", "--res", "128",
                                 "--out", os.path.join(sdir, "colmap")),
        "compare_rmse": script("compare_rmse", content, content),
    }
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 cwd=REPO) for k, cmd in side.items()}
    stem = os.path.join(sdir, "ds")
    chain = [script("datagen_denoise", "--count", "2", "--spp", "256", "--res", "128",
                    "--output", stem),
             script("train_denoiser", stem + "_input.npz", stem + "_target.npz", "--steps",
                    "40", "--batch", "4", "--patch", "64", "--output",
                    os.path.join(sdir, "params.pkl"))]
    for cmd in chain:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"{cmd[2]} failed ({proc.returncode}): {proc.stderr[-1500:]}")
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"{name} failed ({proc.returncode}): {stderr[-1500:]}")
    with np.load(stem + "_input.npz") as f:
        if f["color"].shape != (2, 3, 128, 128) or not np.isfinite(f["color"]).all():
            raise AssertionError("datagen_denoise wrote no finite (2, 3, 128, 128) dataset")
    views = sorted(f for f in os.listdir(os.path.join(sdir, "colmap")) if f.endswith(".png"))
    if len(views) != 2 or read_png(os.path.join(sdir, "colmap", views[0])).shape != (128, 128, 4):
        raise AssertionError(f"datagen_colmap wrote {views}")
    out["scripts_s"] = time.perf_counter() - t0
    # a render denoised with the trained parameters
    r, _stats = cli.run([CLOUD, sky_path, "--render", "-w", "256", "-h", "256", "--spp", "16",
                         "--bounces", str(BOUNCES), "--output",
                         os.path.join(sdir, "render.png"), "--device", "cuda"])
    model = denoiser.Denoiser().to("cuda")
    model.load_state_dict(denoiser.from_flax_params(
        denoiser.load_params(os.path.join(sdir, "params.pkl")), model))
    den = denoiser.denoise_image(model, r.fbo_data())
    if not bool(torch.isfinite(den).all()):
        raise AssertionError("the trained denoiser's image is not finite")
    save_ldr(os.path.join(sdir, "render_denoised.png"), den.cpu().numpy(), flip=True)
    print(f"scripts: make_cloud, styletransfer, datagen_colmap, compare_rmse, datagen_denoise "
          f"-> train_denoiser as python -m volren_tpu_torch.scripts.<name>, "
          f"{out['scripts_s']!r} s; a 256x256 --render denoised with the trained parameters, "
          f"under {sdir}", flush=True)
    print(f"phase 12 (the denoiser and the scripts) took {time.time() - t_phase!r} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7, help="seed of the sky, grids and renders")
    args = ap.parse_args(argv)
    t_smoke = time.time()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from volren_tpu_torch import cli
    from volren_tpu_torch import probes as probe_entry
    from volren_tpu_torch.measure import PEAK_BYTES_S, PEAK_F32_S, kernel_bound, path_renderer
    from volren_tpu_torch.ops.kernels import megakernel, oracle
    from volren_tpu_torch.ops.kernels import probes as probe_kernels
    from volren_tpu_torch.probes import probe_pallas2, probe_pallas3
    from volren_tpu_torch.probes._common import Context, interleaved_ms
    from volren_tpu_torch.probes.sites import Q3_OPS, SITES
    from volren_tpu_torch.renderer import DISPATCH_SPP
    from volren_tpu_torch.ops.kernels.pack import bake_mip_u8, bake_tf_majorant, \
        bake_tf_majorant_plain, build_env_pool, build_params, env_pool_plain, pack_pool_rgbe, \
        pool_uniforms, rgbe_encode_plain
    from volren_tpu_torch.ops.kernels.pack import build_mip_u8 as build_mip_u8_plain
    from volren_tpu_torch.ops.scene import upload_transferfunc
    from volren_tpu_torch.scene.transferfunc import TransferFunction
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
    with ThreadPoolExecutor(3) as pool:
        builds = (pool.submit(megakernel.build), pool.submit(probe_kernels.build),
                  pool.submit(oracle.build))
        lib, probe_lib, oracle_lib = (b.result() for b in builds)
    print(f"build: {os.path.relpath(lib, REPO)}, {os.path.relpath(probe_lib, REPO)} and "
          f"{os.path.relpath(oracle_lib, REPO)} in {time.time() - t0:.2f} s; ptxas "
          f"<USE_TF,HAS_EMI>: {megakernel.resource_usage(lib)}", flush=True)
    usage = megakernel.resource_usage(lib)
    regs = dict(re.findall(r"(<[01],[01]>) Used (\d+) registers", usage))
    spills = re.findall(r"(<[01],[01]>(?: stats)?) \d+ bytes stack frame, (\d+) bytes spill stores",
                        usage)
    print(f"    megakernel registers with the row band {regs}, before it {PREV_REGISTERS}; "
          f"spill stores (bytes) {spills}", flush=True)
    f32_frames = dict((k, (int(a), int(b))) for k, a, b in re.findall(
        r"(<[01],[01]>) (\d+) bytes stack frame, (\d+) bytes spill stores", usage))
    print(f"    f32 instantiations' (stack, spill stores) bytes {f32_frames}", flush=True)
    if {k: int(v) for k, v in regs.items()} != PREV_REGISTERS or \
            any(spill for _stack, spill in f32_frames.values()):
        raise AssertionError(f"the f32 instantiations' registers or spills changed: {regs}, "
                             f"{f32_frames}")
    packed = dict(re.findall(r"(<[01],[01]> (?:u8|rgbe|u8\+rgbe)(?: stats)?) Used (\d+) registers",
                             usage))
    packed_spills = re.findall(
        r"(<[01],[01]> (?:u8|rgbe|u8\+rgbe)(?: stats)?) (\d+) bytes stack frame, (\d+) bytes spill "
        r"stores", usage)
    print(f"    packed instantiations' registers {packed}; stack and spill stores (bytes) "
          f"{packed_spills}", flush=True)
    if len(packed) != 24:
        raise AssertionError(f"expected 24 packed instantiations, ptxas reported {sorted(packed)}")
    print(f"    the u8 pyramid's build kernel: "
          f"{[u for u in usage.split('; ') if 'mip_u8_build' in u]}", flush=True)
    phase_s = {"1-2": time.time() - t_smoke}   # each phase's, printed before the card line
    print(f"phases 1-2 took {phase_s['1-2']!r} s", flush=True)
    print(f"    ptxas oracle.cu <USE_DDA,USE_TF,HAS_EMI>: {oracle.resource_usage(oracle_lib)}",
          flush=True)
    for line in probe_kernels.resource_usage(probe_lib):
        print(f"    ptxas probes.cu {line}", flush=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    sky_path = os.path.join(OUT_DIR, "sky.hdr")
    write_hdr(sky_path, procedural_sky(1024, 512, args.seed))
    sky = Environment(sky_path)
    dev = torch.device("cuda")

    def set_packs(r, packs):
        r.pallas_mip_u8 = "1" if packs[0] else "0"
        r.pallas_env_rgbe, r.pallas_pool_rgbe = packs[1], packs[2]

    def scene(volume, res, seed, spp, path="plain", bounces=BOUNCES, packs=NO_PACKS):
        r = path_renderer(volume, sky, res, seed, path, bounces, device=dev)
        set_packs(r, packs)
        ks = r._kernel_scene()
        pool = r._env_pool(0)
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

    def uncapped(name, inputs, image=None):
        """The dispatch through the STATS instantiation: 0 capped samples
        (and, given the kernel's image, the same image)."""
        got, st = megakernel.render_stats(*inputs)
        if st["capped"] != 0:
            raise AssertionError(f"{name}: {st['capped']} capped samples")
        if image is not None and not torch.equal(got, image):
            raise AssertionError(f"{name}: the STATS instantiation's image differs")
        return st

    def check_env_pool(label, env):
        """The NEE pool's draw kernel against its plain version on the same
        CUDA uniforms, f32 and packed, at each of ENV_POOL_DRAWS, bitwise,
        then timed beside its bound, the plain version and build_env_pool's
        host ms (the numpy draw, the pinned copy and the launch; with and
        without a sync after it). The kernel's ms: CUDA events over 20
        launches queued behind a spin kernel, so the window holds the
        device's work and not the wrapper's enqueueing (printed too, as
        the launches back to back)."""
        for rgbe in (False, True):
            name = f"env_pool [{label}, {'packed' if rgbe else 'f32'}]"
            for seed, base in ENV_POOL_DRAWS:
                u2 = pool_uniforms(seed, base, dev)
                got, want = megakernel.env_pool(env, u2, rgbe), env_pool_plain(env, u2, rgbe)
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{name}: the kernel's pool of ({seed}, {base}) is "
                                         f"not its plain version's")
                if not torch.equal(build_env_pool(env, seed, base, rgbe), got):
                    raise AssertionError(f"{name}: build_env_pool is not the kernel's pool")
            ms = Context(dev).time_ms(lambda: megakernel.env_pool(env, u2, rgbe), 20)
            enqueue_ms = cuda_ms(lambda: megakernel.env_pool(env, u2, rgbe), 20)
            plain_ms, _ = host_ms(lambda: env_pool_plain(env, u2, rgbe))
            build_synced_ms, _ = host_ms(lambda: build_env_pool(env, 7, 0, rgbe))
            torch.cuda.synchronize()
            t = time.perf_counter()
            build_env_pool(env, 7, 0, rgbe)
            build_host_ms = (time.perf_counter() - t) * 1e3
            n = u2.shape[0]
            t_bytes = n * (8 + 40 + (20 if rgbe else 32)) / PEAK_BYTES_S
            t_ops = n * (ENV_POOL_OPS + (RGBE_ENCODE_OPS if rgbe else 0)) / PEAK_F32_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"{name}, {n} samples of {env.alias_packed.shape[0]} alias rows: bitwise its "
                  f"plain version at (seed, spp_base) {list(ENV_POOL_DRAWS)}; kernel {ms!r} ms "
                  f"({enqueue_ms!r} back to back with the host's enqueueing), plain "
                  f"{plain_ms!r} ms, bound {bound_ms!r} ms by {bound_by}; build_env_pool "
                  f"{build_host_ms!r} ms of host, {build_synced_ms!r} ms synced on {gpu_line}",
                  flush=True)
            if label == "phases' sky" and not rgbe:
                record["env_pool"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound_ms, "bound_by": bound_by}

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
    t_phase = time.time()
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
            for spp in CMP_SPP:
                label = f"{name} {path}, {CMP_RES}x{CMP_RES}, {spp} spp"
                before = dict(megakernel.render.launches_by_variant)
                inputs = scene(Volume(DenseGrid(w, h, d, dense)), CMP_RES, args.seed, spp, path)
                a = megakernel.render(*inputs)
                b = megakernel.render(*inputs)
                if megakernel.render.launches_by_variant.get(VARIANT[path], 0) != \
                        before.get(VARIANT[path], 0) + 2:
                    raise AssertionError(f"{label}: the variant's launch count did not rise")
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: the kernel is not bitwise deterministic")
                uncapped(label, inputs, a)
                k_ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
                p_ms, plain = host_ms(lambda: megakernel.render_plain(*inputs))
                compare(label, a, plain)
                print(f"    kernel {k_ms!r} ms, plain {p_ms!r} ms on {gpu_line}", flush=True)
                if path == "plain" and spp == CMP_SPP[0]:
                    first = a, plain
                # the packed instantiations: all three packs everywhere, each
                # alone on the random grid at 4 spp
                for pname, packs in CMP_PACK_SETS.items():
                    if pname != "all" and (spp != CMP_SPP[0] or name != "random16"):
                        continue
                    plabel = f"{label}, packed {pname}"
                    key = VARIANT[path] + packs
                    before_p = megakernel.render.launches_by_packs.get(key, 0)
                    pinputs = scene(Volume(DenseGrid(w, h, d, dense)), CMP_RES, args.seed, spp,
                                    path, packs=packs)
                    pa = megakernel.render(*pinputs)
                    pb = megakernel.render(*pinputs)
                    if megakernel.render.launches_by_packs.get(key, 0) != before_p + 2:
                        raise AssertionError(f"{plabel}: the packed instantiation did not launch")
                    if not torch.equal(pa, pb):
                        raise AssertionError(f"{plabel}: the kernel is not bitwise deterministic")
                    uncapped(plabel, pinputs, pa)
                    compare(plabel, pa, megakernel.render_plain(*pinputs))
            if path != "plain":
                continue
            spp = CMP_SPP[0]
            other = megakernel.render(*scene(Volume(DenseGrid(w, h, d, dense)), CMP_RES,
                                             args.seed + 1, spp))
            a, plain, other = (x.cpu().numpy() / spp for x in (*first, other))
            noise = float(np.sqrt(((other - a) ** 2).mean()))
            rmse = float(np.sqrt(((a - plain) ** 2).mean()))
            mean_rel = float(abs(a[:, :3].mean() - plain[:, :3].mean()) / plain[:, :3].mean())
            print(f"    rmse {rmse!r} (bar 1.5 x seed-to-seed noise {noise!r}), mean rel "
                  f"{mean_rel!r} (bar 0.05)", flush=True)
            if not (rmse < 1.5 * noise and mean_rel < 0.05):
                raise AssertionError(f"{name}: kernel disagrees with its plain version")

    phase_s["3"] = time.time() - t_phase
    print(f"phase 3 took {phase_s['3']!r} s", flush=True)

    # ---- 4. kernel vs plain on one dispatch at each path's shapes
    t_phase = time.time()
    record = {}
    for kname, path, _ in KERNELS:
        inputs = scene(Volume(CLOUD), RES, args.seed, MAIN_CMP_SPP, path)
        kernel_out = megakernel.render(*inputs)
        ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
        stats = {}
        plain_ms, plain_out = host_ms(lambda: megakernel.render_plain(*inputs, stats=stats))
        label = f"cloud512 {path} {RES}x{RES}, {MAIN_CMP_SPP} spp, {BOUNCES} bounces"
        max_abs_err = compare(label, kernel_out, plain_out)
        counted = uncapped(label, inputs, kernel_out)
        if {k: counted[k] for k in stats} != stats:
            raise AssertionError(f"{label}: the STATS instantiation counts other events than "
                                 f"the plain version: {counted} against {stats}")
        bound_ms, bound_by, n_bytes, n_ops = kernel_bound(inputs[0], inputs[1], inputs[3], stats)
        print(f"{label}: kernel {ms!r} ms, plain {plain_ms!r} ms per dispatch; bound "
              f"{bound_ms!r} ms by {bound_by} ({n_bytes} bytes, {n_ops} f32 operations from "
              f"events {stats}) on {gpu_line}", flush=True)
        record[kname] = {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        del inputs, kernel_out, plain_out
        # the same dispatch with all three packs on (the plain path: each
        # pack alone too)
        for pname, packs in (PACK_SETS if path == "plain" else {"all": ALL_PACKS}).items():
            inputs = scene(Volume(CLOUD), RES, args.seed, MAIN_CMP_SPP, path, packs=packs)
            kernel_out = megakernel.render(*inputs)
            ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
            stats = {}
            plain_ms, plain_out = host_ms(lambda: megakernel.render_plain(*inputs, stats=stats))
            plabel = f"{label}, packed {pname}"
            max_abs_err = compare(plabel, kernel_out, plain_out)
            counted = uncapped(plabel, inputs, kernel_out)
            if {k: counted[k] for k in stats} != stats:
                raise AssertionError(f"{plabel}: the STATS instantiation counts other events "
                                     f"than the plain version: {counted} against {stats}")
            bound_ms, bound_by, n_bytes, n_ops = kernel_bound(inputs[0], inputs[1], inputs[3],
                                                              stats)
            print(f"{plabel}: kernel {ms!r} ms, plain {plain_ms!r} ms per dispatch; bound "
                  f"{bound_ms!r} ms by {bound_by} ({n_bytes} bytes, {n_ops} f32 operations from "
                  f"events {stats}) on {gpu_line}", flush=True)
            if pname == "all":
                record[f"{kname}_packed"] = {"max_abs_err": max_abs_err, "ms": ms,
                                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                                             "bound_by": bound_by}
            del inputs, kernel_out, plain_out
            torch.cuda.empty_cache()
    # the old one-thread-per-pixel schedule's worst shape: few pixels, many
    # samples each (64: the main path's dispatch)
    for _kname, path, _ in KERNELS:
        for spp in SMALL_CMP_SPP:
            inputs = scene(Volume(CLOUD), SMALL_RES, args.seed, spp, path)
            kernel_out = megakernel.render(*inputs)
            ms = cuda_ms(lambda: megakernel.render(*inputs), 3)
            plain_ms, plain_out = host_ms(lambda: megakernel.render_plain(*inputs))
            label = f"cloud512 {path} {SMALL_RES}x{SMALL_RES}, {spp} spp, {BOUNCES} bounces"
            compare(label, kernel_out, plain_out)
            st = uncapped(label, inputs, kernel_out)
            print(f"{label}: kernel {ms!r} ms, plain {plain_ms!r} ms; SIMT efficiency "
                  f"{st['simt_march']!r}, tail {st['tail_ms']!r} ms on {gpu_line}", flush=True)
            del inputs, kernel_out, plain_out
            torch.cuda.empty_cache()

    # the main path's dispatch, 64 spp at 1024x1024, on the float32 tables
    # and packed, timed in turns; the bound from each one's STATS twin
    for kname, path, _ in KERNELS:
        sets = {"f32": NO_PACKS, **(PACK_SETS if path == "plain" else {"all": ALL_PACKS})}
        dispatches = {pname: scene(Volume(CLOUD), RES, args.seed, DISPATCH_SPP, path, packs=packs)
                      for pname, packs in sets.items()}
        times = {pname: [] for pname in sets}
        for _ in range(PACK_ROUNDS):
            for pname, inputs in dispatches.items():
                times[pname].append(cuda_ms(lambda: megakernel.render(*inputs), 3))
        line = []
        for pname, inputs in dispatches.items():
            st = uncapped(f"cloud512 {path} {RES}x{RES}, {DISPATCH_SPP} spp, {pname}", inputs)
            bound_ms, bound_by, _nb, _no = kernel_bound(inputs[0], inputs[1], inputs[3], st)
            med = float(np.median(times[pname]))
            levels = [st[k] for k in megakernel.LEVEL_COUNTS if k in st]
            line.append(f"{pname} {med!r} ms (rounds {times[pname]!r}), bound {bound_ms!r} ms by "
                        f"{bound_by}, {st['march']} substeps"
                        + (f" (levels 0-3: {levels})" if levels else "") + f", {st['test']} tests")
            if pname == "all":
                record[f"{kname}_packed"].update(ms_64spp=med, bound_ms_64spp=bound_ms)
            elif pname == "f32":
                record[kname].update(ms_64spp=med, bound_ms_64spp=bound_ms)
        print(f"cloud512 {path} {RES}x{RES}, {DISPATCH_SPP}-spp dispatch in turns: " + "; ".join(line)
              + f" on {gpu_line}", flush=True)
        del dispatches
        torch.cuda.empty_cache()

    # the RGBE encode kernel at the packed main path's shapes: a dispatch's
    # pool radiance (a strided view of the pool) and the sky's texels
    r = path_renderer(Volume(CLOUD), sky, RES, args.seed, "plain", device=dev)
    encode_rows = {"pool radiance": build_env_pool(r._env_device, args.seed, 0)[:, 4:7],
                   "sky texels": r._env_device.envmap.reshape(-1, 3)}
    for label, rows in encode_rows.items():
        got = megakernel.rgbe_encode(rows)
        ms = Context(dev).time_ms(lambda: megakernel.rgbe_encode(rows), 20)
        rate_ms = cuda_ms(lambda: megakernel.rgbe_encode(rows), 20)
        plain_ms, want = host_ms(lambda: rgbe_encode_plain(rows))
        if not torch.equal(got, want):
            raise AssertionError(f"rgbe_encode [{label}]: the kernel's words are not its plain "
                                 f"version's ({int((got != want).sum())} differ)")
        n = rows.shape[0]
        t_bytes, t_ops = n * 16 / PEAK_BYTES_S, n * RGBE_ENCODE_OPS / PEAK_F32_S
        bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
        print(f"rgbe_encode [{label}, {n} rows]: bitwise its plain version; kernel {ms!r} ms "
              f"(behind a spin; {rate_ms!r} back to back with the wrapper's enqueueing), plain "
              f"{plain_ms!r} ms, bound {bound_ms!r} ms by {bound_by} on {gpu_line}", flush=True)
        if label == "pool radiance":
            record["rgbe_encode"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by}
    pool = build_env_pool(r._env_device, args.seed, 0)
    got = pack_pool_rgbe(pool)
    want = torch.cat([pool[:, :4].contiguous().view(torch.int32).reshape(-1),
                      rgbe_encode_plain(pool[:, 4:7])])
    if not torch.equal(got, want):
        raise AssertionError("pack_pool_rgbe: the encode kernel's packed pool is not the plain "
                             "version's")
    print(f"pack_pool_rgbe: one launch of the encode kernel, bitwise the plain version's rows "
          f"and words ({got.numel()} words)", flush=True)
    check_env_pool("phases' sky", r._env_device)
    del r, encode_rows, pool, got, want

    # the u8 pyramid's build kernel against its plain version (torch ops on
    # the same CUDA tensors): cloud512's pyramid times density_scale and
    # TF-baked, the random 16^3 grid's, and ragged levels with a level of
    # one value, a level of zeros and exact zeros
    builds = []
    for label, path in (("cloud512", "plain"), ("cloud512 TF-baked", "tf")):
        r = path_renderer(Volume(CLOUD), sky, RES, args.seed, path, device=dev)
        ks, tp = r._kernel_scene(), r._trace_params()
        builds.append((label, ks.mip_tf if path == "tf" else ks.mip, ks.mip_dims,
                       ks.mip_offsets, None if path == "tf" else tp.density_scale))
        del r
    ks, _pool, _pf, _pi = scene(Volume(DenseGrid(16, 16, 16, g16)), CMP_RES, args.seed, 4)
    builds.append(("random16", ks.mip, ks.mip_dims, ks.mip_offsets, 1.7))
    builds.append(("ragged", *_ragged_pyramid(dev), None))
    for label, mip, dims, offs, scale in builds:
        q, dq = megakernel.build_mip_u8(mip, dims, offs, scale)

        def plain(mip=mip, dims=dims, offs=offs, scale=scale):
            base = mip if scale is None else mip * torch.tensor(float(scale), device=dev)
            q, lo, sc = build_mip_u8_plain(base, dims, offs)
            return q, torch.stack([lo, sc])

        plain_ms, (want_q, want_dq) = host_ms(plain)
        if not (torch.equal(q, want_q) and torch.equal(dq, want_dq)):
            raise AssertionError(f"build_mip_u8 [{label}]: the kernel's bytes or (lo, scale) "
                                 f"rows are not the plain version's")
        ms = Context(dev).time_ms(lambda: megakernel.build_mip_u8(mip, dims, offs, scale), 20)
        rate_ms = cuda_ms(lambda: megakernel.build_mip_u8(mip, dims, offs, scale), 20)
        n = mip.numel()
        t_bytes, t_ops = (n * 5 + 32) / PEAK_BYTES_S, n * MIP_U8_OPS / PEAK_F32_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"build_mip_u8 [{label}, {n} entries, levels {dims}]: bitwise its plain version, "
              f"(lo, scale) {dq.tolist()}; kernel {ms!r} ms (behind a spin; {rate_ms!r} back to "
              f"back with the wrapper's enqueueing), plain {plain_ms!r} ms, bound {bound_ms!r} "
              f"ms by {bound_by} on {gpu_line}", flush=True)
        if label == "cloud512":
            record["build_mip_u8"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound_ms, "bound_by": bound_by}
    del builds, ks

    # the TF majorant's bake kernel against its plain version (torch ops on
    # the same CUDA tensors): cloud512's and the random 16^3 grid's raw
    # pyramids through the --fau LUT and through a 4-bin LUT under the window
    # [0.25, 0.75), whose ends clamp entries of both; timed behind a spin
    t_bake = time.time()
    edge = TransferFunction([(0.9, 0.2, 0.1, 0.1), (0.2, 0.9, 0.6, 0.7), (1.0, 1.0, 1.0, 0.4),
                             (0.5, 0.5, 0.5, 0.9)])
    edge.window_left, edge.window_width = 0.25, 0.5
    edge = upload_transferfunc(edge, dev)
    r = path_renderer(Volume(CLOUD), sky, RES, args.seed, "tf", device=dev)
    r._kernel_scene()
    bakes = [("cloud512", r._packed[1], r._trace_params())]
    r16 = path_renderer(Volume(DenseGrid(16, 16, 16, g16)), sky, CMP_RES, args.seed, "tf",
                        device=dev)
    r16._kernel_scene()
    bakes.append(("random16", r16._packed[1], r16._trace_params()))
    for label, frame, tp in bakes:
        for lut_name, tf in (("--fau", frame.tf), ("edge window", edge)):
            name = f"bake_tf_majorant [{label}, {lut_name}]"
            before = megakernel.bake_tf_majorant.launches
            got = megakernel.bake_tf_majorant(frame.mip, tf, tp)
            if megakernel.bake_tf_majorant.launches != before + 1:
                raise AssertionError(f"{name}: not one launch of the bake kernel")
            plain_ms, want = host_ms(lambda: bake_tf_majorant_plain(frame.mip, tf, tp))
            if not (bool(torch.isfinite(got).all()) and torch.equal(got, want)):
                raise AssertionError(f"{name}: the kernel's table is not its plain version's "
                                     f"({int((got != want).sum())} entries differ)")
            ms = Context(dev).time_ms(lambda: megakernel.bake_tf_majorant(frame.mip, tf, tp), 20)
            rate_ms = cuda_ms(lambda: megakernel.bake_tf_majorant(frame.mip, tf, tp), 20)
            n = frame.mip.numel()
            t_bytes = (n * 8 + tf.lut.numel() * 4) / PEAK_BYTES_S
            t_ops = n * BAKE_TF_OPS / PEAK_F32_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"{name}, {n} entries, {tf.lut.shape[0]} LUT bins: bitwise its plain version; "
                  f"kernel {ms!r} ms (behind a spin; {rate_ms!r} back to back with the wrapper's "
                  f"enqueueing), plain {plain_ms!r} ms, bound {bound_ms!r} ms by {bound_by} on "
                  f"{gpu_line}", flush=True)
            if label == "cloud512" and lut_name == "--fau":
                record["bake_tf_majorant"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                              "bound_ms": bound_ms, "bound_by": bound_by}
    del r, r16, bakes, got, want
    print(f"the TF majorant's bake took {time.time() - t_bake!r} s", flush=True)

    # where the RGBE environment pays: a sky whose float32 texels overflow
    # the L2 and whose RGBE words fit in it, the plain path's 64-spp
    # dispatch on each, in turns
    t_sky = time.time()
    big = Environment(procedural_sky(*BIG_SKY, args.seed))
    r = path_renderer(Volume(CLOUD), big, RES, args.seed, "plain", device=dev)
    big_sets = {"f32": NO_PACKS, "env_rgbe": PACK_SETS["env_rgbe"]}
    dispatches = {}
    for pname, packs in big_sets.items():
        set_packs(r, packs)
        ks = r._kernel_scene()
        pf, pi = build_params(ks, r._trace_params(), RES, RES, 0, DISPATCH_SPP)
        dispatches[pname] = (ks, r._env_pool(0), pf, pi)
    torch.cuda.synchronize()
    t_sky = time.time() - t_sky
    check_env_pool(f"{BIG_SKY[0]}x{BIG_SKY[1]} sky", r._env_device)
    times = {pname: [] for pname in big_sets}
    for _ in range(PACK_ROUNDS):
        for pname, inputs in dispatches.items():
            times[pname].append(cuda_ms(lambda: megakernel.render(*inputs), 3))
    line = []
    for pname, inputs in dispatches.items():
        st = uncapped(f"cloud512 plain {RES}x{RES} under a {BIG_SKY[0]}x{BIG_SKY[1]} sky, "
                      f"{pname}", inputs)
        env = inputs[0].env_rgbe if pname == "env_rgbe" else inputs[0].env
        line.append(f"{pname} {float(np.median(times[pname]))!r} ms (rounds {times[pname]!r}), "
                    f"texels {env.numel() * env.element_size()} bytes, {st['escape']} escapes")
    print(f"cloud512 plain {RES}x{RES}, {DISPATCH_SPP}-spp dispatch under a "
          f"{BIG_SKY[0]}x{BIG_SKY[1]} procedural sky, in turns: " + "; ".join(line)
          + f"; the sky and its tables built in {t_sky!r} s (host and card) on {gpu_line}",
          flush=True)
    del r, big, dispatches
    torch.cuda.empty_cache()
    phase_s["4"] = time.time() - t_phase
    print(f"phase 4 took {phase_s['4']!r} s", flush=True)

    # ---- 5-7. the three paths through the entry points a user calls
    t_phase = time.time()
    path_means, path_renderers = {}, {}

    def check_path(kname, path, run):
        variant = VARIANT[path]
        megakernel.render.launches = 0
        megakernel.render.launches_by_variant.clear()
        megakernel.env_pool.launches = 0
        megakernel.bake_tf_majorant.launches = 0
        r, seconds = run()
        launches = megakernel.render.launches_by_variant.get(variant, 0)
        pools, bakes = megakernel.env_pool.launches, megakernel.bake_tf_majorant.launches
        if launches <= 0 or launches != megakernel.render.launches:
            raise AssertionError(f"the {path} path did not launch (only) its CUDA kernel "
                                 f"variant: {megakernel.render.launches_by_variant}")
        if pools != launches:
            raise AssertionError(f"the {path} path drew {pools} NEE pools with the draw kernel "
                                 f"in {launches} dispatches")
        # the offline loop traces a dispatch at a time: a TF path bakes its
        # majorant table once a trace
        if bakes != (launches if variant[0] else 0):
            raise AssertionError(f"the {path} path launched the TF majorant's bake {bakes} times "
                                 f"in {launches} dispatches")
        if r.last_engine != "cuda_kernel":
            raise AssertionError(f"the {path} path ran {r.last_engine}")
        ks, tp = r._kernel_scene(), r._trace_params()
        for base in range(0, SPP, DISPATCH_SPP):
            pool = build_env_pool(r._env_device, int(r.seed), base)
            pf, pi = build_params(ks, tp, RES, RES, base, DISPATCH_SPP)
            uncapped(f"the {path} path's dispatch at sample {base}", (ks, pool, pf, pi))
        fb = r.framebuffer()
        if tuple(fb.shape) != (RES, RES, 4) or not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"the {path} path's framebuffer is not a finite (H, W, 4) image")
        mean = fb.mean(dim=(0, 1)).tolist()
        if not mean[0] > 0.0:
            raise AssertionError(f"the {path} path's framebuffer is black: mean {mean}")
        print(f"{path} path: cloud512 {RES}x{RES}, {SPP} spp, {BOUNCES} bounces: "
              f"{SPP / seconds!r} spp/s ({seconds!r} s, {launches} kernel launch(es), "
              f"{pools} of the pool's draw kernel, {bakes} of the TF bake's, framebuffer mean "
              f"{[round(m, 4) for m in mean]}) on {gpu_line}", flush=True)
        record[kname]["launches"] = launches
        if kname == "megakernel":
            record["env_pool"]["launches"] = pools
        if kname == "megakernel_tf":
            record["bake_tf_majorant"]["launches"] = bakes
        path_means[path] = float(fb[..., :3].mean())
        path_renderers[path] = r

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

    # the four paths again through Renderer.render, on the float32 tables
    # and with all three packs, each layout in a Renderer of its own (its
    # tables packed by an untimed render first): f32, then packed
    for kname, path, _ in KERNELS:
        renderers = {}
        for packed_run in (False, True):
            renderers[packed_run] = path_renderer(Volume(CLOUD), sky, RES, args.seed, path,
                                                  device=dev)
            set_packs(renderers[packed_run], ALL_PACKS if packed_run else NO_PACKS)
            # the packed tables' first dispatch: the frame's RGBE texels, the
            # trace's u8 pyramid and the dispatch's packed pool, one launch each
            for counted in (megakernel.render, megakernel.rgbe_encode, megakernel.build_mip_u8,
                            megakernel.env_pool, megakernel.bake_tf_majorant):
                counted.launches = 0
            renderers[packed_run].render(DISPATCH_SPP)
            first = (megakernel.render.launches, megakernel.rgbe_encode.launches,
                     megakernel.build_mip_u8.launches, megakernel.env_pool.launches,
                     megakernel.bake_tf_majorant.launches)
            if first != ((1, 1, 1, 1) if packed_run else (1, 0, 0, 1)) + (int(VARIANT[path][0]),):
                raise AssertionError(f"the {path} path's first {'packed' if packed_run else 'f32'} "
                                     f"dispatch launched (render, rgbe_encode, build_mip_u8, "
                                     f"env_pool, bake_tf_majorant) {first}")
            if packed_run and path == "plain":
                record["rgbe_encode"]["launches"] = first[1]
        runs = {False: [], True: []}
        for packed_run in (False, True):          # packs_measure times both in rounds
            packs = ALL_PACKS if packed_run else NO_PACKS
            r = renderers[packed_run]
            key = VARIANT[path] + packs
            megakernel.render.launches = 0
            megakernel.render.launches_by_packs.clear()
            megakernel.rgbe_encode.launches = 0
            megakernel.build_mip_u8.launches = 0
            megakernel.env_pool.launches = 0
            megakernel.bake_tf_majorant.launches = 0
            seconds, _ = host_ms(lambda: r.render(SPP))
            seconds /= 1e3
            launches = megakernel.render.launches_by_packs.get(key, 0)
            if launches <= 0 or launches != megakernel.render.launches:
                raise AssertionError(f"the {path} path ({'packed' if packed_run else 'f32'}) "
                                     f"launched {megakernel.render.launches_by_packs}")
            encodes, builds = megakernel.rgbe_encode.launches, megakernel.build_mip_u8.launches
            pools, bakes = megakernel.env_pool.launches, megakernel.bake_tf_majorant.launches
            # a packed pool is drawn packed: no encode launch a dispatch; a
            # render is one trace: one TF bake and one u8 build
            if (encodes, builds, pools, bakes) != (0, 1 if packed_run else 0, launches,
                                                   int(VARIANT[path][0])):
                raise AssertionError(f"the {path} path ({'packed' if packed_run else 'f32'}) "
                                     f"launched the RGBE encode {encodes}, the u8 pyramid's "
                                     f"build {builds}, the pool's draw {pools} and the TF "
                                     f"bake {bakes} times in {launches} dispatches")
            if packed_run and path == "plain" and "launches" not in record["build_mip_u8"]:
                record["build_mip_u8"]["launches"] = builds
            fb = r.framebuffer()
            if tuple(fb.shape) != (RES, RES, 4) or not bool(torch.isfinite(fb).all()):
                raise AssertionError(f"the packed {path} path's framebuffer is not finite")
            runs[packed_run].append((SPP / seconds, float(fb[..., :3].mean()), launches))
        r = renderers[True]
        ks, tp = r._kernel_scene(), r._trace_params()
        for base in range(0, SPP, DISPATCH_SPP):
            pf, pi = build_params(ks, tp, RES, RES, base, DISPATCH_SPP)
            uncapped(f"the packed {path} path's dispatch at sample {base}",
                     (ks, r._env_pool(base), pf, pi))
        # the trace's TF majorant table and u8 pyramid, baked with no host
        # sync (torch's sync debug mode raises on one), one launch each;
        # the f32 Renderer's trace set-up too
        frame = r._packed[1]
        torch.cuda.synchronize()
        megakernel.bake_tf_majorant.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            if frame.tf is not None:
                frame = bake_tf_majorant(frame, tp)
            baked = bake_mip_u8(frame, tp)
            f32_ks = renderers[False]._kernel_scene()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not (torch.equal(baked.mip_u8, ks.mip_u8) and torch.equal(baked.mip_dq, ks.mip_dq)):
            raise AssertionError(f"the {path} path's u8 pyramid differs from its trace's")
        if frame.tf is not None and not (
                megakernel.bake_tf_majorant.launches == 2 and torch.equal(frame.mip_tf, ks.mip_tf)
                and torch.equal(f32_ks.mip_tf, bake_tf_majorant_plain(
                    f32_ks.mip, f32_ks.tf, renderers[False]._trace_params()))):
            raise AssertionError(f"the {path} path's TF majorant table differs from its "
                                 f"trace's, or took other than one bake launch a trace")
        f32_mean, packed_mean = runs[False][0][1], runs[True][0][1]
        if not (f32_mean > 0.0 and abs(packed_mean - f32_mean) / f32_mean < 0.05):
            raise AssertionError(f"the packed {path} path's mean {packed_mean} is not within 5% "
                                 f"of the f32 mean {f32_mean}")
        print(f"{path} path through Renderer.render({SPP}), cloud512 {RES}x{RES}, {BOUNCES} "
              f"bounces: f32 {[run[0] for run in runs[False]]!r} spp/s, all packs "
              f"{[run[0] for run in runs[True]]!r} spp/s ({runs[True][0][2]} launches of the "
              f"packed instantiation); image mean f32 {f32_mean!r}, packed {packed_mean!r} "
              f"({(packed_mean - f32_mean) / f32_mean:+.4%}) on {gpu_line}", flush=True)
        record[f"{kname}_packed"].update(launches=runs[True][0][2],
                                         spp_s=[run[0] for run in runs[True]],
                                         spp_s_f32=[run[0] for run in runs[False]])
        del r, renderers, fb, frame, baked, f32_ks
        torch.cuda.empty_cache()
    print(f"the u8 pyramid and the TF majorant table baked with no host sync on each path; "
          f"{record['build_mip_u8']}, {record['bake_tf_majorant']}", flush=True)
    main_r = path_renderers.pop("plain")
    clean_fb = main_r.framebuffer()[..., :3].clone()
    main_r.render(MAIN_CMP_SPP)
    noisy_fb = main_r.framebuffer()[..., :3].clone()
    path_renderers.clear()
    del main_r

    phase_s["5-7"] = time.time() - t_phase
    print(f"phases 5-7 took {phase_s['5-7']!r} s", flush=True)

    # ---- 8. the probe kernels: kernel vs plain at each call site's shapes
    t_phase = time.time()
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

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def registers(*kernels):
        return [u for u in probe_kernels.resource_usage(probe_lib)
                if u.startswith(kernels) and "registers" in u]

    print(f"lcg_gather_sum: {probe_kernels.LCG_UNROLL} loads in flight a lane, exact multiply-high division, "
          f"{probe_kernels.lcg_threads(1024, n_sms)}-thread blocks at 1024 lanes on {n_sms} SMs; "
          f"ptxas {registers('lcg_gather_sum')}", flush=True)
    print(f"row_gather_rounds stage/staged: 16-byte cp.async, each warp copying its own lanes' "
          f"rows for n > {probe_kernels.BLOCK_COPY_MAX} (no block barrier in the loop), the "
          f"whole block between three block barriers for n <= {probe_kernels.BLOCK_COPY_MAX}; "
          f"ptxas {registers('row_gather_rounds<2,', 'row_gather_rounds<3,')}", flush=True)
    print(f"gather: one word a thread in {probe_kernels.GATHER_THREADS}-thread blocks (4 in "
          f"16-byte accesses for a gather within a row by a column index, Q2), the modes as "
          f"template arguments, up to {probe_kernels.GATHER_TABLES} tables a launch; "
          f"ptxas {registers('gather<')}", flush=True)
    print(f"affine_loop (P1, P2, P4): one chain a thread, blocks of {probe_kernels.AFFINE_U} "
          f"steps written out and a remainder loop; ptxas {registers('affine_loop')}", flush=True)
    print(f"row_gather_rounds direct (dmagather3): {probe_kernels.DIRECT_INFLIGHT} rounds' loads "
          f"in flight a lane, the row advanced without a division, the mask a template "
          f"argument; ptxas {registers('row_gather_direct')}", flush=True)
    print(f"carry30: a lane's values over {probe_kernels.CARRY_PARTS} threads, a systolic "
          f"pipeline over blocks of {probe_kernels.CARRY_U} steps, the words a block ahead, "
          f"exact multiply-high division, "
          f"{probe_kernels.lcg_threads(1024 * probe_kernels.CARRY_PARTS, n_sms)}-thread blocks at "
          f"1024 lanes; ptxas {registers('carry30')}", flush=True)
    m_threads, m_grid = probe_kernels.march_plan(128, n_sms)
    print(f"march (Q6): one thread a (row, column), each running its column's row-0 chain, "
          f"{probe_kernels.MARCH_COLS} columns a warp, {m_grid} blocks of {m_threads} threads "
          f"at W 128 on {n_sms} SMs, 0.5 + jitter from the LCG's bits (no conversion), the "
          f"clamp one VIMNMX.RELU; ptxas {registers('march')}", flush=True)
    q3_plans = {op: probe_kernels.index_copy_args(8, 128, op, arg, 0, n_sms)[5]
                for op, arg in Q3_OPS[1:]}
    print(f"index_copy (Q3 but the transpose): the op a template argument, 4 words of `per` "
          f"rows a thread and no division (a 4-word segment with 16-byte stores where the row "
          f"is whole quads; a roll's 4 words a block's width apart), (tx, ty, gx, gy, per) at "
          f"Q3's shapes {q3_plans}; ptxas {registers('index_copy')}", flush=True)
    for site in SITES:
        case = site.make(ctx)
        before = probe_launches()
        got = case.kernel()
        per_call = probe_launches() - before
        err = compare_probe(site.name, got, case.plain(), case.exact)
        plain_ms, _ = host_ms(case.plain)
        if site.name in PROBES_IN_TURNS:
            n_turns = PROBES_IN_TURNS[site.name]
            turns = interleaved_ms(ctx, {"kernel": case.kernel, "library": case.library}, n_turns)
            ms, library_ms = turns["kernel"]["median"], turns["library"]["median"]
            calls = "its PyTorch call" if case.library_calls == 1 else \
                f"its {case.library_calls} PyTorch calls"
            print(f"{site.name} in turns with {calls}, {n_turns} rounds, ms median "
                  f"(p10, p90): "
                  + ", ".join(f"{k} {v['median']!r} ({v['p10']!r}, {v['p90']!r})"
                              for k, v in turns.items()) + f" on {gpu_line}", flush=True)
        else:
            ms = ctx.time_ms(case.kernel, reps_for(case.kernel, per_call))
            library_ms = (ctx.time_ms(case.library, reps_for(case.library)) if case.library
                          else None)
        bound_ms, bound_by = case.bound()
        print(f"{site.name} ({site.family}, {site.replaces}): kernel vs plain max abs {err!r} "
              f"({'bitwise' if case.exact else 'rtol 1e-5'}); kernel {ms!r} ms, plain "
              f"{plain_ms!r} ms, library {library_ms!r} ms, bound {bound_ms!r} ms by {bound_by} "
              f"({case.n_bytes} bytes, {case.n_ops} operations) on {gpu_line}", flush=True)
        record[site.name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        if case.library and case.library_calls != 1:
            record[site.name]["library_calls"] = case.library_calls
        del case
    # tea8 and row_scan beyond the probes' shapes: ragged sizes, aligned and
    # one element past a 16-byte boundary (row_scan's word path beside its
    # float4 path), then both in turns with P0's launch floor and torch.cumsum
    rng = np.random.default_rng(args.seed)
    for n in TEA8_SIZES:
        a_all, b_all = (probe_kernels.u32_bits(torch.from_numpy(
            rng.integers(0, 2 ** 32, n + 1, dtype=np.uint32).astype(np.int64)).to(dev))
            for _ in range(2))
        for off in (0, 1):
            a, b = a_all[off:off + n], b_all[off:off + n]
            compare_probe(f"tea8 n {n} offset {off}", probe_kernels.tea8(a, b),
                          probe_kernels.tea8_plain(a, b), True)
    for h, w in ROW_SCAN_SHAPES:
        flat = torch.from_numpy(rng.random(h * w + 1).astype(np.float32)).to(dev)
        for off in (0, 1):
            x = flat[off:off + h * w].view(h, w)
            compare_probe(f"row_scan ({h}, {w}) offset {off}", probe_kernels.row_scan(x),
                          probe_kernels.row_scan_plain(x), False)
    sites = {site.name: site for site in SITES}
    q5, cumsum, p0 = (sites[name].make(ctx) for name in ("probe_Q5", "probe_cumsum", "probe_P0"))
    turns = interleaved_ms(ctx, {"tea8": q5.kernel, "row_scan": cumsum.kernel,
                                 "torch.cumsum": cumsum.library, "P0": p0.kernel,
                                 "x * 2": p0.library}, 31)
    print(f"tea8 at n {TEA8_SIZES} and row_scan at {ROW_SCAN_SHAPES}, aligned and one element "
          f"in, agree with their plain versions; at the probes' (8, 128), 31 rounds in turns, "
          f"ms median (p10, p90): "
          + ", ".join(f"{k} {v['median']!r} ({v['p10']!r}, {v['p90']!r})" for k, v in turns.items())
          + f"; tea8: one pair a thread, row_scan: one warp a row, "
          f"{probe_kernels.SCAN_WARPS} rows a block; "
          f"ptxas {registers('tea8', 'row_scan')} on {gpu_line}", flush=True)
    del q5, cumsum, p0
    # Q6's chain floor: a step's latency on one warp alone, times Q6's steps,
    # plus the launch floor (P0's time in this run)
    step_ms = probe_pallas2.q6_step_ms(ctx)
    q6_rec, p0_ms = record["probe_Q6"], record["probe_P0"]["ms"]
    q6_rec["chain_floor_ms"] = probe_pallas2.Q6_ITERS * step_ms + p0_ms
    print(f"march (Q6) chain floor: a step on one warp {step_ms * 1e6!r} ns (64 -> 512 steps, "
          f"median of 5) x {probe_pallas2.Q6_ITERS} steps + the launch floor (P0, {p0_ms!r} ms) "
          f"= {q6_rec['chain_floor_ms']!r} ms; the kernel {q6_rec['ms']!r} ms, its bound "
          f"{q6_rec['bound_ms']!r} ms by {q6_rec['bound_by']} on {gpu_line}", flush=True)
    # the transpose where its bytes, not its launch, set the time
    big = torch.rand(probe_pallas3.BIG, probe_pallas3.BIG, device=dev)
    if not torch.equal(probe_kernels.index_copy(big, "transpose"), big.t()):
        raise AssertionError("the transpose of a 8192 x 8192 array disagrees with t.t()")
    turns = probe_pallas3.transpose_vs_library(ctx, big, rounds=21)
    big_bound = 2 * big.numel() * 4 / PEAK_BYTES_S * 1e3
    print(f"transpose {probe_pallas3.BIG}x{probe_pallas3.BIG} f32, bitwise t.t(), in turns, 21 "
          f"rounds, ms median (p10, p90): " + ", ".join(
              f"{k} {v['median']!r} ({v['p10']!r}, {v['p90']!r})" for k, v in turns.items())
          + f"; bound {big_bound!r} ms by bytes, kernel's share "
          f"{big_bound / turns['kernel']['median']!r} on {gpu_line}", flush=True)
    del big
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
    phase_s["8"] = time.time() - t_phase
    print(f"phase 8 took {phase_s['8']!r} s", flush=True)

    # ---- 9. the front ends
    t_phase = time.time()
    record["megakernel_tf_emission"]["launches"] = front_ends(
        args.seed, sky_path, sky, gpu_line, scene, cuda_ms)
    phase_s["9"] = time.time() - t_phase
    print(f"phase 9 took {phase_s['9']!r} s", flush=True)

    # ---- 10. the oracle engine
    t_phase = time.time()
    oracle_record = oracle_phase(args.seed, sky_path, sky, gpu_line, cuda_ms, host_ms,
                                 (("random16", g16), ("cloud512_crop64", crop)), path_means)
    phase_s["10"] = time.time() - t_phase

    # ---- 11. rendering across devices
    t_phase = time.time()
    sharding_phase(args.seed, sky_path, sky, gpu_line, cuda_ms)
    phase_s["11"] = time.time() - t_phase

    # ---- 12. the denoiser and the scripts
    t_phase = time.time()
    denoiser_phase(args.seed, sky_path, gpu_line, clean_fb, noisy_fb)
    del clean_fb, noisy_fb
    phase_s["12"] = time.time() - t_phase

    kernels = [dict(name=kname, route="cuda", source="volren_tpu_torch/csrc/megakernel.cu",
                    replaces=replaces, library_ms=None, **record[kname])
               for kname, _path, replaces in KERNELS]
    kernels += [dict(name=f"{kname}_packed", route="cuda",
                     source="volren_tpu_torch/csrc/megakernel.cu", replaces=PACKED_REPLACES,
                     library_ms=None, **record[f"{kname}_packed"])
                for kname, _path, _replaces in KERNELS]
    kernels.append(dict(name="rgbe_encode", route="cuda",
                        source="volren_tpu_torch/csrc/megakernel.cu",
                        replaces=RGBE_ENCODE_REPLACES, library_ms=None, **record["rgbe_encode"]))
    kernels.append(dict(name="env_pool", route="cuda", source="volren_tpu_torch/csrc/megakernel.cu",
                        replaces=ENV_POOL_REPLACES, library_ms=None, **record["env_pool"]))
    kernels.append(dict(name="build_mip_u8", route="cuda",
                        source="volren_tpu_torch/csrc/megakernel.cu",
                        replaces=MIP_U8_REPLACES, library_ms=None, **record["build_mip_u8"]))
    kernels.append(dict(name="bake_tf_majorant", route="cuda",
                        source="volren_tpu_torch/csrc/megakernel.cu",
                        replaces=BAKE_TF_REPLACES, library_ms=None, **record["bake_tf_majorant"]))
    kernels += [dict(name=site.name, route="cuda", source="volren_tpu_torch/csrc/probes.cu",
                     replaces=site.replaces, **record[site.name]) for site in SITES]
    kernels += [dict(name=name, route="cuda", source="volren_tpu_torch/csrc/oracle.cu",
                     replaces=ORACLE_REPLACES, library_ms=None, **rec)
                for name, rec in oracle_record.items()]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # the oracle's: ms a pass of its launch, the bound's share, what plain_ms traced
    # the harness's library_ms: two PyTorch calls (library_calls), as no one call gathers
    # two tables
    # Q6's: chain_floor_ms, the latency floor beside its bound
    # the megakernel's: the 64-spp dispatch's ms and bound; the packed ones':
    # spp/s of their path's Renderer.render runs, and of the f32 runs in turns
    extra = ("ms_per_pass", "passes_per_launch", "share", "plain_of", "library_calls",
             "chain_floor_ms", "ms_64spp", "bound_ms_64spp", "spp_s", "spp_s_f32")
    phase_s["total"] = time.time() - t_smoke
    print(f"chip_smoke took {phase_s['total']!r} s; each phase's seconds: "
          f"{json.dumps(phase_s)}", flush=True)
    print(gpu_line)
    print(json.dumps({"kernels": [{k: entry[k] for k in keys + extra if k in keys or k in entry}
                                  for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
