"""The packed tables' cost on one CUDA card, taken apart, for PERF.md.

    python -m volren_tpu_torch.packs_measure [--tree DIR ...] [--rounds N] [--seed N]

Run from the repository root on a machine with a CUDA card. Each ``--tree``
is a checkout of the repository (default: the one this module lies in). Its
``volren_tpu_torch`` package is imported under a name of its own and builds
its kernels into that checkout's ``build/``, so two trees (a parent commit
unpacked under ``build/`` and this one) are measured in one process on one
card, in turns: the trees in the given order in even rounds, reversed in
odd ones. The scene is the plain path's: .scene_cache/cloud512.brick at
1024x1024, 100 bounces, under chip_smoke.py's procedural sky of ``--seed``,
once on the float32 tables and once with volren_tpu's Pallas defaults (the
u8 majorant pyramid, the RGBE environment and the RGBE NEE pool), each in a
Renderer of its own, so no timed run flips a switch. Per tree and round:

1. ``Renderer.render(256)`` on the host clock, f32 and packed: spp/s;
2. one render(256) of each under torch.profiler: the device's kernels and
   copies, their summed ms, the device's busy ms (the union of their time
   ranges) and that render's wall;
3. ``pack.bake_mip_u8`` of the trace's tables: the host ms of the call
   alone and with a device sync after it, the kernels and copies it put on
   the device with their summed ms (torch.profiler), and the host syncs it
   made (torch.cuda's sync debug mode); the same of ``pack.bake_tf_majorant``
   of the TF path's tables (the CLI's --fau LUT), the feeder of every TF
   trace;
4. ``pack.pack_pool_rgbe`` of one dispatch's pool, and
   ``pack.build_env_pool`` of one dispatch, f32 and packed (the NEE pool
   drawn from its uniforms): the same;
5. ``pack.pack_scene(..., env_rgbe=True)``, paid once per frame or switch
   flip: host ms with a sync;
6. the 64-spp dispatch of the kernel on the f32 tables, with each pack
   alone and with all three: CUDA-event ms;
7. the interactive loop's step (cli's ``--serve`` preview): ``trace(4)``
   with a device sync on the f32 tables at 256x256, the median of
   ``STEPS`` steps on the host clock; the same on the TF path (--fau), on
   the f32 tables and with all three packs, whose every step bakes its TF
   majorant table (and its u8 pyramid).

Each host-clock number is the median of ``REPS`` calls. With
``--build-variants``, then the u8 pyramid build's design alternative
(BUILD_VARIANTS: one thread block cluster of 16 or 8 blocks in place of the
shipped cooperative launch) in turns with every tree's build kernel, device
ms behind a spin kernel. With ``--variants``, then the u8 march's design
alternatives (MARCH_VARIANTS:
edits of csrc/megakernel.cu built under build/variants/, each image
bitwise the shipped kernel's): the 64-spp dispatch with the u8 pyramid
alone and with all three packs through each, in turns with the shipped
library and the f32 dispatch, ``--rounds`` rounds, with ptxas's registers
and spills of their plain-variant instantiations. Every line carries the
card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, BOUNCES, SPP, DISPATCH_SPP = 1024, 100, 256, 64
REPS = 20          # host-clock calls a median is taken over
STEP_RES, STEP_SPP, STEPS = 256, 4, 64   # item 7: the interactive loop's preview step
# the dispatches of item 6: (mip_u8, env_rgbe, pool_rgbe)
PACK_SETS = {"f32": (False, False, False), "u8": (True, False, False),
             "env_rgbe": (False, True, False), "pool_rgbe": (False, False, True),
             "all": (True, True, True)}


# the u8 march's design alternatives: edits of csrc/megakernel.cu, each an
# old text found once and its replacement, applied in order
_DECODE = "  const float2 d = s_mip_dq[mip_i];\n  return d.x + float(__ldg(K.mip_u8 + idx)) * d.y;"
# the byte converted exactly without I2F: 2^23 + q as a float's bits, less 2^23
_EXACT = [(_DECODE, _DECODE.replace("float(__ldg(K.mip_u8 + idx))",
                                    "(__uint_as_float(0x4B000000u | __ldg(K.mip_u8 + idx)) "
                                    "- 8388608.0f)"))]
# (lo, scale) loaded from their rows in device memory in the march
_DQ_LDG = [(_DECODE, _DECODE.replace("const float2 d = s_mip_dq[mip_i];",
                                     "const float2 d = make_float2(__ldg(K.mip_dq + mip_i), "
                                     "__ldg(K.mip_dq + 4 + mip_i));"))]
# (lo, scale) copied on the stream into a __constant__ array before each
# launch and selected per level as constant-bank operands, as kernel
# parameters would be
_CONSTANT = [
    ("struct Packed {", "__constant__ float c_mip_dq[8];\n\nstruct Packed {"),
    ("    if (mip_i == m) idx = P.mip_offsets[m] + (bzm * my + bym) * mx + bxm;\n  }\n" + _DECODE,
     "    if (mip_i == m) {\n      idx = P.mip_offsets[m] + (bzm * my + bym) * mx + bxm;\n"
     "      lo = c_mip_dq[m];\n      sc = c_mip_dq[4 + m];\n    }\n  }\n"
     "  return lo + float(__ldg(K.mip_u8 + idx)) * sc;"),
    ("  int idx = 0;\n#pragma unroll\n  for (int m = 0; m < 4; ++m) {\n    const int mz = P.mip_dims[3 * m], "
     "my = P.mip_dims[3 * m + 1], mx = P.mip_dims[3 * m + 2];\n    const int bxm = clampi(ix >> (3 + m), "
     "0, mx - 1);\n    const int bym = clampi(iy >> (3 + m), 0, my - 1);\n    const int bzm = "
     "clampi(iz >> (3 + m), 0, mz - 1);\n    if (mip_i == m) {\n      idx",
     "  int idx = 0;\n  float lo = 0.0f, sc = 0.0f;\n#pragma unroll\n  for (int m = 0; m < 4; ++m) {\n"
     "    const int mz = P.mip_dims[3 * m], my = P.mip_dims[3 * m + 1], mx = P.mip_dims[3 * m + 2];\n"
     "    const int bxm = clampi(ix >> (3 + m), 0, mx - 1);\n    const int bym = clampi(iy >> (3 + m), "
     "0, my - 1);\n    const int bzm = clampi(iz >> (3 + m), 0, mz - 1);\n    if (mip_i == m) {\n"
     "      idx"),
    ("  const Kernel kernel = pick_kernel(use_tf, has_emi, packs, stats != nullptr);",
     "  if ((packs & PACK_MIP_U8) && cudaMemcpyToSymbolAsync(c_mip_dq, mip_dq, sizeof(c_mip_dq), 0,"
     " cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream)) != cudaSuccess)\n"
     "    return int(cudaErrorInvalidValue);\n"
     "  const Kernel kernel = pick_kernel(use_tf, has_emi, packs, stats != nullptr);")]
# the byte a substep ahead: a substep that neither collides nor exits
# leaves t = t_adv and mip = mip_up, which do not depend on its majorant, so
# the next substep's byte is fetched before this one's is decoded
_PREFETCH_MARCH = r"""
__device__ __forceinline__ int mip_index(const Params& P, const float c[3], int mip_i) {
  const int ix = int(floorf(c[0])), iy = int(floorf(c[1])), iz = int(floorf(c[2]));
  int idx = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int mz = P.mip_dims[3 * m], my = P.mip_dims[3 * m + 1], mx = P.mip_dims[3 * m + 2];
    const int bxm = clampi(ix >> (3 + m), 0, mx - 1);
    const int bym = clampi(iy >> (3 + m), 0, my - 1);
    const int bzm = clampi(iz >> (3 + m), 0, mz - 1);
    if (mip_i == m) idx = P.mip_offsets[m] + (bzm * my + bym) * mx + bxm;
  }
  return idx;
}

template <bool STATS, int N>
__device__ __forceinline__ void march_u8(const Params& P, const Packed& K, Lane& s,
                                         Counters<N>& cnt) {
  const bool is_extend = s.mode == MODE_EXTEND;
  uint32_t q;
  {
    float curr[3];
    for (int k = 0; k < 3; ++k) curr[k] = s.i0[k] + s.t * s.id[k];
    q = __ldg(K.mip_u8 + mip_index(P, curr, int(rintf(s.mip))));
  }
  do {
    if (STATS) warp_tick(cnt.v[ST_MARCH_ISSUES], cnt.v[ST_MARCH_LANES]);
    float curr[3];
    for (int k = 0; k < 3; ++k) curr[k] = s.i0[k] + s.t * s.id[k];
    const int mip_i = int(rintf(s.mip));
    if (STATS) {
#pragma unroll
      for (int m = 0; m < 4; ++m) cnt.v[ST_LEVEL0 + m] += mip_i == m ? 1u : 0u;
    }
    const float2 d = s_mip_dq[mip_i];
    const float dim = float(8 << mip_i);
    const float inv_dim = 1.0f / dim;
    float dts[3];
    for (int k = 0; k < 3; ++k) {
      const float offs = s.ri[k] >= 0.0f ? dim + 0.5f : -0.5f;
      dts[k] = (floorf(curr[k] * inv_dim) * dim + offs - curr[k]) * s.ri[k];
    }
    const float dt = vmin(dts[0], vmin(dts[1], dts[2]));
    const float t_adv = s.t + dt;
    const float mip_up = vmin(s.mip + 0.25f, 3.0f);
    float next[3];
    for (int k = 0; k < 3; ++k) next[k] = s.i0[k] + t_adv * s.id[k];
    const uint32_t q_next = __ldg(K.mip_u8 + mip_index(P, next, int(rintf(mip_up))));
    const float maj = d.x + float(q) * d.y;
    const float tau_adv = s.tau - maj * dt;
    const bool collide = tau_adv <= 0.0f;
    s.t = collide ? t_adv + tau_adv / vmax(maj, 1e-20f) : t_adv;
    const bool exited = s.t >= s.far_t;
    const bool test = collide && !exited;
    if (!collide) { s.tau = tau_adv; s.mip = mip_up; }
    if (test) {
      s.tau = maj;
      s.mip = mip_up;
      s.event = EV_TEST;
    } else if (exited) {
      s.event = is_extend ? EV_EXT_EXIT : EV_SH_EXIT;
    }
    s.steps += 1;
    q = q_next;
  } while (s.event == EV_NONE && s.steps < P.budget);
}

// null-collision test (resolve_tests"""
_PREFETCH = [("\n// null-collision test (resolve_tests", _PREFETCH_MARCH),
             ("      do {\n        if (STATS) warp_tick(cnt.v[ST_MARCH_ISSUES], cnt.v[ST_MARCH_LANES]);\n"
              "        if constexpr (STATS && MIP_U8) {",
              "      if constexpr (MIP_U8) march_u8<STATS>(P, K, s, cnt);\n      else do {\n"
              "        if (STATS) warp_tick(cnt.v[ST_MARCH_ISSUES], cnt.v[ST_MARCH_LANES]);\n"
              "        if constexpr (STATS && MIP_U8) {")]
MARCH_VARIANTS = {"exact byte conversion": _EXACT, "(lo, scale) by __ldg": _DQ_LDG,
                  "(lo, scale) in the constant bank": _CONSTANT, "prefetch": _PREFETCH}

# the u8 pyramid build's design alternative: one thread block cluster of N
# blocks (16, a cluster's most, or 8, the portable most), which folds its
# blocks' partials through distributed shared memory with no grid sync and
# quantises on the cluster's N SMs alone, launched in place of the shipped
# cooperative kernel (its helpers shared)
_CLUSTER_KERNEL = r"""
template <int CLUSTER>
__global__ void __launch_bounds__(MIPQ_THREADS, 1)
mip_u8_build_cluster(const float* __restrict__ mip, float factor, int scaled, MipLevels L,
                     uint8_t* __restrict__ q, float* __restrict__ dq) {
  constexpr int R = CLUSTER >= 16 ? 3 : 5;     // cloud512's 37,440 quads in registers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int n = L.off[3] + L.n[3], quads = (n + 3) >> 2, stride = CLUSTER * MIPQ_THREADS;
  const int c0 = rank * MIPQ_THREADS + int(threadIdx.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(mip) & 15) == 0;
  const bool word = (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  float lo[4], hi[4];
  for (int m = 0; m < 4; ++m) {
    lo[m] = __int_as_float(0x7f800000);
    hi[m] = -__int_as_float(0x7f800000);
  }
  float4 v[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (c0 + j * stride < quads) v[j] = mipq_load(mip, 4 * (c0 + j * stride), n, vec, factor, scaled);
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (c0 + j * stride < quads) mipq_fold4(L, 4 * (c0 + j * stride), n, v[j], lo, hi);
  for (int c = c0 + R * stride; c < quads; c += stride)
    mipq_fold4(L, 4 * c, n, mipq_load(mip, 4 * c, n, vec, factor, scaled), lo, hi);
  __shared__ float red[MIPQ_THREADS / 32][8];
  __shared__ float part[8], lohi[8], lvl_lo[4], lvl_sc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    lo[m] = mipq_warp_col(m, lo[m]);
    hi[m] = mipq_warp_col(4 + m, hi[m]);
  }
  if (lane == 0) {
    for (int m = 0; m < 4; ++m) {
      red[warp][m] = lo[m];
      red[warp][4 + m] = hi[m];
    }
  }
  __syncthreads();
  const int k = warp;
  if (k < 8) {
    const float x = mipq_warp_col(k, red[lane][k]);
    if (lane == 0) part[k] = x;
  }
  cluster.sync();
  if (k < 8) {
    const float x = mipq_warp_col(k, *cluster.map_shared_rank(&part[k], lane & (CLUSTER - 1)));
    if (lane == 0) lohi[k] = x;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x < 4) {
    const int m = threadIdx.x;
    const float l = lohi[m], sc = (lohi[4 + m] - l) * INV_25499;
    lvl_lo[m] = l;
    lvl_sc[m] = sc;
    if (rank == 0) {
      dq[m] = l;
      dq[4 + m] = sc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (c0 + j * stride < quads)
      mipq_store4(L, 4 * (c0 + j * stride), n, v[j], word, lvl_lo, lvl_sc, q);
  for (int c = c0 + R * stride; c < quads; c += stride)
    mipq_store4(L, 4 * c, n, mipq_load(mip, 4 * c, n, vec, factor, scaled), word, lvl_lo,
                lvl_sc, q);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

int mipq_blocks() {"""
_COOP_LAUNCH = ("  return int(cudaLaunchCooperativeKernel(mip_u8_build, dim3(mipq_blocks()), "
                "dim3(MIPQ_THREADS),\n                                         args, 0, "
                "static_cast<cudaStream_t>(stream)));")
_CLUSTER_LAUNCH = r"""  (void)args;
  static const cudaError_t ok = cudaFuncSetAttribute(
      mip_u8_build_cluster<N>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (ok != cudaSuccess) return int(ok);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N);
  cfg.blockDim = dim3(MIPQ_THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, mip_u8_build_cluster<N>, mip_p, factor, scaled, L, q_p,
                                dq_p));"""
BUILD_VARIANTS = {f"cluster of {n}": [("\nint mipq_blocks() {", _CLUSTER_KERNEL),
                                      (_COOP_LAUNCH, _CLUSTER_LAUNCH.replace("<N>", f"<{n}>")
                                       .replace("(N)", f"({n})").replace("= N;", f"= {n};"))]
                  for n in (16, 8)}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _package(tree: str):
    """The volren_tpu_torch package of the checkout ``tree``, imported under
    a name of its own (its modules import each other relatively)."""
    root = os.path.abspath(tree)
    if root == REPO:
        return importlib.import_module("volren_tpu_torch")
    pkg = os.path.join(root, "volren_tpu_torch")
    name = f"volren_tree_{len(sys.modules)}"
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


class Tree:
    """One checkout's renderers (f32 and packed) of the plain path."""

    def __init__(self, tree: str, sky_path: str, seed: int):
        pkg = _package(tree)
        self.label = os.path.relpath(os.path.abspath(tree), REPO) if tree else "."
        mod = lambda m: importlib.import_module(f"{pkg.__name__}.{m}")   # noqa: E731
        self.pack, self.mk, measure = mod("ops.kernels.pack"), mod("ops.kernels.megakernel"), \
            mod("measure")
        env_mod, voldata = mod("scene.environment"), mod("voldata")
        if not self.mk.SOURCE.startswith(os.path.abspath(tree or REPO)):
            raise AssertionError(f"{self.label}: imported the kernel source {self.mk.SOURCE}")
        cloud = os.path.join(REPO, ".scene_cache", "cloud512.brick")
        self.r = {}
        for packed in (False, True):
            r = measure.path_renderer(voldata.Volume(cloud), env_mod.Environment(sky_path), RES,
                                      seed, "plain", BOUNCES)
            _set_packs(r, (packed,) * 3)
            r.render(DISPATCH_SPP)                     # the tables, the kernel build
            self.r[packed] = r
        self.preview = {}
        for name, path, packs in (("plain", "plain", False), ("tf", "tf", False),
                                  ("tf_packed", "tf", True)):
            r = measure.path_renderer(voldata.Volume(cloud), env_mod.Environment(sky_path),
                                      STEP_RES, seed, path, BOUNCES)
            _set_packs(r, (packs,) * 3)
            r.render(STEP_SPP)
            self.preview[name] = r
        self.seed = seed


def _median_ms(fn, sync_after: bool) -> float:
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        if sync_after:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _device_work(fn):
    """(kernels, kernel ms, copies, copy ms, busy ms) that ``fn`` put on the
    device, from torch.profiler: each device event once (by name and time
    range), busy ms the union of their time ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = {(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA}
    kernels, k_us, copies, c_us, busy, end = 0, 0.0, 0, 0.0, 0.0, float("-inf")
    for name, start, stop in sorted(events, key=lambda e: e[1]):
        if name.startswith(("Memcpy", "Memset")):
            copies, c_us = copies + 1, c_us + stop - start
        else:
            kernels, k_us = kernels + 1, k_us + stop - start
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return kernels, k_us / 1e3, copies, c_us / 1e3, busy / 1e3


def _syncs(fn) -> int:
    """The host syncs ``fn`` made, as torch.cuda's sync debug mode warns of them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _feeder(label, fn) -> dict:
    fn()                                               # warm
    kernels, k_ms, copies, c_ms, _busy = _device_work(fn)
    return {"what": label, "host_ms": _median_ms(fn, False), "host_ms_synced": _median_ms(fn, True),
            "kernels": kernels, "kernel_ms": k_ms, "copies": copies, "copy_ms": c_ms,
            "syncs": _syncs(fn)}


def _step_ms(r) -> float:
    """Item 7: the median host ms of a trace(STEP_SPP) and a device sync."""
    r.reset()
    out = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.trace(STEP_SPP)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _set_packs(r, packs):
    r.pallas_mip_u8 = "1" if packs[0] else "0"
    r.pallas_env_rgbe, r.pallas_pool_rgbe = packs[1], packs[2]


def _dispatch_ms(t: Tree, packs) -> float:
    r = t.r[True]
    _set_packs(r, packs)
    ks, tp = r._kernel_scene(), r._trace_params()
    pool = r._env_pool(0)
    pf, pi = t.pack.build_params(ks, tp, RES, RES, 0, DISPATCH_SPP)
    t.mk.render(ks, pool, pf, pi)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        t.mk.render(ks, pool, pf, pi)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 3


def measure_round(t: Tree) -> dict:
    out = {}
    for packed in (False, True):
        r = t.r[packed]
        torch.cuda.synchronize()
        s = time.perf_counter()
        r.render(SPP)
        wall = time.perf_counter() - s
        torch.cuda.synchronize()
        s = time.perf_counter()
        kernels, k_ms, copies, c_ms, busy = _device_work(lambda: r.render(SPP))
        profiled_wall = (time.perf_counter() - s) * 1e3
        key = "packed" if packed else "f32"
        out[f"{key}_spp_s"] = SPP / wall
        out[f"{key}_profiled"] = {"kernels": kernels, "kernel_ms": k_ms, "copies": copies,
                                  "copy_ms": c_ms, "busy_ms": busy, "wall_ms": profiled_wall}
    for name, packs in PACK_SETS.items():
        out[f"dispatch_ms_{name}"] = _dispatch_ms(t, packs)
    _set_packs(t.r[True], PACK_SETS["all"])
    r = t.r[True]
    tp, scene = r._trace_params(), r._packed[1]     # the frame's tables, packed
    pool = t.pack.build_env_pool(r._env_device, t.seed, 0)
    out["bake_mip_u8"] = _feeder("bake_mip_u8", lambda: t.pack.bake_mip_u8(scene, tp))
    out["pack_pool_rgbe"] = _feeder("pack_pool_rgbe", lambda: t.pack.pack_pool_rgbe(pool))
    out["build_env_pool"] = _feeder("build_env_pool",
                                    lambda: t.pack.build_env_pool(r._env_device, t.seed, 0))
    out["build_env_pool_rgbe"] = _feeder(
        "build_env_pool_rgbe", lambda: t.pack.build_env_pool(r._env_device, t.seed, 0, rgbe=True))
    rt = t.preview["tf"]
    tf_scene, tf_params = rt._packed[1], rt._trace_params()
    out["bake_tf_majorant"] = _feeder("bake_tf_majorant",
                                      lambda: t.pack.bake_tf_majorant(tf_scene, tf_params))
    grid, env = r._density_grids[0], r._env_device
    out["pack_scene_env_rgbe_ms"] = _median_ms(
        lambda: t.pack.pack_scene(grid, env, env_rgbe=True), True)
    out["step_ms"] = _step_ms(t.preview["plain"])
    out["step_ms_tf"] = _step_ms(t.preview["tf"])
    out["step_ms_tf_packed"] = _step_ms(t.preview["tf_packed"])
    return out


def _build_variants(t: Tree, variants: dict) -> dict:
    """The libraries of ``variants`` (name: edits of the tree ``t``'s
    csrc/megakernel.cu, each an old text found once and its replacement),
    built at once under build/variants/: name -> library path."""
    from .ops.kernels import build as _build

    src = open(t.mk.SOURCE).read()
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        paths[name] = os.path.join(out_dir, "megakernel_" + "".join(
            c if c.isalnum() else "_" for c in name) + ".cu")
        with open(paths[name], "w") as f:
            f.write(text)
    with ThreadPoolExecutor(len(paths)) as ex:
        return dict(zip(paths, ex.map(lambda p: t.mk.build(source=p), paths.values())))


def build_variants(trees: list, rounds: int, card: str):
    """The u8 build's design alternatives (BUILD_VARIANTS, from this
    checkout's source) in turns with every tree's shipped build kernel, on
    cloud512's pyramid times density_scale: each bitwise this checkout's
    build, then its device ms a build (CUDA events over 20 builds queued
    behind a spin kernel, probes' Context.time_ms), ``rounds`` rounds."""
    from .probes._common import Context

    here = next(t for t in trees if t.label == ".")
    built = _build_variants(here, BUILD_VARIANTS)
    shipped = here.mk._lib()
    r = here.r[False]
    ks, tp = r._kernel_scene(), r._trace_params()
    args = (ks.mip, ks.mip_dims, ks.mip_offsets, tp.density_scale)

    def run(lib):
        def fn():
            here.mk._LIB = lib
            try:
                return here.mk.build_mip_u8(*args)
            finally:
                here.mk._LIB = shipped
        return fn

    fns = {f"shipped [{t.label}]": (lambda t=t: t.mk.build_mip_u8(*args)) for t in trees}
    want_q, want_dq = here.mk.build_mip_u8(*args)
    for name, path in built.items():
        print(f"build variant {name}: "
              f"{[u for u in here.mk.resource_usage(path).split('; ') if 'mip_u8_build' in u]}",
              flush=True)
        fns[name] = run(here.mk.load(path))
    for name, fn in fns.items():
        q, dq = fn()
        if not (torch.equal(q, want_q) and torch.equal(dq, want_dq)):
            raise AssertionError(f"build {name}: not this checkout's bytes and rows")
    ctx, times = Context(torch.device("cuda")), {name: [] for name in fns}
    for k in range(rounds):
        for name, fn in (fns.items() if k % 2 == 0 else list(fns.items())[::-1]):
            times[name].append(ctx.time_ms(fn, 20))
    for name, ms in times.items():
        print(f"build {name}: cloud512's {ks.mip.numel()} entries, device median "
              f"{statistics.median(ms)!r} ms, rounds {ms!r} [{card}]", flush=True)


def march_variants(t: Tree, rounds: int, card: str):
    """The u8 march's design alternatives (MARCH_VARIANTS) of the tree
    ``t``, in turns with its shipped library."""
    built = _build_variants(t, MARCH_VARIANTS)
    shipped = t.mk._lib()
    libs = {"shipped": shipped, **{name: t.mk.load(path) for name, path in built.items()}}
    for name, path in (("shipped", t.mk.build()), *built.items()):
        usage = [u for u in t.mk.resource_usage(path).split("; ") if " u8" in u]
        print(f"variant {name}: {usage}", flush=True)
    r = t.r[True]
    inputs = {}
    for pname in ("f32", "u8", "all"):
        _set_packs(r, PACK_SETS[pname])
        ks = r._kernel_scene()
        inputs[pname] = (ks, r._env_pool(0),
                         *t.pack.build_params(ks, r._trace_params(), RES, RES, 0, DISPATCH_SPP))
    _set_packs(r, PACK_SETS["all"])

    def run(lib, pname):
        t.mk._LIB = lib
        try:
            return t.mk.render(*inputs[pname])
        finally:
            t.mk._LIB = shipped

    for pname in ("u8", "all"):
        want = run(shipped, pname)
        for name, lib in libs.items():
            if not torch.equal(run(lib, pname), want):
                raise AssertionError(f"variant {name}, {pname}: not the shipped kernel's image")
    times = {}
    for _ in range(rounds):
        for name, lib in libs.items():
            for pname in (("f32", "u8", "all") if name == "shipped" else ("u8", "all")):
                run(lib, pname)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                for _ in range(3):
                    run(lib, pname)
                end.record()
                end.synchronize()
                times.setdefault(f"{name}, {pname}", []).append(start.elapsed_time(end) / 3)
    for key, ms in times.items():
        print(f"variant {key}: 64-spp dispatch median {statistics.median(ms)!r} ms, rounds "
              f"{ms!r} [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout to measure (repeatable; default: this one)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7, help="seed of the sky and the renders")
    ap.add_argument("--variants", action="store_true",
                    help="then time the u8 march's design alternatives (MARCH_VARIANTS)")
    ap.add_argument("--build-variants", action="store_true",
                    help="then time the u8 build's design alternatives (BUILD_VARIANTS) in "
                         "turns with every tree's build kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("packs_measure: no CUDA device", file=sys.stderr)
        return 1
    from .scene.environment import procedural_sky
    from .utils.hdr import write_hdr

    card = _card()
    out_dir = os.path.join(REPO, "build", "packs_measure")
    os.makedirs(out_dir, exist_ok=True)
    sky_path = os.path.join(out_dir, "sky.hdr")
    write_hdr(sky_path, procedural_sky(1024, 512, args.seed))
    paths = args.tree or [REPO]
    with ThreadPoolExecutor(len(paths)) as ex:     # each tree's kernel library, built at once
        list(ex.map(lambda p: importlib.import_module(
            f"{_package(p).__name__}.ops.kernels.megakernel").build(), paths))
    trees = [Tree(t, sky_path, args.seed) for t in paths]
    results = {t.label: [] for t in trees}
    for k in range(args.rounds):
        for t in (trees if k % 2 == 0 else trees[::-1]):
            res = measure_round(t)
            results[t.label].append(res)
            print(f"round {k} [{t.label}]: {res!r} [{card}]", flush=True)
    for label, runs in results.items():
        med = lambda f: statistics.median(f(x) for x in runs)   # noqa: E731
        f32, packed = med(lambda x: x["f32_spp_s"]), med(lambda x: x["packed_spp_s"])
        summary = {
            "f32_spp_s": f32, "packed_spp_s": packed, "packed_over_f32": packed / f32,
            "extra_ms_per_trace": (SPP / packed - SPP / f32) * 1e3,
            "kernel_excess_ms_per_trace": med(lambda x: x["dispatch_ms_all"]
                                              - x["dispatch_ms_f32"]) * SPP / DISPATCH_SPP,
            "dispatch_ms": {name: med(lambda x, name=name: x[f"dispatch_ms_{name}"])
                            for name in PACK_SETS},
            "busy_ms": {key: med(lambda x, key=key: x[f"{key}_profiled"]["busy_ms"])
                        for key in ("f32", "packed")},
            **{f: {k: med(lambda x, f=f, k=k: x[f][k])
                   for k in ("host_ms", "host_ms_synced", "kernels", "kernel_ms", "copies",
                             "copy_ms", "syncs")}
               for f in ("bake_mip_u8", "bake_tf_majorant", "pack_pool_rgbe", "build_env_pool",
                         "build_env_pool_rgbe")},
            "pack_scene_env_rgbe_ms": med(lambda x: x["pack_scene_env_rgbe_ms"]),
            **{f: med(lambda x, f=f: x[f]) for f in ("step_ms", "step_ms_tf", "step_ms_tf_packed")},
        }
        print(f"summary [{label}], medians of {args.rounds} rounds: {summary!r} [{card}]",
              flush=True)
    if args.build_variants:
        build_variants(trees, 2 * args.rounds + 1, card)
    if args.variants:
        march_variants(next(t for t in trees if t.label == "."), args.rounds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
