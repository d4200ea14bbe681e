"""The design alternatives of four probe kernels, timed in turns on the card.

    python -m volren_tpu_torch.probes.variants [--rounds N]

W4's transpose: the shipped kernel (``csrc/probes.cu``: 16-byte segments
through a shared tile, one tile a block) against three alternatives built
here from the same source, each held bitwise to ``t.t()``:

- "registers": a 4 x 4 block of words in each thread's registers, four
  16-byte loads and four 16-byte stores, no shared memory and no barrier
  (``REGISTERS_CU``, its own library);
- "band loop": the shipped kernel with a loop over every gy-th band of
  rows, which would lift the 65535-band limit of the grid's second axis;
- "int pitch": the shipped kernel with its row pitch a 32-bit int;

and PyTorch's ``.t().contiguous()``, at W4's three shapes (``--rounds``
rounds) and at 8192 x 8192 f32 (21 rounds), with the bound by bytes.

P0's one step (x * 2 on an (8, 128) f32 block): the short kernel in
256-thread blocks (shipped) against 128- and 64-thread blocks, the loop
kernel (one element a thread, what P1, P2 and P4 time) and PyTorch's
``x * 2``, each bitwise ``x * 2``, in three runs of ``--rounds`` rounds.

Q5's ``tea8`` and the cumsum's ``row_scan`` at the probes' (8, 128)
(``--only tea8,row_scan``): the shipped kernel against its design
alternatives (tea8: ``TEA_DESIGNS``, 1, 2 or 4 pairs a thread with their
chains interleaved, in 4-, 8- or 16-byte accesses, blocks of 32 to 256
threads, built from ``DESIGNS_CU``; row_scan: edits of ``SCAN_WARPS``, the
rows a block), the parent commit's kernel (``--parent DIR``, a checkout
whose package is imported as ``volren_parent`` and builds its own
library), P0's launch floor (the short kernel's x * 2) and, for
``row_scan``, ``torch.cumsum``; each held to its plain version first (tea8
bitwise, row_scan within rtol 1e-5), then ``--runs`` runs of ``--rounds``
rounds in turns. Each run also times the chains on one warp alone
(``DESIGNS_CU``: 1, 2 and 4 pairs' TEA rounds, the shipped row scan,
repeated 64 -> 512 times, the median of 5 marginals) and prints the floor:
P0's median plus the shipped kernel's chain, 8 rounds of one pair (tea8)
or one scan (row_scan). ``--sass DIR`` writes the kernels' SASS there and
prints their instructions by opcode.

One line per shape or run: the median and p10-p90 of each, in ms, and the
card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..measure import PEAK_BYTES_S
from ..ops.kernels import build as _build
from ..ops.kernels import probes as K
from ._common import Context, card_line, interleaved_ms, marginal

SHAPES = ((128, 1024), (1024, 128), (8, 1024), (8192, 8192))
OUT_DIR = os.path.join(_build.BUILD_DIR, "variants")

REGISTERS_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int TQ_X = 16, TQ_Y = 2;   // a warp: 16 column quads by 2 row quads

// out (W, H) = x (H, W), H and W multiples of 4: each thread moves one
// 4 x 4 block of words; a block is `warps` warps down the rows
__global__ void transpose_registers_kernel(const uint32_t* __restrict__ x, int H, int W, int gx,
                                           uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int bx = blockIdx.x % gx, by = blockIdx.x / gx;
  const int c = 4 * (bx * TQ_X + lane % TQ_X);
  const int r = 4 * ((by * warps + (threadIdx.x >> 5)) * TQ_Y + lane / TQ_X);
  if (r >= H || c >= W) return;
  const uint32_t* src = x + (long long)r * W + c;
  uint32_t* dst = out + (long long)c * H + r;
  uint4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const uint4*>(src + (long long)k * W);
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<uint4*>(dst + H) = make_uint4(v[0].y, v[1].y, v[2].y, v[3].y);
  *reinterpret_cast<uint4*>(dst + 2 * H) = make_uint4(v[0].z, v[1].z, v[2].z, v[3].z);
  *reinterpret_cast<uint4*>(dst + 3 * H) = make_uint4(v[0].w, v[1].w, v[2].w, v[3].w);
}
}  // namespace

// one-warp blocks while that leaves a block for each of 132 SMs, else up to 8 warps
extern "C" int transpose_registers(const uint32_t* x, int H, int W, uint32_t* out,
                                   cudaStream_t stream) {
  if (H % 4 || W % 4) return int(cudaErrorInvalidValue);
  const int gx = (W + 4 * TQ_X - 1) / (4 * TQ_X), warp_rows = (H + 4 * TQ_Y - 1) / (4 * TQ_Y);
  int warps = 1;
  while (warps < 8 && gx * warp_rows / (2 * warps) >= 132) warps *= 2;
  const int gy = (warp_rows + warps - 1) / warps;
  transpose_registers_kernel<<<gx * gy, 32 * warps, 0, stream>>>(x, H, W, gx, out);
  return cudaGetLastError();
}
"""

# edits of csrc/probes.cu: the transpose kernel's, and the short loop's
# launch (its text occurs once for each step count)
_KERNEL_HEAD = ("  const int t = threadIdx.x, c0 = blockIdx.x * T_COLS, r0 = blockIdx.y * TR;\n"
                "  uint4 v[N];\n")
_KERNEL_TAIL = "        if (ocol + e < H) dst[e] = tile[4 * p + e][c];\n    }\n  }\n}\n"
_SHORT_GRID = "const int grid = blocks(n / 4 + n % 4);"
_SHORT_LAUNCH = "<<<grid, THREADS, 0, stream>>>(x, out, n, a, b); break;"
SHORT_BLOCKS = (128, 64)   # the short kernel's other block sizes
PATCHES = {
    "band loop": [
        (_KERNEL_HEAD,
         "  const int t = threadIdx.x, c0 = blockIdx.x * T_COLS, n_bands = (H + TR - 1) / TR;\n"
         "  for (int band = blockIdx.y; band < n_bands; band += gridDim.y) {\n"
         "  const int r0 = band * TR;\n"
         "  if (band != blockIdx.y) __syncthreads();  // the last band's tile is read\n"
         "  uint4 v[N];\n"),
        (_KERNEL_TAIL, _KERNEL_TAIL[:-2] + "  }\n}\n")],
    "int pitch": [
        ("long long ld,\n                     uint32_t* __restrict__ out)",
         "int ld,\n                     uint32_t* __restrict__ out)"),
        ("x + row * ld + col;", "x + (long long)row * ld + col;")],
    **{f"short {b}": [
        (_SHORT_GRID, f"const int grid = (n / 4 + n % 4 + {b} - 1) / {b};"),
        (_SHORT_LAUNCH, f"<<<grid, {b}, 0, stream>>>(x, out, n, a, b); break;")]
       for b in SHORT_BLOCKS},
}
# row_scan's alternatives: its rows a block set to other values
_SCAN = f"constexpr int SCAN_WARPS = {K.SCAN_WARPS};"
SCAN_DESIGNS = {"row_scan one block a row": 1, "row_scan 2 rows a block": 2,
                "row_scan 8 rows a block": 8}
PATCHES.update({name: [(_SCAN, f"constexpr int SCAN_WARPS = {w};")]
                for name, w in SCAN_DESIGNS.items() if w != K.SCAN_WARPS})

# tea8's alternatives, E pairs a thread with their chains interleaved (E * 4
# consecutive bytes in one access where n is a multiple of E and every array
# E * 4-byte aligned, word by word otherwise) in blocks of any size, and the
# chains on one warp alone: E pairs' TEA rounds, the shipped row scan
DESIGNS_CU = r"""
#include "probes.cu"

namespace {
constexpr uint32_t TEA_DELTA = 0x9E3779B9u;

// one round of E interleaved pairs, s the round's sum of TEA_DELTA
template <int E>
__device__ __forceinline__ void tea_round(uint32_t (&v0)[E], uint32_t (&v1)[E], uint32_t s) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    v0[e] += ((v1[e] << 4) + 0xA341316Cu) ^ (v1[e] + s) ^ ((v1[e] >> 5) + 0xC8013EA4u);
#pragma unroll
  for (int e = 0; e < E; ++e)
    v1[e] += ((v0[e] << 4) + 0xAD90777Du) ^ (v0[e] + s) ^ ((v0[e] >> 5) + 0x7E95761Eu);
}

template <int E>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t (&v)[E]) {
  if constexpr (E == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (E == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int E>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p, const uint32_t (&v)[E]) {
  if constexpr (E == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int E, bool VEC>
__global__ void tea8_pairs_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ o0, uint32_t* __restrict__ o1, int n) {
  const int k = E * int(blockIdx.x * blockDim.x + threadIdx.x);
  if (k >= n) return;
  uint32_t v0[E], v1[E];
  if (VEC) {
    load_words<E>(a + k, v0);
    load_words<E>(b + k, v1);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v0[e] = k + e < n ? a[k + e] : 0u;
      v1[e] = k + e < n ? b[k + e] : 0u;
    }
  }
  uint32_t s = 0u;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    s += TEA_DELTA;
    tea_round<E>(v0, v1, s);
  }
  if (VEC) {
    store_words<E>(o0 + k, v0);
    store_words<E>(o1 + k, v1);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (k + e < n) o0[k + e] = v0[e], o1[k + e] = v1[e];
    }
  }
}

template <int E>
cudaError_t launch_pairs(int threads, cudaStream_t stream, const uint32_t* a, const uint32_t* b,
                         uint32_t* o0, uint32_t* o1, int n) {
  const uintptr_t any = uintptr_t(a) | uintptr_t(b) | uintptr_t(o0) | uintptr_t(o1);
  const int grid = int(((long long)n + E * threads - 1) / (E * threads));
  if (n % E == 0 && any % (4 * E) == 0)
    tea8_pairs_kernel<E, true><<<grid, threads, 0, stream>>>(a, b, o0, o1, n);
  else
    tea8_pairs_kernel<E, false><<<grid, threads, 0, stream>>>(a, b, o0, o1, n);
  return cudaGetLastError();
}

template <int E>
__global__ void tea_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ o0, uint32_t* __restrict__ o1,
                                 int rounds) {
  const int k = E * threadIdx.x;
  uint32_t v0[E], v1[E], s = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e) v0[e] = a[k + e], v1[e] = b[k + e];
#pragma unroll 8
  for (int r = 0; r < rounds; ++r) {
    s += TEA_DELTA;
    tea_round<E>(v0, v1, s);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) o0[k + e] = v0[e], o1[k + e] = v1[e];
}

template <int PER>
__global__ void scan_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int scans) {
  const int lane = threadIdx.x;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = x[lane * PER + i];
#pragma unroll 1
  for (int r = 0; r < scans; ++r) warp_row_scan<PER>(v, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) out[lane * PER + i] = v[i];
}
}  // namespace

// 8 TEA rounds of n pairs, `elems` pairs a thread in blocks of `threads`
extern "C" int tea8_pairs(const uint32_t* a, const uint32_t* b, uint32_t* o0, uint32_t* o1,
                          int n, int elems, int threads, cudaStream_t stream) {
  if (n < 1 || threads < 32 || threads > 1024 || threads % 32) return int(cudaErrorInvalidValue);
  switch (elems) {
    case 1: return int(launch_pairs<1>(threads, stream, a, b, o0, o1, n));
    case 2: return int(launch_pairs<2>(threads, stream, a, b, o0, o1, n));
    case 4: return int(launch_pairs<4>(threads, stream, a, b, o0, o1, n));
    default: return int(cudaErrorInvalidValue);
  }
}

// one warp: 32 x elems pairs, `rounds` rounds
extern "C" int tea_chain(const uint32_t* a, const uint32_t* b, uint32_t* o0, uint32_t* o1,
                         int elems, int rounds, cudaStream_t stream) {
  switch (elems) {
    case 1: tea_chain_kernel<1><<<1, 32, 0, stream>>>(a, b, o0, o1, rounds); break;
    case 2: tea_chain_kernel<2><<<1, 32, 0, stream>>>(a, b, o0, o1, rounds); break;
    case 4: tea_chain_kernel<4><<<1, 32, 0, stream>>>(a, b, o0, o1, rounds); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// one warp: a row of 32 x 4 values (W 128), `scans` scans
extern "C" int scan_chain(const float* x, float* out, int scans, cudaStream_t stream) {
  scan_chain_kernel<4><<<1, 32, 0, stream>>>(x, out, scans);
  return int(cudaGetLastError());
}
"""
# (pairs a thread, threads a block) of tea8's alternatives
TEA_DESIGNS = {"4 pairs a thread, one 256-thread block": (4, 256),
               "2 pairs a thread, 256-thread blocks": (2, 256),
               "4 pairs, 64-thread blocks": (4, 64), "4 pairs, one-warp blocks": (4, 32),
               "2 pairs, one-warp blocks": (2, 32), "1 pair, one-warp blocks": (1, 32)}


def patched_source(name: str) -> str:
    """csrc/probes.cu with the edits of ``PATCHES[name]``: each old text
    occurs once, or (a short-kernel launch) once for each step count."""
    src = open(K.SOURCE).read()
    for old, new in PATCHES[name]:
        count = src.count(old)
        if count != (K.SHORT_STEPS if old == _SHORT_LAUNCH else 1):
            raise ValueError(f"{name}: the edit's text is in {K.SOURCE} {count} times")
        src = src.replace(old, new)
    return src


def _build_lib(name: str, source: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    stem = re.sub(r"[^A-Za-z0-9_.-]", "_", name)   # nvcc's fatbinary refuses a "," in a path
    path = os.path.join(OUT_DIR, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(source)
    return _build.build(path, f"variant_{stem}")


def _transposes(ctx: Context, card: str, rounds: int):
    shipped = K._lib()
    libs = {"shipped": shipped}
    for name in ("band loop", "int pitch"):
        path = _build_lib(name, patched_source(name))
        print(f"{name}: {[u for u in K.resource_usage(path) if 'transpose' in u]}", flush=True)
        libs[name] = _build.load(path, {"probe_transpose": shipped.probe_transpose.argtypes})
    path = _build_lib("registers", REGISTERS_CU)
    print(f"registers: {_build.resource_usage(path)}", flush=True)
    p = ctypes.c_void_p
    registers = _build.load(path, {"transpose_registers": [p, ctypes.c_int, ctypes.c_int, p, p]})

    def run_registers(t):
        out = torch.empty(t.shape[1], t.shape[0], dtype=t.dtype, device=t.device)
        err = registers.transpose_registers(t.data_ptr(), t.shape[0], t.shape[1], out.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"transpose_registers launch failed: CUDA error {err}")
        return out

    def run_lib(lib, t):
        K._LIB = lib
        return K.index_copy(t, "transpose")

    try:
        for h, w in SHAPES:
            n_rounds = rounds if h * w < 2 ** 24 else 21
            t = torch.rand(h, w, device="cuda")
            fns = {name: (lambda lib=lib: run_lib(lib, t)) for name, lib in libs.items()}
            fns["registers"] = lambda: run_registers(t)
            fns[".t().contiguous()"] = lambda: t.t().contiguous()
            for name, fn in fns.items():
                if not torch.equal(fn(), t.t()):
                    raise AssertionError(f"{name} disagrees with t.t() at {(h, w)}")
            turns = interleaved_ms(ctx, fns, n_rounds)
            bound = 2 * t.numel() * 4 / PEAK_BYTES_S * 1e3
            print(f"transpose ({h}, {w}) f32, {n_rounds} rounds in turns, ms median (p10, p90): "
                  + _spread(turns) + f"; bound {bound!r} ms by bytes [{card}]", flush=True)
            del t
    finally:
        K._LIB = shipped


def _short_loop(ctx: Context, card: str, rounds: int):
    shipped = K._lib()
    argtypes = shipped.probe_affine_loop.argtypes
    libs = {"short 256 (shipped)": shipped}
    for b in SHORT_BLOCKS:
        name = f"short {b}"
        path = _build_lib(name, patched_source(name))
        libs[name] = _build.load(path, {"probe_affine_loop": argtypes})
    x = torch.full((8, 128), 3.0, device="cuda")

    def step(lib, short):   # the wrapper's launch, the path chosen here
        out = torch.empty_like(x)
        err = lib.probe_affine_loop(x.data_ptr(), out.data_ptr(), x.numel(), 1, None, 2.0, 0.0,
                                    short, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe_affine_loop launch failed: CUDA error {err}")
        return out

    fns = {name: (lambda lib=lib: step(lib, 1)) for name, lib in libs.items()}
    fns["loop kernel"] = lambda: step(shipped, 0)
    fns["x * 2"] = lambda: x * 2.0
    for name, fn in fns.items():
        if not torch.equal(fn(), x * 2.0):
            raise AssertionError(f"{name} disagrees with x * 2")
    for run in range(3):
        turns = interleaved_ms(ctx, fns, rounds)
        print(f"P0 x * 2 (8, 128) f32, run {run + 1}, {rounds} rounds in turns, ms median "
              f"(p10, p90): " + _spread(turns) + f" [{card}]", flush=True)


def _parent_probes(parent: str):
    """The probes module of the checkout at ``parent``, imported as
    ``volren_parent``: its own kernels, built into its own build/."""
    pkg = os.path.join(os.path.abspath(parent), "volren_tpu_torch")
    spec = importlib.util.spec_from_file_location("volren_parent", os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    sys.modules["volren_parent"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["volren_parent"])
    P = importlib.import_module("volren_parent.ops.kernels.probes")
    if not P.SOURCE.startswith(pkg):
        raise RuntimeError(f"volren_parent imported {P.SOURCE}, not {pkg}")
    return P


def _sass(lib_path: str, match: str, out_dir: str):
    """The SASS of the library's kernels whose name holds ``match``, written
    to ``out_dir``; prints each one's instructions by opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    for block in text.split("Function : ")[1:]:
        name = K._kernel_name(block.split()[0])
        if match not in name:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,6})\*/\s+([^;]*);", block)
        stem = re.sub(r"[^A-Za-z0-9_]", "_", name)
        with open(os.path.join(out_dir, f"sass_{stem}.txt"), "w") as f:
            f.write("\n".join(f"{a} {i.strip()}" for a, i in ins) + "\n")
        ops: dict = {}
        for _a, i in ins:
            op = i.split()[0] if not i.startswith("@") else i.split()[1]
            ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        print(f"SASS {name}: {len(ins)} instructions {dict(sorted(ops.items()))}", flush=True)


def _with_lib(lib, fn):
    def run():
        saved = K._LIB
        K._LIB = lib
        try:
            return fn()
        finally:
            K._LIB = saved
    return run


def _one_warp_ms(ctx: Context, run, lo: int = 64, hi: int = 512) -> float:
    """ms of one more repetition of ``run(n)``'s chain: the median of 5
    marginals between ``lo`` and ``hi`` repetitions, which cancel the launch."""
    return float(np.median([marginal(ctx, run, lo, hi, reps=20)[2] for _ in range(5)]))


def _tea8_scan(ctx: Context, card: str, rounds: int, runs: int, parts, parent: str | None,
               sass_dir: str | None):
    shipped = K._lib()
    P = _parent_probes(parent) if parent else None
    p, n = ctypes.c_void_p, ctypes.c_int
    designs_path = _build_lib("designs", DESIGNS_CU)
    designs = _build.load(designs_path, {"tea8_pairs": [p, p, p, p, n, n, n, p],
                                         "tea_chain": [p, p, p, p, n, n, p],
                                         "scan_chain": [p, p, n, p]})
    print("shipped ptxas", [u for u in K.resource_usage(K.build()) if "registers" in u and
                            u.startswith(("tea8", "row_scan"))], flush=True)
    print("alternatives' ptxas", [u for u in _build.resource_usage(designs_path, K._kernel_name)
                                  if "registers" in u and u.startswith("tea8_pairs")], flush=True)
    if P is not None:
        print("parent ptxas", [u for u in P.resource_usage(P.build()) if "registers" in u and
                               u.startswith(("tea8", "row_scan"))], flush=True)
    if sass_dir:
        _sass(K.build(), "tea8", sass_dir)
        _sass(K.build(), "row_scan<4,", sass_dir)
        _sass(designs_path, "tea8_pairs<4,1>", sass_dir)
    rng = np.random.default_rng(9)
    a, b = (K.u32_bits(ctx.t(rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)))
            for _ in range(2))
    x = ctx.t(np.random.default_rng(0).random((8, 128), np.float32))
    p0_x = ctx.t(np.full((8, 128), 1.0, np.float32))
    p0 = lambda: K.affine_loop(p0_x, 1, 2.0, 0.0)   # P0's x * 2, the short kernel
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")

    def pairs(elems, threads):   # an alternative, as the wrapper calls the shipped kernel
        def run():
            o0, o1 = torch.empty_like(a), torch.empty_like(b)
            check(designs.tea8_pairs(a.data_ptr(), b.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                                     a.numel(), elems, threads, stream()), "tea8_pairs")
            return o0, o1
        return run

    def tea_chain(elems):
        o0, o1 = (torch.empty(32 * elems, dtype=torch.int32, device=a.device) for _ in range(2))
        return lambda r: check(designs.tea_chain(a.data_ptr(), b.data_ptr(), o0.data_ptr(),
                                                 o1.data_ptr(), elems, r, stream()), "tea_chain")

    def scan_chain(r):
        out = torch.empty(128, device=x.device)
        check(designs.scan_chain(x.data_ptr(), out.data_ptr(), r, stream()), "scan_chain")

    cases = []
    if "tea8" in parts:
        # the chain kernel's round is the alternatives': 8 of them are tea8's
        for e in (1, 2, 4):
            o0, o1 = (torch.empty(32 * e, dtype=torch.int32, device=a.device) for _ in range(2))
            check(designs.tea_chain(a.data_ptr(), b.data_ptr(), o0.data_ptr(), o1.data_ptr(), e,
                                    8, stream()), "tea_chain")
            want = K.tea8_plain(a[0, :32 * e], b[0, :32 * e])
            if not (torch.equal(o0, want[0]) and torch.equal(o1, want[1])):
                raise AssertionError(f"the chain kernel's 8 rounds of {e} pairs disagree")
        fns = {"shipped": lambda: K.tea8(a, b),
               **{name: pairs(*et) for name, et in TEA_DESIGNS.items()}}
        if P is not None:
            fns["parent"] = lambda: P.tea8(a, b)
        want = K.tea8_plain(a, b)
        for name, fn in fns.items():
            if not all(torch.equal(g, w) for g, w in zip(fn(), want)):
                raise AssertionError(f"{name} disagrees with tea8_plain")
        fns["P0"] = p0
        cases.append(("tea8 Q5 (8, 128) u32 pairs", fns,
                      lambda: 8 * _one_warp_ms(ctx, tea_chain(1)),
                      lambda: {f"{e} pair(s) a thread": _one_warp_ms(ctx, tea_chain(e)) * 1e6
                               for e in (1, 2, 4)}))
    if "row_scan" in parts:
        fns = {"shipped": lambda: K.row_scan(x)}
        for name in PATCHES:
            if name.startswith("row_scan"):
                path = _build_lib(name, patched_source(name))
                print(name, [u for u in K.resource_usage(path) if "registers" in u and
                             u.startswith("row_scan")], flush=True)
                lib = _build.load(path, {"probe_row_scan": shipped.probe_row_scan.argtypes})
                fns[name] = _with_lib(lib, lambda: K.row_scan(x))
        if P is not None:
            fns["parent"] = lambda: P.row_scan(x)
        want = K.row_scan_plain(x)
        for name, fn in fns.items():
            if not torch.allclose(fn(), want, rtol=1e-5, atol=0.0):
                raise AssertionError(f"{name} disagrees with row_scan_plain beyond rtol 1e-5")
        fns["torch.cumsum"] = lambda: torch.cumsum(x, dim=1)
        fns["P0"] = p0
        cases.append(("row_scan cumsum (8, 128) f32", fns, lambda: _one_warp_ms(ctx, scan_chain),
                      lambda: {}))
    for run in range(1, runs + 1):
        for label, fns, chain_ms, per_step in cases:
            turns = interleaved_ms(ctx, fns, rounds)
            ms = chain_ms()
            p0_ms = turns["P0"]["median"]
            steps = per_step()
            print(f"{label}, run {run}, {rounds} rounds in turns, ms median (p10, p90): "
                  + _spread(turns) + f"; the shipped kernel's chain on one warp alone {ms!r} ms"
                  + (f" (ns a round: {steps})" if steps else "")
                  + f", floor P0 + chain = {p0_ms + ms!r} ms [{card}]", flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"SM clock now, max: {clock} [{card}]", flush=True)


def _spread(turns: dict) -> str:
    return ", ".join(f"{k} {v['median']!r} ({v['p10']!r}, {v['p90']!r})"
                     for k, v in turns.items())


PARTS = ("transpose", "short", "tea8", "row_scan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=101,
                    help="rounds in turns at W4's shapes, for P0, tea8 and row_scan")
    ap.add_argument("--runs", type=int, default=5, help="runs of tea8's and row_scan's turns")
    ap.add_argument("--only", default=",".join(PARTS), help=f"parts, of {','.join(PARTS)}")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit, for tea8's and row_scan's turns")
    ap.add_argument("--sass", default=None, help="write tea8's and row_scan's SASS here")
    args = ap.parse_args(argv)
    parts = args.only.split(",")
    if not set(parts) <= set(PARTS):
        raise ValueError(f"--only takes {PARTS}")
    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on a CUDA card")
    ctx, card = Context(torch.device("cuda")), card_line()
    if "transpose" in parts:
        _transposes(ctx, card, args.rounds)
    if "short" in parts:
        _short_loop(ctx, card, args.rounds)
    if "tea8" in parts or "row_scan" in parts:
        _tea8_scan(ctx, card, args.rounds, args.runs, parts, args.parent, args.sass)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
