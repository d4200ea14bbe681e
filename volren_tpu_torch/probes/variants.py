"""The design alternatives of two probe kernels, timed in turns on the card.

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

One line per shape or run: the median and p10-p90 of each, in ms, and the
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

import torch

from ..measure import PEAK_BYTES_S
from ..ops.kernels import build as _build
from ..ops.kernels import probes as K
from ._common import Context, card_line, interleaved_ms

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


def _spread(turns: dict) -> str:
    return ", ".join(f"{k} {v['median']!r} ({v['p10']!r}, {v['p90']!r})"
                     for k, v in turns.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=101,
                    help="rounds in turns at W4's shapes and for P0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on a CUDA card")
    ctx, card = Context(torch.device("cuda")), card_line()
    _transposes(ctx, card, args.rounds)
    _short_loop(ctx, card, args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
