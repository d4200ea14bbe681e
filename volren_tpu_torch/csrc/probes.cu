// Microbenchmark kernels for NVIDIA Hopper (sm_90a): the H100 counterparts
// of the Pallas probes (probes/probe_pallas{,2,3,4,5}.py,
// probes/probe_dmagather{,2,3,4}.py) and of the `_scan_gather` test
// harness (tests/test_pallas.py:55, volren_tpu/ops/pallas/kernel.py:396).
//
// Each probe asked the TPU one question about the render megakernel's
// building blocks: the cost of an in-kernel loop step, of a gather against
// the table's size, of a row gather staged in fast memory against a direct
// word load, of 30 values carried through a loop. Here each is asked of the
// card. The TPU mechanisms (one-hot MXU products, mask-reduce passes, SMEM
// scalarisation, DMA semaphores) are not carried over: on this card a gather
// is a load. Eight families cover the 28 Pallas call sites:
//
//   affine_loop        P0, P1, P2 (trip count read on the device), P4
//   gather             P3a-d, Q1, Q2, Q4, W3, the _scan_gather harness
//   lcg_gather_sum     W1, W2, W5/W7, W6, X1, X2, V1-V5/V8
//   carry_loop         X3 (30 carried values), Q6 (the march-like body)
//   row_gather_rounds  dmagather 1-4 (staged rows vs direct words)
//   index_copy         Q3, W4 (the transpose: 16-byte segments through a shared tile)
//   tea8               Q5
//   row_scan           probe_pallas5's cumsum
//
// Every family's plain torch version is in
// volren_tpu_torch/ops/kernels/probes.py. The file is built with
// -fmad=false, so float arithmetic rounds as the plain version's separate
// operations do; where the JAX reference computes a fused multiply-add
// (XLA fuses x*a + b, and a*c1 + p*c2 on its first product), the kernel
// asks for one with __fmaf_rn and the plain version emulates it exactly.
// A gather moves 32-bit words, so one kernel serves f32 and i32 tables.
//
// What bounds them: two families are dependent chains by construction,
// and their time per step is the answer: affine_loop (each step reads the
// last) and march (the cell a step reads comes from pos[0]). carry30's 30
// values are a chain within a step but not from step to step, so its steps
// run as a pipeline and it is bound by issue. row_gather_rounds
// waits for a round's copies to land and be picked before the next round
// copies into the same rows, so it is latency-bound by the probe's rule,
// not by its data. lcg_gather_sum's loads do not depend on each other (each
// index comes from the LCG alone); only its sum is a chain, kept in order,
// so it is bound by issue and by the loads it keeps in flight. Their bound
// by bytes or operations is far below their time.
// Each C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t lcg(uint32_t s) { return s * 1664525u + 1013904223u; }

// Python's a % m for m > 0 (non-negative result)
__device__ __forceinline__ int pymod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

int blocks(long long n) { return int((n + THREADS - 1) / THREADS); }

// ---- affine_loop: out = x after `iters` steps of v = fma(v, a, b)
//
// The loop kernel keeps P1, P2 and P4's question (probes/probe_pallas.py
// :133, :178, :341): one element a thread, one dependent chain of `iters`
// steps, the count from the host or read on the device. Their time per step
// is the answer; a thread never carries two chains.
__global__ void affine_loop_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                   int iters, const int* __restrict__ iters_dev, float a,
                                   float b) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int m = iters_dev ? *iters_dev : iters;
  float v = x[i];
  for (int k = 0; k < m; ++k) v = __fmaf_rn(v, a, b);
  out[i] = v;
}

// The short loop, P0 (probes/probe_pallas.py:105, x * 2.0 on an (8, 128)
// f32 block): at most SHORT_STEPS steps, the count a template argument. A
// 4 KiB call is bound by its launch and one round trip to memory (the bytes,
// 8 KiB at 3.35 TB/s, take 2.4 ns), so the kernel issues as few memory
// instructions as it can: 4 elements a thread in one 16-byte load and one
// 16-byte store (x and out 16-byte aligned: the wrapper checks), the n % 4
// elements past the last whole quad one a thread, and no read of a trip
// count. The grid has one thread for each quad and for each tail element,
// in 256-thread blocks: one block at P0's shape, no slower than 128- or
// 64-thread blocks or than the loop kernel's 4 blocks of one element a
// thread (python -m volren_tpu_torch.probes.variants). At the launch floor
// the difference is a few ns either way.
constexpr int SHORT_STEPS = 4;

template <int STEPS>
__global__ void affine_short_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                    float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, n4 = n >> 2;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      v.x = __fmaf_rn(v.x, a, b);
      v.y = __fmaf_rn(v.y, a, b);
      v.z = __fmaf_rn(v.z, a, b);
      v.w = __fmaf_rn(v.w, a, b);
    }
    reinterpret_cast<float4*>(out)[i] = v;
  } else if (int e = 4 * n4 + (i - n4); e < n) {
    float v = x[e];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) v = __fmaf_rn(v, a, b);
    out[e] = v;
  }
}

// ---- gather: out_t[i, j] = T_t[r, c] over an (H, W) output, for up to
// GATHER_TABLES tables of one shape in one launch (the _scan_gather harness
// gathers an f32 and an i32 table with the same (r, c)). r is i (R_ROW),
// r_idx[i, j] (R_IDX) or r_idx[i, 0] (R_IDX_ROW), taken modulo `mod` with
// Python's sign rule: a mask where mod is a power of two (MOD_MASK), else
// pymod (MOD_PY); c is 0 (C_ZERO: a 1-D table), j (C_COL) or c_idx[i, j]
// (C_IDX). An index array's rows lie r_ld / c_ld words apart.
//
// What bounds it: at the sites' (8, 128) outputs a launch and one
// dependent round trip to L2 (the index, then the word; the bytes take 2-10
// ns); at Q1's (16384, 128), L2 sectors: a warp reads 32 rows at random, so
// each 4-byte word costs a 32-byte sector (67 MB for Q1's 8 MB table). So
// the modes, the modulo's kind and N, the words a thread, are template
// arguments (no run-time branch), the block is 2-D (a row's threads along
// x, a warp at W = 128, rows along y, up to 256 threads), so no thread
// divides, and one launch serves several tables. With N = 4 a thread owns 4
// consecutive words of an output row, reads each index array with one
// 16-byte load, issues its 4 table loads before it stores, and writes each
// output with one 16-byte store. The wrapper (ops/kernels/probes.py:
// gather_words) takes N = 4 only where a thread's words lie in one table
// row picked through a column index (Q2, 15% faster than one word a
// thread); where each word's row comes from an index array, and for P3d's
// row fetch, one word a thread in 256-thread blocks is as fast or faster
// (PERF.md). The grid's x axis walks row bands, its y axis column
// blocks (a loop covers more than 65535 of them). N = 4 needs W and the
// index arrays' pitches multiples of 4 and their pointers 16-byte aligned
// (the outputs are fresh allocations).
constexpr int GATHER_TABLES = 4;
constexpr int R_ROW = 0, R_IDX = 1, R_IDX_ROW = 2;
constexpr int C_ZERO = 0, C_COL = 1, C_IDX = 2;
constexpr int MOD_NONE = 0, MOD_MASK = 1, MOD_PY = 2;

struct GatherArgs {
  const uint32_t* T[GATHER_TABLES];
  uint32_t* out[GATHER_TABLES];
  int n_tables, C, H, W;
  const int* r_idx;
  const int* c_idx;
  long long r_ld, c_ld;
  int mod;
};

template <int N>
__device__ __forceinline__ void load_words(const int* p, int (&v)[N]) {
  if constexpr (N == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int R_MODE, int C_MODE, int MOD, int N>
__global__ void gather_kernel(const GatherArgs g) {
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= g.H) return;
  const int per_row = g.W / N;  // N = 4: W % 4 == 0
  for (int q = blockIdx.y * blockDim.x + threadIdx.x; q < per_row; q += gridDim.y * blockDim.x) {
    const int j = N * q;
    int r[N], c[N];
    if (R_MODE == R_IDX) {
      load_words<N>(g.r_idx + i * g.r_ld + j, r);
    } else {
      const int r0 = R_MODE == R_ROW ? i : g.r_idx[i * g.r_ld];
#pragma unroll
      for (int e = 0; e < N; ++e) r[e] = r0;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (MOD == MOD_MASK) r[e] &= g.mod - 1;
      if (MOD == MOD_PY) r[e] = pymod(r[e], g.mod);
    }
    if (C_MODE == C_IDX) {
      load_words<N>(g.c_idx + i * g.c_ld + j, c);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) c[e] = C_MODE == C_COL ? j + e : 0;
    }
    uint32_t v[GATHER_TABLES][N];
#pragma unroll
    for (int t = 0; t < GATHER_TABLES; ++t) {
      if (t >= g.n_tables) break;
#pragma unroll
      for (int e = 0; e < N; ++e) v[t][e] = g.T[t][(long long)r[e] * g.C + c[e]];
    }
#pragma unroll
    for (int t = 0; t < GATHER_TABLES; ++t) {
      if (t >= g.n_tables) break;
      uint32_t* o = g.out[t] + i * g.W + j;
      if constexpr (N == 4)
        *reinterpret_cast<uint4*>(o) = make_uint4(v[t][0], v[t][1], v[t][2], v[t][3]);
      else
        *o = v[t][0];
    }
  }
}

template <int R_MODE, int C_MODE, int MOD>
cudaError_t launch_gather(const GatherArgs& g, int words, dim3 grid, dim3 block,
                          cudaStream_t stream) {
  if (words == 4)
    gather_kernel<R_MODE, C_MODE, MOD, 4><<<grid, block, 0, stream>>>(g);
  else if (words == 1)
    gather_kernel<R_MODE, C_MODE, MOD, 1><<<grid, block, 0, stream>>>(g);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// the (r_mode, c_mode) pairs the wrapper asks for: a 1-D table (R_IDX,
// C_ZERO); a 2-D table with a column index (any r_mode) or with rows only
template <int MOD>
cudaError_t launch_gather_modes(const GatherArgs& g, int r_mode, int c_mode, int words,
                                dim3 grid, dim3 block, cudaStream_t stream) {
  switch (r_mode * 3 + c_mode) {
    case R_IDX * 3 + C_ZERO: return launch_gather<R_IDX, C_ZERO, MOD>(g, words, grid, block, stream);
    case R_IDX * 3 + C_COL: return launch_gather<R_IDX, C_COL, MOD>(g, words, grid, block, stream);
    case R_IDX_ROW * 3 + C_COL:
      return launch_gather<R_IDX_ROW, C_COL, MOD>(g, words, grid, block, stream);
    case R_ROW * 3 + C_IDX: return launch_gather<R_ROW, C_IDX, MOD>(g, words, grid, block, stream);
    case R_IDX * 3 + C_IDX: return launch_gather<R_IDX, C_IDX, MOD>(g, words, grid, block, stream);
    case R_IDX_ROW * 3 + C_IDX:
      return launch_gather<R_IDX_ROW, C_IDX, MOD>(g, words, grid, block, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- lcg_gather_sum: per lane (i, j) of an (H, W) block, seed
// s = seed + i * row_mul + j; `iters` times: advance the LCG and add one
// table word (as f32) to the lane's accumulator. LCG_ROW: T[i, (s >> 8) %
// C]; LCG_RC: r = (s >> 8) % R, advance, c = (s >> 8) % C, T[r, c];
// LCG_FLAT: T.flat[((s >> 8) & 0x7FFFFF) % (R * C)].
//
// What bounds it: issue and latency, not bytes. The loads do not depend on
// each other, only the sum does, so a lane computes its next LCG_UNROLL
// indices (a cheap integer chain), issues their loads together and then
// adds the words in their original order with __fadd_rn: bitwise the
// plain version's one-at-a-time sum, with LCG_UNROLL loads in flight. Each
// modulo by C, R or R * C is an exact division by a multiply-high with a
// magic number and shift from the wrapper (ops/kernels/probes.py: div_plan;
// the numerators are below 2^24): a few instructions, where a runtime `%`
// is a software division sequence. The wrapper picks the block size
// (lcg_threads): 256 threads where that still gives every SM a block, one
// warp below that, so that 1,024 lanes spread over 32 SMs.
constexpr int LCG_ROW = 0, LCG_RC = 1, LCG_FLAT = 2;
constexpr int LCG_UNROLL = 16;

// x % d for 0 <= x < 2^24: q = x / d = umulhi(x << 8, m) >> sh
struct Divisor {
  uint32_t d, m, sh;
};

__device__ __forceinline__ uint32_t mod24(uint32_t x, Divisor v) {
  return x - v.d * (__umulhi(x << 8, v.m) >> v.sh);
}

// one step of a lane's walk: advance s, return the flat index of its word
template <int MODE>
__device__ __forceinline__ int lcg_index(uint32_t& s, int row0, int C, Divisor dc, Divisor dr) {
  s = lcg(s);
  if (MODE == LCG_ROW) return row0 + int(mod24(s >> 8, dc));
  if (MODE == LCG_FLAT) return int(mod24((s >> 8) & 0x7FFFFFu, dc));
  const int r = int(mod24(s >> 8, dr));
  s = lcg(s);
  return r * C + int(mod24(s >> 8, dc));
}

template <bool IS_INT>
__device__ __forceinline__ float word_value(uint32_t w) {
  return IS_INT ? __int2float_rn(int(w)) : __uint_as_float(w);
}

// dc divides by C (LCG_ROW, LCG_RC) or R * C (LCG_FLAT), dr by R (LCG_RC)
template <bool IS_INT, int MODE>
__global__ void lcg_gather_sum_kernel(const uint32_t* __restrict__ T, int C, Divisor dc,
                                      Divisor dr, uint32_t seed, uint32_t row_mul, int H, int W,
                                      int iters, float* __restrict__ acc_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H * W) return;
  const int i = k / W, j = k % W, row0 = i * C;
  uint32_t s = seed + uint32_t(i) * row_mul + uint32_t(j);
  float acc = 0.0f;
  int it = 0;
  for (; it + LCG_UNROLL <= iters; it += LCG_UNROLL) {
    uint32_t w[LCG_UNROLL];
#pragma unroll
    for (int u = 0; u < LCG_UNROLL; ++u) w[u] = T[lcg_index<MODE>(s, row0, C, dc, dr)];
#pragma unroll
    for (int u = 0; u < LCG_UNROLL; ++u) acc = __fadd_rn(acc, word_value<IS_INT>(w[u]));
  }
  for (; it < iters; ++it)
    acc = __fadd_rn(acc, word_value<IS_INT>(T[lcg_index<MODE>(s, row0, C, dc, dr)]));
  acc_out[k] = acc;
}

template <bool IS_INT>
cudaError_t launch_lcg(int mode, const uint32_t* T, int C, Divisor dc, Divisor dr, uint32_t seed,
                       uint32_t row_mul, int H, int W, int iters, int threads, float* acc,
                       cudaStream_t stream) {
  const int grid = int(((long long)H * W + threads - 1) / threads);
  switch (mode) {
    case LCG_ROW:
      lcg_gather_sum_kernel<IS_INT, LCG_ROW><<<grid, threads, 0, stream>>>(
          T, C, dc, dr, seed, row_mul, H, W, iters, acc);
      break;
    case LCG_RC:
      lcg_gather_sum_kernel<IS_INT, LCG_RC><<<grid, threads, 0, stream>>>(
          T, C, dc, dr, seed, row_mul, H, W, iters, acc);
      break;
    case LCG_FLAT:
      lcg_gather_sum_kernel<IS_INT, LCG_FLAT><<<grid, threads, 0, stream>>>(
          T, C, dc, dr, seed, row_mul, H, W, iters, acc);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- carry_loop, X3: 30 values carried per lane through `iters` steps;
// each step gathers one word of T (R, C) at an LCG (r, c) and chains it
// through the 30: a = fma(a, c_keep, prev * c_mix); prev = a. Writes the
// lane's sum of the 30, added in order.
//
// What bounds it: issue. A step's word comes from the LCG alone, not from
// the chain, and a[m] of step t + 1 needs only a[m] of step t and a[m - 1]
// of step t + 1: the longest path through `iters` steps is about iters + 2
// x 29 operations, not 60 iters. So the steps run as a pipeline:
//  - a lane's 30 values are split over CARRY_PARTS = 8 threads of a warp,
//    part q holding a[4q .. 4q + 3] (the last part 2), so 8 x as many warps
//    issue the links (X3's 1,024 lanes: 256 one-warp blocks);
//  - the parts form a systolic pipeline over blocks of CARRY_U = 16 steps:
//    in round b part q runs block b - q, in step order, as straight-line
//    code whose links ptxas interleaves across the block's steps (a
//    wavefront), and hands each step's last value (its `prev` for part
//    q + 1) on by shuffle;
//  - part 0's 16 words are loaded a round ahead of their links;
//  - the iters % 16 steps past the whole blocks run through the same
//    pipeline as blocks of one step, so the main loop has no branch for a
//    ragged last block.
// Every link is the same IEEE operation on the same operands as in step
// order, so the result is bitwise; the sum gathers the parts' values by
// shuffle and adds them in order. `% R` and `% C` are exact multiply-high
// divisions (mod24: the numerators s >> 8 are below 2^24); the lane's
// column k % W, once a thread outside the loop, stays a `%`. 8 parts and
// 16-step blocks measured fastest against one thread a lane, 2, 4 and 16
// parts, and 8 and 32 steps (PERF.md).
constexpr int N_CARRY = 30;
constexpr int CARRY_U = 16;
constexpr int CARRY_PARTS = 8;
constexpr int CARRY_M = (N_CARRY + CARRY_PARTS - 1) / CARRY_PARTS;  // values of a part

__device__ __forceinline__ int carry_index(uint32_t& s, int C, Divisor dr, Divisor dc) {
  s = lcg(s);
  const int r = int(mod24(s >> 8, dr));
  s = lcg(s);
  return r * C + int(mod24(s >> 8, dc));
}

__device__ __forceinline__ void carry_link(float& a, float& prev, float keep, float mix) {
  a = __fmaf_rn(a, keep, __fmul_rn(prev, mix));
  prev = a;
}

// `blocks` blocks of U steps through part q's values (a[0..] is a[m0..]):
// round b runs block b - q in step order, its prevs from part q - 1's last
// round; part 0's words are loaded a round ahead; s is the lane's LCG
template <int U>
__device__ __forceinline__ void carry_pipeline(float (&a)[CARRY_M], uint32_t& s,
                                               const float* __restrict__ T, int C, Divisor dr,
                                               Divisor dc, int blocks, int q, int m0, int lane,
                                               float keep, float mix) {
  float w[U], from_prev[U];
#pragma unroll
  for (int u = 0; u < U; ++u) from_prev[u] = 0.0f;
  if (blocks > 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = T[carry_index(s, C, dr, dc)];
  }
  for (int b = 0; b < blocks + CARRY_PARTS - 1; ++b) {
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] = q == 0 ? w[u] : from_prev[u];
    if (b + 1 < blocks) {  // the next block's words in flight
#pragma unroll
      for (int u = 0; u < U; ++u) w[u] = T[carry_index(s, C, dr, dc)];
    }
    if (b - q >= 0 && b - q < blocks) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int m = 0; m < CARRY_M; ++m)
          if (m0 + m < N_CARRY) carry_link(a[m], p[u], keep, mix);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)  // part q - 1's prevs, for the next round
      from_prev[u] = __shfl_sync(0xFFFFFFFFu, p[u], (lane + 31) & 31);
  }
}

// CARRY_PARTS threads a lane, whole warps; dr divides by R, dc by C
__global__ void carry30_kernel(const float* __restrict__ T, int C, Divisor dr, Divisor dc,
                               uint32_t seed, int iters, int n_lanes, int W, float keep,
                               float mix, float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x, lane = threadIdx.x & 31;
  const int k = g / CARRY_PARTS, q = g % CARRY_PARTS, m0 = q * CARRY_M;
  // every thread of a warp takes part in the shuffles: one past the last
  // lane walks lane 0's steps and writes nothing
  uint32_t s = seed + uint32_t((k < n_lanes ? k : 0) % W);
  float a[CARRY_M];
#pragma unroll
  for (int m = 0; m < CARRY_M; ++m) a[m] = float(0.01 * (m0 + m));
  // the whole blocks, then the steps past them as blocks of one step
  carry_pipeline<CARRY_U>(a, s, T, C, dr, dc, iters / CARRY_U, q, m0, lane, keep, mix);
  carry_pipeline<1>(a, s, T, C, dr, dc, iters % CARRY_U, q, m0, lane, keep, mix);
  float acc = 0.0f;
#pragma unroll
  for (int part = 0; part < CARRY_PARTS; ++part) {
#pragma unroll
    for (int m = 0; m < CARRY_M; ++m) {
      const float v = __shfl_sync(0xFFFFFFFFu, a[m], lane - q + part);
      if (part * CARRY_M + m < N_CARRY) acc = part == 0 && m == 0 ? v : __fadd_rn(acc, v);
    }
  }
  if (q == 0 && k < n_lanes) out[k] = acc;
}

// ---- carry_loop, Q6: the march-like body on an (8, W) lane block, one
// thread per column. Per step: LCG jitter per lane; the majorant
// maj = T[cell, j] with the cell of row 0 (clip(int(pos[0] * 16), 0, R-1))
// for all 8 rows; step = (maj > 0.5 ? s_near : s_far) * (0.5 + jitter);
// pos = fma(vel, step, pos); vel *= decay. Writes pos + vel.
constexpr int Q6_ROWS = 8;

__global__ void march_kernel(const float* __restrict__ T, int R, int W,
                             const float* __restrict__ x, const uint32_t* __restrict__ s0,
                             int iters, float vel0, float s_near, float s_far, float decay,
                             float* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  float pos[Q6_ROWS], vel[Q6_ROWS];
  uint32_t rs[Q6_ROWS];
#pragma unroll
  for (int i = 0; i < Q6_ROWS; ++i) {
    pos[i] = x[i * W + j];
    vel[i] = vel0;
    rs[i] = s0[i * W + j];
  }
  for (int it = 0; it < iters; ++it) {
    int cell = __float2int_rz(__fmul_rn(pos[0], 16.0f));
    cell = min(max(cell, 0), R - 1);
    float maj = T[cell * W + j];
    float base = maj > 0.5f ? s_near : s_far;
#pragma unroll
    for (int i = 0; i < Q6_ROWS; ++i) {
      rs[i] = lcg(rs[i]);
      float jitter = __fmul_rn(__uint2float_rn(rs[i] >> 9), 1.0f / 8388608.0f);
      float step = __fmul_rn(base, __fadd_rn(0.5f, jitter));
      pos[i] = __fmaf_rn(vel[i], step, pos[i]);
      vel[i] = __fmul_rn(vel[i], decay);
    }
  }
#pragma unroll
  for (int i = 0; i < Q6_ROWS; ++i) out[i * W + j] = __fadd_rn(pos[i], vel[i]);
}

// ---- row_gather_rounds: one block of 128 lanes; per round k, lane j's
// row is ids = (base[j] + 7919 k) % rows (or & 0xFFFF); lanes j < n add
// tab[ids, ids & 127] to a wrapping u32 checksum. MODE_IDS adds ids (no
// load); MODE_DIRECT loads the word; MODE_STAGE copies the n demanded
// 512-byte rows into shared memory and adds ids; MODE_STAGED copies them and
// picks each lane's word from shared memory; MODE_STALE picks from the
// zero-filled landing buffer without copying.
//
// The staged modes keep the probe's question (probes/probe_dmagather*.py:
// one block, whole rows copied into fast memory each round, a round's
// copies landed and picked before the next round's are issued into the
// same rows) and cut what surrounds the copy. A warp instruction of 16-byte
// cp.async moves one row, and the copy's rate grows with the warps that
// issue it (H100 80GB HBM3: about 17 GB/s from one warp, 65 GB/s from
// four). So the copy schedule follows n:
//  - n > BLOCK_COPY_MAX (BY_WARP): each warp copies its own lanes' rows (a
//    row's id by shuffle), waits for its own copies and meets at
//    __syncwarp, as lane j picks only from row j: no block barrier in the
//    loop, and a warp's wait overlaps the others' copies;
//  - n <= BLOCK_COPY_MAX: the rows sit in few warps, so the whole block
//    copies them, the row ids exchanged through shared memory between
//    three block barriers a round. Nothing reads a row before its copy
//    lands, so the landing buffer is not zero-filled.
// The launch picks the instantiation, so that neither schedule pays for a
// branch on n in the loop.
constexpr int LANES = 128;
constexpr int MODE_IDS = 0, MODE_DIRECT = 1, MODE_STAGE = 2, MODE_STAGED = 3, MODE_STALE = 4;
constexpr int LAND_BYTES = LANES * LANES * 4;
constexpr int BLOCK_COPY_MAX = 64;

// no "memory" clobber: the compiler may batch the loads of row ids around
// the copies; the wait and the barriers order the copies against the picks
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned dst = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MODE, bool BY_WARP>
__global__ void __launch_bounds__(LANES)
    row_gather_rounds_kernel(const int* __restrict__ base, const uint32_t* __restrict__ tab,
                             int rows, int use_mask, int n, int rounds,
                             uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t land[];
  __shared__ int ids_s[LANES];
  const int j = threadIdx.x, w0 = j & ~31, lane = j & 31;
  uint32_t* const row = land + j * LANES;
  if (MODE == MODE_STALE) {
    for (int q = j; q < LANES * LANES; q += LANES) land[q] = 0u;
    __syncthreads();
  }
  const int b = base[j];
  uint32_t acc = 0u;
  for (int k = 0; k < rounds; ++k) {
    int v = b + 7919 * k;  // the wrapper keeps it below 2^31, as the probes' int32 did
    int ids = use_mask ? (v & 0xFFFF) : v % rows;
    if (MODE == MODE_IDS) {
      acc += uint32_t(ids);
    } else if (MODE == MODE_DIRECT) {
      if (j < n) acc += tab[(long long)ids * LANES + (ids & 127)];
    } else if (MODE == MODE_STALE) {
      acc += row[ids & 127];
    } else {
      if (BY_WARP) {
        for (int r = 0; r < 32 && w0 + r < n; ++r) {
          const int id = __shfl_sync(0xFFFFFFFFu, ids, r);
          cp_async16(&land[(w0 + r) * LANES + 4 * lane], tab + (long long)id * LANES + 4 * lane);
        }
        cp_async_wait_all();
        __syncwarp();
      } else {
        ids_s[j] = ids;
        __syncthreads();
        for (int q = j; q < n * 32; q += LANES) {  // a warp instruction copies one row
          const int r = q >> 5, part = (q & 31) * 4;
          cp_async16(&land[r * LANES + part], tab + (long long)ids_s[r] * LANES + part);
        }
        cp_async_wait_all();
        __syncthreads();
      }
      if (MODE == MODE_STAGE) {
        acc += uint32_t(ids);
      } else if (j < n) {
        acc += row[ids & 127];
      }
      if (BY_WARP)  // the next round overwrites the rows (and the block's ids)
        __syncwarp();
      else
        __syncthreads();
    }
  }
  out[j] = acc;
}

template <int MODE, bool BY_WARP = false>
cudaError_t launch_rounds(const int* base, const uint32_t* tab, int rows, int use_mask, int n,
                          int rounds, uint32_t* out, cudaStream_t stream) {
  constexpr bool COPIES = MODE == MODE_STAGE || MODE == MODE_STAGED;
  if constexpr (COPIES && !BY_WARP) {
    if (n > BLOCK_COPY_MAX)
      return launch_rounds<MODE, true>(base, tab, rows, use_mask, n, rounds, out, stream);
  }
  constexpr bool USES_LAND = COPIES || MODE == MODE_STALE;
  int smem = USES_LAND ? LAND_BYTES : 0;
  if (USES_LAND) {
    cudaError_t err = cudaFuncSetAttribute(row_gather_rounds_kernel<MODE, BY_WARP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  row_gather_rounds_kernel<MODE, BY_WARP><<<1, LANES, smem, stream>>>(base, tab, rows, use_mask,
                                                                       n, rounds, out);
  return cudaGetLastError();
}

// ---- index_copy: out (OH, OW) from x (H, W). TILE_ROWS: x[i % H, j];
// ROLL_COLS: x[i, (j - param) mod W]; BROADCAST_ROW: x[param, j];
// IOTA_PLUS: float(i) + x[0, 0] (f32). TRANSPOSE has its own kernel below.
constexpr int IC_TRANSPOSE = 0, IC_TILE_ROWS = 1, IC_ROLL_COLS = 2, IC_BROADCAST_ROW = 3,
              IC_IOTA_PLUS = 4;

__global__ void index_copy_kernel(const uint32_t* __restrict__ x, int H, int W, int mode,
                                  int param, uint32_t* __restrict__ out, int OH, int OW) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= OH * OW) return;
  int i = k / OW, j = k % OW;
  uint32_t v;
  if (mode == IC_TILE_ROWS) {
    v = x[(i % H) * W + j];
  } else if (mode == IC_ROLL_COLS) {
    v = x[i * W + pymod(j - param, W)];
  } else if (mode == IC_BROADCAST_ROW) {
    v = x[param * W + j];
  } else {
    v = __float_as_uint(__fadd_rn(__int2float_rn(i), __uint_as_float(x[0])));
  }
  out[k] = v;
}

// ---- transpose, W4 (probes/probe_pallas3.py:271, o_ref[:] = t_ref[:].T at
// (128, 1024), (1024, 128) and (8, 1024) f32) and Q3's (8, 128): out (W, H)
// = x (H, W), x's rows `ld` words apart.
//
// What bounds it: bytes, each word read once and written once, 8 H W bytes
// at 3.35 TB/s: 0.313 us at W4's 1 MiB, 0.160 ms at 8192 x 8192. Below a
// few MiB the call is bound by its launch and one round trip to memory
// instead, so the design issues few, wide memory instructions. A block of
// 64 threads moves a TR x 32-word tile through shared memory: each thread
// issues all its loads of 16-byte segments of input rows (a warp reads 4
// rows x 128 contiguous bytes) before any store, the block meets at one
// barrier, and each thread gathers 4 words of a tile column into a 16-byte
// segment of an output row (a warp writes 4 rows x 128 bytes at TR = 32,
// 16 rows x 32 bytes at TR = 8). The tile's rows are padded to 33 words, so
// a warp's 4-byte shared stores and its column reads at TR = 32 each hit 32
// banks. The wrapper (ops/kernels/probes.py: transpose_plan) takes TR = 8
// for arrays of at most 8 rows, so (8, 1024) runs 32 blocks with every
// thread busy, and TR = 32 otherwise: W4's other two shapes run 128 blocks,
// one wave on 132 SMs. The grid is gx tiles across by gy tiles down, one
// tile a block: a loop over bands (which would lift the 65535-band limit)
// cost about 0.1 us at W4's two larger shapes, so the wrapper refuses more
// than 65535 bands. A 4 x 4 block of words kept in each thread's registers
// (no shared memory, no barrier) ran from 2% faster to 4% slower at (128,
// 1024) and (1024, 128), varying with the card, and 3-8% slower at (8,
// 1024) and 3% at 8192^2 (python -m volren_tpu_torch.probes.variants).
//
// VEC (H, W and ld multiples of 4, x 16-byte aligned; out is a fresh
// allocation) takes the 16-byte path: a segment is then wholly inside the
// array or wholly outside. Otherwise each segment moves word by word with
// bound checks, exact for every shape and pitch.
constexpr int T_THREADS = 64, T_COLS = 32;

template <int TR, bool VEC>
__global__ void __launch_bounds__(T_THREADS)
    transpose_kernel(const uint32_t* __restrict__ x, int H, int W, long long ld,
                     uint32_t* __restrict__ out) {
  constexpr int N = TR * T_COLS / 4 / T_THREADS;  // 16-byte segments a thread
  __shared__ uint32_t tile[TR][T_COLS + 1];
  const int t = threadIdx.x, c0 = blockIdx.x * T_COLS, r0 = blockIdx.y * TR;
  uint4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = r0 + t / 8 + 8 * i, col = c0 + 4 * (t % 8);
    const uint32_t* src = x + row * ld + col;
    if (VEC) {
      if (row < H && col < W) v[i] = *reinterpret_cast<const uint4*>(src);
    } else if (row < H) {
      if (col < W) v[i].x = src[0];
      if (col + 1 < W) v[i].y = src[1];
      if (col + 2 < W) v[i].z = src[2];
      if (col + 3 < W) v[i].w = src[3];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t* d = &tile[t / 8 + 8 * i][4 * (t % 8)];
    d[0] = v[i].x;
    d[1] = v[i].y;
    d[2] = v[i].z;
    d[3] = v[i].w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int k = t + T_THREADS * i, p = k % (TR / 4), c = k / (TR / 4);
    const int orow = c0 + c, ocol = r0 + 4 * p;
    if (orow >= W) continue;
    uint32_t* dst = out + (long long)orow * H + ocol;
    if (VEC) {
      if (ocol < H)
        *reinterpret_cast<uint4*>(dst) = make_uint4(tile[4 * p][c], tile[4 * p + 1][c],
                                                    tile[4 * p + 2][c], tile[4 * p + 3][c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ocol + e < H) dst[e] = tile[4 * p + e][c];
    }
  }
}

// ---- tea8: 8 TEA rounds of (v0, v1) (volren_tpu/ops/rng.py's constants)
__global__ void tea8_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ o0, uint32_t* __restrict__ o1, int n) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t v0 = a[k], v1 = b[k], s = 0u;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    s += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  o0[k] = v0;
  o1[k] = v1;
}

// ---- row_scan: inclusive prefix sum of each row of an (H, W) f32 array,
// W <= 1024: one block per row, a shuffle scan inside each warp, then the
// warps' totals scanned by warp 0 and added back. It adds in another order
// than a sequential cumsum, so it agrees with one to rounding.
__global__ void row_scan_kernel(const float* __restrict__ x, float* __restrict__ out, int W) {
  __shared__ float warp_sum[32];
  int row = blockIdx.x, j = threadIdx.x, lane = j & 31, warp = j >> 5;
  float v = j < W ? x[(long long)row * W + j] : 0.0f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v = __fadd_rn(v, u);
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int n_warps = (blockDim.x + 31) >> 5;
    float w = lane < n_warps ? warp_sum[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      float u = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w = __fadd_rn(w, u);
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = __fadd_rn(v, warp_sum[warp - 1]);
  if (j < W) out[(long long)row * W + j] = v;
}

}  // namespace

extern "C" {

// short != 0: the short kernel, 1 <= iters <= SHORT_STEPS from the host, x
// and out 16-byte aligned (the wrapper's affine_short decides)
int probe_affine_loop(const float* x, float* out, int n, int iters, const int* iters_dev,
                      float a, float b, int short_loop, cudaStream_t stream) {
  if (!short_loop) {
    affine_loop_kernel<<<blocks(n), THREADS, 0, stream>>>(x, out, n, iters, iters_dev, a, b);
    return cudaGetLastError();
  }
  const int grid = blocks(n / 4 + n % 4);
  switch (iters) {
    case 1: affine_short_kernel<1><<<grid, THREADS, 0, stream>>>(x, out, n, a, b); break;
    case 2: affine_short_kernel<2><<<grid, THREADS, 0, stream>>>(x, out, n, a, b); break;
    case 3: affine_short_kernel<3><<<grid, THREADS, 0, stream>>>(x, out, n, a, b); break;
    case SHORT_STEPS:
      affine_short_kernel<SHORT_STEPS><<<grid, THREADS, 0, stream>>>(x, out, n, a, b); break;
    default: return int(cudaErrorInvalidValue);
  }
  return cudaGetLastError();
}

// tables and outs: n_tables pointers each; mod 0: no modulo. The plan
// (words a thread, block tx x ty, grid gx x gy) is the wrapper's gather_plan.
int probe_gather(const uint32_t* const* tables, uint32_t* const* outs, int n_tables, int C,
                 const int* r_idx, long long r_ld, int r_mode, int mod, const int* c_idx,
                 long long c_ld, int c_mode, int H, int W, int words, int tx, int ty, int gx,
                 int gy, cudaStream_t stream) {
  if (n_tables < 1 || n_tables > GATHER_TABLES || tx * ty > 1024) return int(cudaErrorInvalidValue);
  GatherArgs g{};
  for (int t = 0; t < n_tables; ++t) {
    g.T[t] = tables[t];
    g.out[t] = outs[t];
  }
  g.n_tables = n_tables, g.C = C, g.H = H, g.W = W;
  g.r_idx = r_idx, g.c_idx = c_idx, g.r_ld = r_ld, g.c_ld = c_ld;
  g.mod = mod;
  const dim3 grid(gx, gy), block(tx, ty);
  if (mod <= 0)
    return int(launch_gather_modes<MOD_NONE>(g, r_mode, c_mode, words, grid, block, stream));
  if ((mod & (mod - 1)) == 0)
    return int(launch_gather_modes<MOD_MASK>(g, r_mode, c_mode, words, grid, block, stream));
  return int(launch_gather_modes<MOD_PY>(g, r_mode, c_mode, words, grid, block, stream));
}

// (d, m, sh) of dc and dr, and the block size, are the wrapper's div_plan
// and lcg_threads
int probe_lcg_gather_sum(const uint32_t* T, int is_int, int mode, int C, unsigned dc_d,
                         unsigned dc_m, unsigned dc_sh, unsigned dr_d, unsigned dr_m,
                         unsigned dr_sh, unsigned seed, unsigned row_mul, int H, int W,
                         int iters, int threads, float* acc, cudaStream_t stream) {
  const Divisor dc{dc_d, dc_m, dc_sh}, dr{dr_d, dr_m, dr_sh};
  if (threads < 32 || threads > 1024 || threads % 32) return int(cudaErrorInvalidValue);
  return int(is_int ? launch_lcg<true>(mode, T, C, dc, dr, seed, row_mul, H, W, iters, threads,
                                       acc, stream)
                    : launch_lcg<false>(mode, T, C, dc, dr, seed, row_mul, H, W, iters, threads,
                                        acc, stream));
}

// (d, m, sh) of dr and dc, and the block size, are the wrapper's div_plan
// and lcg_threads (of CARRY_PARTS threads a lane)
int probe_carry30(const float* T, int C, unsigned dr_d, unsigned dr_m, unsigned dr_sh,
                  unsigned dc_d, unsigned dc_m, unsigned dc_sh, unsigned seed, int iters,
                  int n_lanes, int W, float c_keep, float c_mix, int threads, float* out,
                  cudaStream_t stream) {
  const Divisor dr{dr_d, dr_m, dr_sh}, dc{dc_d, dc_m, dc_sh};
  if (threads < 32 || threads > 1024 || threads % 32) return int(cudaErrorInvalidValue);
  const long long n_threads = (long long)n_lanes * CARRY_PARTS;
  carry30_kernel<<<int((n_threads + threads - 1) / threads), threads, 0, stream>>>(
      T, C, dr, dc, seed, iters, n_lanes, W, c_keep, c_mix, out);
  return cudaGetLastError();
}

int probe_march(const float* T, int R, int W, const float* x, const uint32_t* s0, int iters,
                float vel0, float s_near, float s_far, float decay, float* out,
                cudaStream_t stream) {
  march_kernel<<<(W + 127) / 128, 128, 0, stream>>>(T, R, W, x, s0, iters, vel0, s_near, s_far,
                                                     decay, out);
  return cudaGetLastError();
}

int probe_row_gather_rounds(int mode, const int* base, const uint32_t* tab, int rows,
                            int use_mask, int n, int rounds, uint32_t* out,
                            cudaStream_t stream) {
  switch (mode) {
    case MODE_IDS: return launch_rounds<MODE_IDS>(base, tab, rows, use_mask, n, rounds, out, stream);
    case MODE_DIRECT: return launch_rounds<MODE_DIRECT>(base, tab, rows, use_mask, n, rounds, out, stream);
    case MODE_STAGE: return launch_rounds<MODE_STAGE>(base, tab, rows, use_mask, n, rounds, out, stream);
    case MODE_STAGED: return launch_rounds<MODE_STAGED>(base, tab, rows, use_mask, n, rounds, out, stream);
    case MODE_STALE: return launch_rounds<MODE_STALE>(base, tab, rows, use_mask, n, rounds, out, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

int probe_index_copy(const uint32_t* x, int H, int W, int mode, int param, uint32_t* out,
                     int OH, int OW, cudaStream_t stream) {
  if (mode == IC_TRANSPOSE) return int(cudaErrorInvalidValue);  // probe_transpose
  index_copy_kernel<<<blocks((long long)OH * OW), THREADS, 0, stream>>>(x, H, W, mode, param,
                                                                         out, OH, OW);
  return cudaGetLastError();
}

// the plan (vec, tile_rows, gx, gy) is the wrapper's transpose_plan
int probe_transpose(const uint32_t* x, int H, int W, long long ld, int vec, int tile_rows,
                    int gx, int gy, uint32_t* out, cudaStream_t stream) {
  const dim3 grid(gx, gy);
  if (tile_rows == 8 && vec)
    transpose_kernel<8, true><<<grid, T_THREADS, 0, stream>>>(x, H, W, ld, out);
  else if (tile_rows == 8)
    transpose_kernel<8, false><<<grid, T_THREADS, 0, stream>>>(x, H, W, ld, out);
  else if (tile_rows == 32 && vec)
    transpose_kernel<32, true><<<grid, T_THREADS, 0, stream>>>(x, H, W, ld, out);
  else if (tile_rows == 32)
    transpose_kernel<32, false><<<grid, T_THREADS, 0, stream>>>(x, H, W, ld, out);
  else
    return int(cudaErrorInvalidValue);
  return cudaGetLastError();
}

int probe_tea8(const uint32_t* a, const uint32_t* b, uint32_t* o0, uint32_t* o1, int n,
               cudaStream_t stream) {
  tea8_kernel<<<blocks(n), THREADS, 0, stream>>>(a, b, o0, o1, n);
  return cudaGetLastError();
}

int probe_row_scan(const float* x, float* out, int H, int W, cudaStream_t stream) {
  row_scan_kernel<<<H, ((W + 31) / 32) * 32, 0, stream>>>(x, out, W);
  return cudaGetLastError();
}

}  // extern "C"
