// The volume path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces volren_tpu/ops/pallas/kernel.py:602 (_make_kernel) in all four
// of its scene variants (in both its VMEM-atlas and HBM-atlas modes): the
// no-TF, no-emission kernel, the TF variant (`use_tf`, kernel.py:635) and
// the emission variant (`has_emi`, kernel.py:636), here the template
// parameters USE_TF and HAS_EMI, each with the f32 tables or with the
// packed tables of its `mip_u8`, `env_rgbe` and `pool_rgbe` modes (the
// template parameter MIP_U8: kernel.py:780-826, :952-958; RGBE, the two
// RGBE reads, kernel.py:833-838, :1753-1794 and :687, :1626-1635: both at
// compile time in the all-packs instantiation, volren_tpu's default, or
// each under a flag of the parameter block). For every pixel, `spp` full volumetric
// path samples, written once as the per-pixel SUM over samples of (L.rgb,
// alpha). A dispatch may trace a band of the frame's rows only (pi[PI_ROW0],
// pi[PI_ROWS]; parallel/sharding.py renders across devices with bands):
// its pixels keep the whole frame's seeds and camera rays, so the bands of
// a frame, put together, are bitwise the whole frame's dispatch. The plain
// torch version of the same function is
// volren_tpu_torch/ops/kernels/megakernel.py::render_plain; this file
// repeats its arithmetic operation for operation (built with -fmad=false,
// IEEE division and square root), so the two images are bitwise equal.
//
// What bounds it on this card: latency, not bytes or FLOPs (a dispatch
// runs at a few percent of either bound). A sample is a chain of dependent
// steps: a DDA substep waits on a majorant gather from the L2-resident
// pyramid, a collision test on a brick-meta -> atlas chain (8 of them for
// the TF trilinear, one more grid for the emission tap), an NEE on a pool
// row, an escape on an environment texel. Samples differ in length by two
// orders of magnitude: a sky sample ends after a substep or two, a cloud
// sample at 100 bounces runs hundreds. Only many chains in flight hide
// the latency, and one long chain sets a dispatch's end.
//
// What the schedule does about it: the unit of work is a sample, not a
// pixel. A warp owns a group of neighbouring pixels (one pixel at 32 spp
// or more, a 2-D tile of 32/spp of them below, rounded to a power of two)
// and all their samples; each lane traces one sample and, when it ends,
// parks the sample's (L.rgb, alpha) in shared memory and takes the
// group's next sample (a ballot and a prefix count). So a cloud pixel's 64
// samples run 32 at a time instead of one after another, and a sky
// group's lanes finish together. Warps of persistent blocks (as many as
// fit on the card) take groups from one global counter, so no SM idles
// while groups remain. A lane marches in a tight loop of DDA substeps
// until an event and runs the resolve / NEE / finish code only then. The
// register bound allows 8 resident blocks (32 warps) per SM where ptxas
// spills nothing new (7 and 6 for the emission variants). Every table
// stays in global memory and L2-resident: the 512x512x256 cloud is a 10
// MB atlas plus about 2 MB of meta, mips, environment and pool against 50
// MB of L2, so the TPU kernel's HBM-atlas DMA machinery and its compaction
// / route-back serve rounds have no counterpart here. No atomics touch
// the image: after a group's samples end, lane j adds pixel j's slots in
// sample order from 0.0f, as render_plain does, so the image is bitwise
// identical from run to run. Each sample is TEA-seeded from (pixel,
// sample), so its arithmetic does not depend on the lane that runs it; a
// sample past its step budget ends and adds nothing, in both versions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// slot indices of the parameter block; must match
// volren_tpu_torch/ops/kernels/pack.py
constexpr int PF_CAM_POS = 0, PF_CAM_XFORM = 3, PF_ZCAM = 12, PF_BB_MIN = 13,
              PF_BB_MAX = 16, PF_MAJORANT = 19, PF_INV_MAJORANT = 20,
              PF_ALBEDO = 21, PF_PHASE_G = 24, PF_DENSITY_SCALE = 25,
              PF_INV_XFORM = 26, PF_ENV_INV = 42, PF_ENV_STRENGTH = 51,
              PF_IMP_AVG = 52, PF_SHOW_ENV = 53, PF_TF_LEFT = 54,
              PF_TF_WIDTH = 55, PF_EMI_SCALE = 56, PF_EMI_NORM = 57,
              PF_EMI_X = 58;
constexpr int PI_WIDTH = 0, PI_HEIGHT = 1, PI_SPP_BASE = 2, PI_BOUNCES = 3,
              PI_SEED = 4, PI_SPP = 5, PI_N_BRICKS = 6, PI_N_SLOTS = 9,
              PI_ENV_H = 10, PI_ENV_W = 11, PI_MIP_DIMS = 12,
              PI_MIP_OFFSETS = 24, PI_MAX_ITERS = 28, PI_TF_SIZE = 29,
              PI_EMI_N_BRICKS = 30, PI_EMI_N_SLOTS = 33, PI_ROW0 = 34, PI_ROWS = 35,
              PI_MIP_U8 = 36;
// the bits of volren_render's `packs`: the tables a dispatch reads packed
// (ops/kernels/megakernel.py PACKS)
constexpr int PACK_MIP_U8 = 1, PACK_ENV_RGBE = 2, PACK_POOL_RGBE = 4;
// the RGBE template parameter: the f32 texels and pool; either RGBE read
// under its flag of the parameter block (Packed::env_on, pool_on); both
// RGBE reads, at compile time
enum { RGBE_OFF = 0, RGBE_FLAGS = 1, RGBE_ALL = 2 };
constexpr int POOL_N = 16384;

constexpr float INV_2PI = float(1.0 / (2.0 * PI_D));
constexpr float INV_PI = float(1.0 / PI_D);

enum { MODE_EXTEND = 2, MODE_SHADOW = 3 };   // render_plain's values
enum { EV_NONE = 0, EV_EXT_HIT = 1, EV_EXT_EXIT = 2, EV_SH_HIT = 3,
       EV_SH_EXIT = 4, EV_SCATTER = 5, EV_TEST = 6 };

struct Params {
  float cam_pos[3], cam_m[9], z_cam, bb_min[3], bb_max[3], albedo[3];
  float phase_g, density_scale, inv_x[16], env_inv[9], env_strength, imp_avg;
  float majorant, inv_majorant, tf_left, tf_width, emi_scale, emi_norm, emi_x[16];
  int show_env, width, height, spp_base, bounces, spp;
  uint32_t seed;
  int env_h, env_w, mip_dims[12], mip_offsets[4];
  int budget, tf_size;
  int row0, rows;                          // the band of rows traced
  int tile_w, tile_h, tiles_x, n_groups;   // the schedule's pixel groups over the band
};

// one brick grid: u8 atlas (slots, 512), per-brick slot / decode range
struct BrickGrid {
  const uint8_t* __restrict__ atlas;
  const int* __restrict__ slot;
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  int nbx, nby, nbz, n_slots;
};

struct Tables {
  BrickGrid dens, emi;                 // emi: HAS_EMI only
  const float* __restrict__ mip;       // USE_TF: the TF-baked table
  const float* __restrict__ env;
  const float* __restrict__ pool;
  const float* __restrict__ tf_lut;    // USE_TF only: (tf_size, 4) RGBA
};

// the packed tables (ops/kernels/pack.py) and their parameters, read only
// by the packed instantiations: the baked pyramid as one byte an entry
// (MIP_U8, in place of mip) with its per-level dequantisation rows (lo[4],
// scale[4]) in device memory, written there by the pyramid's build kernel
// (mip_u8_build), and under RGBE the texels as RGBE words (in place of env)
// and the pool as POOL_N float4 [w, pdf] rows followed by POOL_N radiance
// words, each when its flag is set (RGBE_FLAGS) or both (RGBE_ALL)
struct Packed {
  const uint8_t* __restrict__ mip_u8;
  const float* __restrict__ mip_dq;
  const uint32_t* __restrict__ env_rgbe;
  const uint32_t* __restrict__ pool_le;
  int env_on, pool_on;
};

// the u8 pyramid's (lo, scale) of each level, staged from Packed::mip_dq
// once a block (MIP_U8 instantiations only)
__shared__ float2 s_mip_dq[4];

// ---- the STATS instantiation's counters (never launched by the render
// path): per dispatch, warp-level loop and march-substep issues with the
// active lanes summed over them (their ratio is the SIMT efficiency), the
// lanes that ran each of render_plain's events (regen, march, test,
// emission, nee, escape, scatter; render_plain(stats=) counts the same),
// capped samples, the most march substeps of a sample, and each block's
// start and end on %globaltimer; the MIP_U8 instantiations' twins also count
// the march substeps at each pyramid level (where the u8 reads land)
enum { ST_LOOP = 0, ST_LOOP_LANES, ST_MARCH_ISSUES, ST_MARCH_LANES, ST_REGEN, ST_MARCH,
       ST_TEST, ST_EMISSION, ST_NEE, ST_ESCAPE, ST_SCATTER, ST_CAPPED, ST_MAX_STEPS, N_STATS,
       ST_LEVEL0 = N_STATS, N_STATS_U8 = N_STATS + 4 };

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one issue of the calling code by the lanes now converged here: the
// lowest of them counts it and the lanes
__device__ __forceinline__ void warp_tick(unsigned& issues, unsigned& lanes) {
  const unsigned m = __activemask();
  if (int(threadIdx.x & 31) == __ffs(m) - 1) {
    issues += 1;
    lanes += unsigned(__popc(m));
  }
}

template <int N>
struct Counters {
  unsigned v[N] = {};
  // sum (max) over the lanes converged here, one atomic per counter, and
  // the block's end time
  __device__ __forceinline__ void flush(unsigned long long* stats,
                                        unsigned long long* btimes) const {
    const unsigned m = __activemask();
    const bool leader = int(threadIdx.x & 31) == __ffs(m) - 1;
    for (int k = 0; k < N; ++k) {
      const unsigned x = k == ST_MAX_STEPS ? __reduce_max_sync(m, v[k])
                                           : __reduce_add_sync(m, v[k]);
      if (leader && x) {
        if (k == ST_MAX_STEPS) atomicMax(stats + k, (unsigned long long)x);
        else atomicAdd(stats + k, (unsigned long long)x);
      }
    }
    if (leader) atomicMax(btimes + 2 * blockIdx.x + 1, globaltimer());
  }
};

__device__ __forceinline__ void norm3(float v[3]) {
  const float inv = 1.0f / vmax(sqrtf(dot3(v, v)), 1e-20f);
  v[0] = v[0] * inv;
  v[1] = v[1] * inv;
  v[2] = v[2] * inv;
}

__device__ __forceinline__ void mat3_vec(const float* m, const float v[3], float out[3]) {
  out[0] = v[0] * m[0] + v[1] * m[1] + v[2] * m[2];
  out[1] = v[0] * m[3] + v[1] * m[4] + v[2] * m[5];
  out[2] = v[0] * m[6] + v[1] * m[7] + v[2] * m[8];
}

__device__ __forceinline__ void align(const float n[3], const float v[3], float out[3]) {
  const bool cond = fabsf(n[0]) > fabsf(n[1]);
  const float inv_xz = 1.0f / sqrtf(cond ? n[0] * n[0] + n[2] * n[2]
                                         : n[1] * n[1] + n[2] * n[2]);
  const float t[3] = {(cond ? -n[2] : 0.0f) * inv_xz, (cond ? 0.0f : n[2]) * inv_xz,
                      (cond ? n[0] : -n[1]) * inv_xz};
  const float b[3] = {n[1] * t[2] - n[2] * t[1], n[2] * t[0] - n[0] * t[2],
                      n[0] * t[1] - n[1] * t[0]};
  for (int k = 0; k < 3; ++k) out[k] = v[0] * t[k] + v[1] * b[k] + v[2] * n[k];
  norm3(out);
}

__device__ __forceinline__ void sample_hg(const float dir[3], float g, float u0, float u1,
                                          float out[3]) {
  const float sqr = (1.0f - g * g) / (1.0f - g + 2.0f * g * u0);
  const bool small = fabsf(g) < 1e-4f;
  const float cos_aniso = (1.0f + g * g - sqr * sqr) / (2.0f * (small ? 1.0f : g));
  const float cos_t = small ? 1.0f - 2.0f * u0 : cos_aniso;
  const float sin_t = sqrtf(vmax(1.0f - cos_t * cos_t, 0.0f));
  const float phi = TWO_PI * u1;
  const float local[3] = {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
  align(dir, local, out);
}

// one sample's path state (the Pallas kernel's lane state, one lane)
struct Lane {
  int mode, event;
  uint32_t seed;
  float po[3], pd[3], th[3], L[3], pn[3];
  int n_paths, free_path;
  float last_f_p, t, far_t, tau, mip;
  float i0[3], id[3], ri[3];
  int steps;  // march substeps of this sample
};

// a ray's box interval, first free-path draw and index-space frame; a
// masked-off lane draws nothing and keeps its state
__device__ __forceinline__ void setup_ray(const Params& P, Lane& s, const float org[3],
                                          const float dir[3], bool mask) {
  if (!mask) return;
  float tmin[3], tmax[3];
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / dir[k];
    const float lo = (P.bb_min[k] - org[k]) * inv;
    const float hi = (P.bb_max[k] - org[k]) * inv;
    tmin[k] = vmin(lo, hi);
    tmax[k] = vmax(lo, hi);
  }
  const float near_t = vmax(vmax(tmin[0], vmax(tmin[1], tmin[2])), 0.0f);
  const float far_t = vmin(tmax[0], vmin(tmax[1], tmax[2]));
  const bool hit = near_t <= far_t;
  const float* m = P.inv_x;
  const float u_tau = rng(s.seed, hit);
  s.t = near_t + 1e-6f;
  s.far_t = hit ? far_t : 0.0f;
  s.tau = -logf(1.0f - u_tau);
  s.mip = 3.0f;
  s.i0[0] = org[0] * m[0] + org[1] * m[1] + org[2] * m[2] + m[3];
  s.i0[1] = org[0] * m[4] + org[1] * m[5] + org[2] * m[6] + m[7];
  s.i0[2] = org[0] * m[8] + org[1] * m[9] + org[2] * m[10] + m[11];
  s.id[0] = dir[0] * m[0] + dir[1] * m[1] + dir[2] * m[2];
  s.id[1] = dir[0] * m[4] + dir[1] * m[5] + dir[2] * m[6];
  s.id[2] = dir[0] * m[8] + dir[1] * m[9] + dir[2] * m[10];
  for (int k = 0; k < 3; ++k) s.ri[k] = 1.0f / s.id[k];
}

// an RGBE word's three channels (pack.rgbe_decode, kernel.py:590-600):
// mantissa * 2^(e - 135), the scale built by placing e - 8 in a float's
// exponent field; exact, a word of 0 decodes to -0.0
__device__ __forceinline__ void rgbe_decode(uint32_t w, float out[3]) {
  const float scale = __uint_as_float((((w >> 24) & 255u) - 8u) << 23);
  out[0] = float(w & 255u) * scale;
  out[1] = float((w >> 8) & 255u) * scale;
  out[2] = float((w >> 16) & 255u) * scale;
}

__device__ __forceinline__ float4 rgbe_texel(uint32_t w) {
  float c[3];
  rgbe_decode(w, c);
  return make_float4(c[0], c[1], c[2], 0.0f);
}

// the u8 pyramid's majorant (kernel.py:780-826): lo[m] + q * scale[m],
// quantised up and baked like the TF table, so no density_scale factor.
// The level's (lo, scale) come from the block's shared copy, off the byte's
// chain. (Measured against this, in turns: (lo, scale) from the constant
// bank as kernel parameters, loaded from device memory, the byte converted
// without I2F, and the next substep's byte fetched before this one's is
// decoded, were each slower: volren_tpu_torch/packs_measure.py.)
__device__ __forceinline__ float majorant_u8(const Params& P, const Packed& K, const float c[3],
                                             int mip_i) {
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
  const float2 d = s_mip_dq[mip_i];
  return d.x + float(__ldg(K.mip_u8 + idx)) * d.y;
}

template <bool USE_TF, bool MIP_U8>
__device__ __forceinline__ float majorant_at(const Params& P, const Tables& T, const Packed& K,
                                             const float c[3], int mip_i) {
  if constexpr (MIP_U8) return majorant_u8(P, K, c, mip_i);
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
  if (USE_TF) return T.mip[idx];  // baked: majorant * tf_alpha(...)
  return P.density_scale * T.mip[idx];
}

// stochastic tricubic tap (9 draws in x, y, z order per tap index)
__device__ __forceinline__ void stochastic_tricubic(const float pos[3], uint32_t& seed,
                                                    float tap[3]) {
  float iip[3], t[3], t3[3], sum_wt[3], idxf[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    iip[k] = floorf(pos[k] - 0.5f);
    t[k] = (pos[k] - 0.5f) - iip[k];
    t3[k] = t[k] * (t[k] * t[k]);
    const float tt = t[k];
    sum_wt[k] = SIXTH * (-tt * tt * tt + 3.0f * tt * tt - 3.0f * tt + 1.0f);
  }
  for (int tap_idx = 1; tap_idx <= 3; ++tap_idx) {
    float wv[3], r[3];
    for (int k = 0; k < 3; ++k) {
      const float tt = t[k];
      if (tap_idx == 1)
        wv[k] = SIXTH * (3.0f * t3[k] - 6.0f * tt * tt + 4.0f);
      else if (tap_idx == 2)
        wv[k] = SIXTH * (-3.0f * t3[k] + 3.0f * tt * tt + 3.0f * tt + 1.0f);
      else
        wv[k] = SIXTH * t3[k];
      sum_wt[k] = wv[k] + sum_wt[k];
    }
    for (int k = 0; k < 3; ++k) r[k] = rng(seed, true);
    for (int k = 0; k < 3; ++k)
      if (r[k] < wv[k] / vmax(sum_wt[k], 1e-3f)) idxf[k] = float(tap_idx);
  }
  for (int k = 0; k < 3; ++k) tap[k] = iip[k] + idxf[k] - 1.0f;
}

__device__ __forceinline__ float lookup_brick(const BrickGrid& G, const float tap[3]) {
  const int vx = clampi(int(tap[0]), 0, G.nbx * 8 - 1);
  const int vy = clampi(int(tap[1]), 0, G.nby * 8 - 1);
  const int vz = clampi(int(tap[2]), 0, G.nbz * 8 - 1);
  const int bidx = (vz >> 3) * (G.nby * G.nbx) + (vy >> 3) * G.nbx + (vx >> 3);
  const int voff = (vz & 7) * 64 + (vy & 7) * 8 + (vx & 7);
  const int slot = clampi(G.slot[bidx], 0, G.n_slots - 1);
  const float unorm = float(G.atlas[size_t(slot) * 512 + voff]) * INV_255;
  const float lo = G.lo[bidx], hi = G.hi[bidx];
  return lo + unorm * (hi - lo);
}

// exact trilinear density (kernel.py trilinear_compact): 8 corners, dx
// fastest, acc + w * decode, then * density_scale
__device__ __forceinline__ float trilinear(const Params& P, const BrickGrid& G,
                                           const float pos[3]) {
  float base[3], frac[3];
  for (int k = 0; k < 3; ++k) {
    const float p = pos[k] - 0.5f;
    base[k] = floorf(p);
    frac[k] = p - base[k];
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i & 1, dy = (i >> 1) & 1, dz = i >> 2;
    const float w = (dx ? frac[0] : 1.0f - frac[0]) * (dy ? frac[1] : 1.0f - frac[1]) *
                    (dz ? frac[2] : 1.0f - frac[2]);
    const float tap[3] = {base[0] + float(dx), base[1] + float(dy), base[2] + float(dz)};
    acc = acc + w * lookup_brick(G, tap);
  }
  return P.density_scale * acc;
}

// the LUT bins of normalised density d under the window (left, width) of a
// `size`-bin LUT (ops/transfer.py _lerp_index): the lower bin, the upper
// one and the fraction between them. K2's fetch and the majorant's bake
// (tf_majorant_bake) both take it from here.
struct TfBin {
  int idx, idx1;
  float fr;
};

__device__ __forceinline__ TfBin tf_bin(float d, float left, float width, int size) {
  const float tc = vmin(vmax((d - left) / width, 0.0f), TF_WINDOW_MAX) * float(size);
  const int idx = clampi(int(floorf(tc)), 0, size - 1);
  return {idx, min(idx + 1, size - 1), tc - float(idx)};
}

// the lerp between two LUT entries (ops/transfer.py tf_lookup)
__device__ __forceinline__ float tf_lerp(float lo, float hi, float fr) {
  return lo * (1.0f - fr) + hi * fr;
}

// windowed, lerped LUT fetch (ops/transfer.py, common.glsl:195-212) of
// channels [c0, c0 + n) at normalised density d
__device__ __forceinline__ void tf_channels(const Params& P, const float* __restrict__ lut,
                                            float d, int c0, int n, float out[]) {
  const TfBin b = tf_bin(d, P.tf_left, P.tf_width, P.tf_size);
  for (int k = 0; k < n; ++k)
    out[k] = tf_lerp(lut[4 * b.idx + c0 + k], lut[4 * b.idx1 + c0 + k], b.fr);
}

// ---- one sample, phase by phase (render_plain's phases for one lane)

// regen (kernel.py phase_regen): sample `k` of pixel (px, py)
__device__ __forceinline__ void start_sample(const Params& P, Lane& s, int px, int py, int k) {
  const uint32_t lane_u = uint32_t(py) * uint32_t(P.width) + uint32_t(px);
  s.seed = tea(P.seed * lane_u, uint32_t(P.spp_base + k + 1));
  const float u1 = rng(s.seed, true);
  const float u2 = rng(s.seed, true);
  float cl[3] = {(float(px) + u1 - float(P.width) * 0.5f) / float(P.height),
                 (float(py) + u2 - float(P.height) * 0.5f) / float(P.height), P.z_cam};
  norm3(cl);
  float nd[3];
  mat3_vec(P.cam_m, cl, nd);
  norm3(nd);
  for (int c = 0; c < 3; ++c) {
    s.po[c] = P.cam_pos[c]; s.pd[c] = nd[c]; s.th[c] = 1.0f;
    s.L[c] = 0.0f; s.pn[c] = 0.0f;
  }
  s.mode = MODE_EXTEND;
  s.event = EV_NONE;
  s.n_paths = 0;
  s.last_f_p = 0.0f;
  s.free_path = 1;
  s.steps = 0;
  setup_ray(P, s, s.po, s.pd, true);
}

// one DDA substep (phase_march + majorant_at)
template <bool USE_TF, bool MIP_U8>
__device__ __forceinline__ void march_substep(const Params& P, const Tables& T, const Packed& K,
                                              Lane& s) {
  const bool is_extend = s.mode == MODE_EXTEND;
  float curr[3];
  for (int k = 0; k < 3; ++k) curr[k] = s.i0[k] + s.t * s.id[k];
  const int mip_i = int(rintf(s.mip));   // round half to even
  const float maj = majorant_at<USE_TF, MIP_U8>(P, T, K, curr, mip_i);
  const float dim = float(8 << mip_i);
  const float inv_dim = 1.0f / dim;      // exact: a power of two
  float dts[3];
  for (int k = 0; k < 3; ++k) {
    const float offs = s.ri[k] >= 0.0f ? dim + 0.5f : -0.5f;
    dts[k] = (floorf(curr[k] * inv_dim) * dim + offs - curr[k]) * s.ri[k];
  }
  const float dt = vmin(dts[0], vmin(dts[1], dts[2]));
  const float t_adv = s.t + dt;
  const float tau_adv = s.tau - maj * dt;
  const float mip_up = vmin(s.mip + 0.25f, 3.0f);
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
}

// null-collision test (resolve_tests: stochastic_tricubic +
// lookup_density_brick, or the TF trilinear; then the emission tap)
template <bool USE_TF, bool HAS_EMI>
__device__ __forceinline__ void resolve_test(const Params& P, const Tables& T, Lane& s) {
  const bool is_extend = s.mode == MODE_EXTEND;
  const float maj = s.tau;
  float pos[3];
  for (int k = 0; k < 3; ++k) pos[k] = s.i0[k] + s.t * s.id[k];
  float d;
  if (USE_TF) {
    // the exact trilinear density through the LUT alpha; no draws
    float a_tf;
    tf_channels(P, T.tf_lut, trilinear(P, T.dens, pos) * P.inv_majorant, 3, 1, &a_tf);
    d = P.majorant * a_tf;
  } else {
    float tap[3];
    stochastic_tricubic(pos, s.seed, tap);
    d = P.density_scale * lookup_brick(T.dens, tap);
  }
  if (HAS_EMI && is_extend) {
    // emission (common.glsl:324-328): 9 draws after the density fetch,
    // before u_cls, extend lanes only
    const float* m = P.emi_x;
    const float epos[3] = {pos[0] * m[0] + pos[1] * m[1] + pos[2] * m[2] + m[3],
                           pos[0] * m[4] + pos[1] * m[5] + pos[2] * m[6] + m[7],
                           pos[0] * m[8] + pos[1] * m[9] + pos[2] * m[10] + m[11]};
    float etap[3];
    stochastic_tricubic(epos, s.seed, etap);
    const float t_e = lookup_brick(T.emi, etap) * P.emi_norm;
    const float t2 = t_e * t_e;
    const float e3[3] = {t2, t2 * t2, (t2 * t2) * (t2 * t2)};
    const float wgt_e = d * P.inv_majorant;
    for (int k = 0; k < 3; ++k)
      s.L[k] = s.L[k] + s.th[k] * (1.0f - P.albedo[k]) * (P.emi_scale * e3[k]) * wgt_e;
  }
  const float u_cls = rng(s.seed, true);
  const bool real = u_cls * vmax(maj, 0.0f) < d;
  const float u_tau = rng(s.seed, !real);
  if (real) {
    s.event = is_extend ? EV_EXT_HIT : EV_SH_HIT;
  } else {
    s.tau = -logf(1.0f - u_tau);
    s.mip = vmax(s.mip - 2.0f, 0.0f);
    s.event = EV_NONE;
  }
}

// next-event estimation from the alias pool (phase_nee). RGBE_ALL issues
// the sample's [w, pdf] row and radiance word together and decodes the
// word after the shadow ray's set-up, which needs only the row.
template <bool USE_TF, int RGBE>
__device__ __forceinline__ void nee(const Params& P, const Tables& T, const Packed& K, Lane& s) {
  float mult[3] = {P.albedo[0], P.albedo[1], P.albedo[2]};
  if (USE_TF) {
    // tint by the LUT colour at the collision; no draws
    float pos[3], rgb[3];
    for (int k = 0; k < 3; ++k) pos[k] = s.i0[k] + s.t * s.id[k];
    tf_channels(P, T.tf_lut, trilinear(P, T.dens, pos) * P.inv_majorant, 0, 3, rgb);
    for (int k = 0; k < 3; ++k) mult[k] = P.albedo[k] * rgb[k];
  }
  const float u0 = rng(s.seed, true);
  rng(s.seed, true);
  const int pidx = clampi(int(u0 * float(POOL_N)), 0, POOL_N - 1);
  // packed: a 16-byte [w, pdf] row and one radiance word
  const bool packed = RGBE == RGBE_ALL || (RGBE == RGBE_FLAGS && K.pool_on != 0);
  const float4 r0 = reinterpret_cast<const float4*>(T.pool)[packed ? pidx : 2 * pidx];
  uint32_t word = 0u;
  float4 r1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (RGBE == RGBE_ALL)
    word = __ldg(K.pool_le + pidx);
  else
    r1 = packed ? rgbe_texel(__ldg(K.pool_le + pidx))
                : reinterpret_cast<const float4*>(T.pool)[2 * pidx + 1];
  const float w_i[3] = {r0.x, r0.y, r0.z};
  const float pdf_nee = r0.w;
  const float le[3] = {r1.x, r1.y, r1.z};
  for (int k = 0; k < 3; ++k) s.th[k] = s.th[k] * mult[k];
  float org[3];
  for (int k = 0; k < 3; ++k) org[k] = s.po[k] + s.t * s.pd[k];
  for (int k = 0; k < 3; ++k) s.po[k] = org[k];
  s.n_paths += 1;
  const float f_p = hg_phase(-dot3(s.pd, w_i), P.phase_g);
  const float mis = P.show_env != 0
      ? (pdf_nee * pdf_nee) / vmax(pdf_nee * pdf_nee + f_p * f_p, 1e-32f) : 1.0f;
  const bool has_nee = pdf_nee > 0.0f;
  const float wgt = mis * f_p / vmax(pdf_nee, 1e-20f);
  if (has_nee) {
    if constexpr (RGBE != RGBE_ALL)
      for (int k = 0; k < 3; ++k) s.pn[k] = s.th[k] * wgt * le[k];
    s.mode = MODE_SHADOW;
    s.event = EV_NONE;
  } else {
    s.event = EV_SCATTER;
  }
  setup_ray(P, s, org, has_nee ? w_i : s.pd, has_nee);
  if constexpr (RGBE == RGBE_ALL) {
    if (has_nee) {
      float lw[3];
      rgbe_decode(word, lw);
      for (int k = 0; k < 3; ++k) s.pn[k] = s.th[k] * wgt * lw[k];
    }
  }
}

// the escape's texel: three floats, or its RGBE word (RGBE_ALL, or
// RGBE_FLAGS with the flag set)
template <int RGBE>
__device__ __forceinline__ float4 env_texel(const Params& P, const Tables& T, const Packed& K,
                                            int i) {
  if constexpr (RGBE == RGBE_ALL) return rgbe_texel(__ldg(K.env_rgbe + i));
  if constexpr (RGBE == RGBE_FLAGS) {
    if (K.env_on != 0) return rgbe_texel(__ldg(K.env_rgbe + i));
  }
  const float* e = T.env + size_t(i) * 3;
  return make_float4(e[0], e[1], e[2], 0.0f);
}

// shadow / escape accumulation, Russian roulette, HG scatter
// (phase_finish) of a lane with an event. Returns true when the sample
// ends, with its sanitized (L.rgb, alpha) in `res`.
template <int RGBE>
__device__ __forceinline__ bool finish(const Params& P, const Tables& T, const Packed& K,
                                       Lane& s, float4& res) {
  const float g = P.phase_g;
  const int ev = s.event;
  const bool sh_hit = ev == EV_SH_HIT;
  rng(s.seed, sh_hit);
  const bool sh_vis = ev == EV_SH_EXIT;
  float Lc[3];
  for (int k = 0; k < 3; ++k) Lc[k] = s.L[k] + (sh_vis ? s.pn[k] : 0.0f);
  const bool esc = ev == EV_EXT_EXIT;
  if (esc) {
    // stochastic bilinear environment tap: u wraps, v clamps
    float idir[3];
    mat3_vec(P.env_inv, s.pd, idir);
    const float uu = atan2f(idir[2], idir[0]) * INV_2PI + 0.5f;
    const float vv = 1.0f - acosf(vmin(vmax(idir[1], -1.0f), 1.0f)) * INV_PI;
    const float x = uu * float(P.env_w) - 0.5f;
    const float y = vv * float(P.env_h) - 0.5f;
    const float rx = rng(s.seed, true);
    const float ry = rng(s.seed, true);
    const int xt = int(floorf(x + rx)), yt = int(floorf(y + ry));
    int xw = xt < 0 ? xt + P.env_w : xt;
    xw = clampi(xw >= P.env_w ? xw - P.env_w : xw, 0, P.env_w - 1);
    const int yc = clampi(yt, 0, P.env_h - 1);
    const float4 e = env_texel<RGBE>(P, T, K, yc * P.env_w + xw);
    const float le_env[3] = {P.env_strength * e.x, P.env_strength * e.y,
                             P.env_strength * e.z};
    const float pdf_esc = luma(le_env) / P.imp_avg * INV_4PI;
    const float a2 = s.last_f_p * s.last_f_p;
    const float mis_esc = s.n_paths > 0 ? a2 / vmax(a2 + pdf_esc * pdf_esc, 1e-32f) : 1.0f;
    const bool add = s.free_path != 0;
    if (P.show_env != 0)
      for (int k = 0; k < 3; ++k) Lc[k] = Lc[k] + (add ? s.th[k] * mis_esc * le_env[k] : 0.0f);
  }
  const bool scatter = sh_hit || sh_vis || ev == EV_SCATTER;
  const bool capped = scatter && s.n_paths >= P.bounces;
  bool alive = scatter && !capped;
  const float rr_val = luma(s.th);
  const bool rr = alive && rr_val < 0.1f;
  const float u_rr = rng(s.seed, rr);
  const bool killed = rr && u_rr < 1.0f - rr_val;
  const float boost = 1.0f / vmax(rr_val, 1e-20f);
  if (rr && !killed)
    for (int k = 0; k < 3; ++k) s.th[k] = s.th[k] * boost;
  alive = alive && !killed;
  if (capped || killed) s.free_path = 0;
  const float s0 = rng(s.seed, alive);
  const float s1 = rng(s.seed, alive);
  if (alive) {
    float sc[3];
    sample_hg(s.pd, g, s0, s1, sc);
    s.last_f_p = hg_phase(-dot3(s.pd, sc), g);
    for (int k = 0; k < 3; ++k) s.pd[k] = sc[k];
  }
  const bool end = esc || capped || killed;
  if (end) {
    const float alpha = vmin(vmax(float(s.n_paths), 0.0f), 1.0f);
    res = make_float4(sanitize(Lc[0]), sanitize(Lc[1]), sanitize(Lc[2]), sanitize(alpha));
    return true;
  }
  for (int k = 0; k < 3; ++k) s.L[k] = Lc[k];
  if (alive) s.mode = MODE_EXTEND;
  if (scatter) s.event = EV_NONE;
  setup_ray(P, s, s.po, s.pd, alive);
  return false;
}

// ---- the schedule

constexpr int WARPS = 4;                  // warps per block
constexpr int THREADS = 32 * WARPS;
// resident blocks per SM that a variant's registers must allow: the most
// at which ptxas spills nothing new (8 blocks = 64 registers; the emission
// variants need 70 and 80)
constexpr int min_blocks(bool use_tf, bool has_emi) {
  return has_emi ? (use_tf ? 6 : 7) : 8;
}
constexpr int SLOTS = 64;                 // a warp's (pixel, sample) result slots: one round
constexpr unsigned FULL = 0xffffffffu;

// a capped sample's slot: NaN alpha (a sanitized alpha is never NaN)
__device__ __forceinline__ float4 capped_slot() {
  return make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7fffffff));
}

// One warp renders one group: the pixels of a tile_w x tile_h tile of the
// band (cut at the band's edge) and all their samples. The tiles and the
// output cover the band's rows only; a pixel's seed, camera ray and samples
// are the whole frame's. Its items are (pixel j, sample
// k) = j * spp + k, served in rounds of SLOTS: each lane traces one item at
// a time and, when its sample ends, leaves the sample's (L.rgb, alpha) in
// the item's slot and takes the round's next item (a ballot and a prefix
// count, no atomics). After a round, lane j adds pixel j's slots in sample
// order, from 0.0f, as render_plain does; a capped sample adds nothing.
template <bool USE_TF, bool HAS_EMI, bool STATS, bool MIP_U8, int RGBE, int N>
__device__ __forceinline__ void render_group(const Params& P, const Tables& T, const Packed& K,
                                             float* __restrict__ out, int group,
                                             float4* slot, Counters<N>& cnt) {
  const int lane = threadIdx.x & 31;
  const int x0 = (group % P.tiles_x) * P.tile_w, y0 = P.row0 + (group / P.tiles_x) * P.tile_h;
  const int cw = min(P.tile_w, P.width - x0), ch = min(P.tile_h, P.row0 + P.rows - y0);
  const int n_items = cw * ch * P.spp;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // lane j: pixel j's sum
  Lane s;
  for (int base = 0; base < n_items; base += SLOTS) {
    const int n_round = min(SLOTS, n_items - base);
    int next = 0;    // items of the round handed out (the same in every lane)
    int item = -1;   // this lane's item in the round; -1: idle
    for (;;) {
      const unsigned idle = __ballot_sync(FULL, item < 0);
      if (idle == FULL && next >= n_round) break;
      if (item < 0) {
        const int cand = next + __popc(idle & ((1u << lane) - 1u));
        if (cand < n_round) {
          item = cand;
          const int j = (base + item) / P.spp, k = base + item - j * P.spp;
          start_sample(P, s, x0 + j % cw, y0 + j / cw, k);
          if (STATS) cnt.v[ST_REGEN] += 1;
        }
      }
      next = min(n_round, next + __popc(idle));
      if (STATS) {
        const unsigned busy = __ballot_sync(FULL, item >= 0);
        if (lane == 0) {
          cnt.v[ST_LOOP] += 1;
          cnt.v[ST_LOOP_LANES] += unsigned(__popc(busy));
        }
      }
      if (item < 0) continue;
      // march until an event, one DDA substep at a time
      do {
        if (STATS) warp_tick(cnt.v[ST_MARCH_ISSUES], cnt.v[ST_MARCH_LANES]);
        if constexpr (STATS && MIP_U8) {   // the substep's pyramid level
          const int mip_i = int(rintf(s.mip));
#pragma unroll
          for (int m = 0; m < 4; ++m) cnt.v[ST_LEVEL0 + m] += mip_i == m ? 1u : 0u;
        }
        march_substep<USE_TF, MIP_U8>(P, T, K, s);
      } while (s.event == EV_NONE && s.steps < P.budget);
      if (s.event == EV_TEST) {
        if (STATS) {
          cnt.v[ST_TEST] += 1;
          cnt.v[ST_EMISSION] += HAS_EMI && s.mode == MODE_EXTEND ? 1u : 0u;
        }
        resolve_test<USE_TF, HAS_EMI>(P, T, s);
      }
      if (s.event == EV_EXT_HIT) {
        if (STATS) cnt.v[ST_NEE] += 1;
        nee<USE_TF, RGBE>(P, T, K, s);
      }
      float4 res;
      bool ended = false;
      if (s.event != EV_NONE) {
        const int ev = s.event;
        ended = finish<RGBE>(P, T, K, s, res);
        if (STATS) {
          cnt.v[ST_ESCAPE] += ev == EV_EXT_EXIT ? 1u : 0u;
          cnt.v[ST_SCATTER] += ev != EV_EXT_EXIT && !ended ? 1u : 0u;  // alive after a scatter event
        }
      }
      const bool capped = !ended && s.steps >= P.budget;
      if (ended || capped) {
        slot[item] = capped ? capped_slot() : res;
        if (STATS) {
          cnt.v[ST_MARCH] += unsigned(s.steps);
          cnt.v[ST_CAPPED] += capped ? 1u : 0u;
          cnt.v[ST_MAX_STEPS] = max(cnt.v[ST_MAX_STEPS], unsigned(s.steps));
        }
        item = -1;
      }
    }
    __syncwarp();
    if (lane < cw * ch) {
      const int lo = max(base, lane * P.spp), hi = min(base + n_round, (lane + 1) * P.spp);
      for (int i = lo; i < hi; ++i) {
        const float4 v = slot[i - base];
        if (v.w == v.w) {
          acc.x = acc.x + v.x;
          acc.y = acc.y + v.y;
          acc.z = acc.z + v.z;
          acc.w = acc.w + v.w;
        }
      }
    }
    __syncwarp();
  }
  if (lane < cw * ch)
    reinterpret_cast<float4*>(out)[size_t(y0 - P.row0 + lane / cw) * P.width + x0 + lane % cw] =
        acc;
}

// the groups a launch has handed out. Every warp takes groups until one
// fails, so a launch makes n_groups + (its warps) fetches; the last of
// them sets the counter back to 0 for the next launch on the stream.
__device__ int next_group = 0;

// persistent blocks: each warp takes groups from the one global counter
template <bool USE_TF, bool HAS_EMI, bool STATS, bool MIP_U8, int RGBE>
__global__ void __launch_bounds__(THREADS, min_blocks(USE_TF, HAS_EMI))
megakernel(const __grid_constant__ Params P, const __grid_constant__ Tables T,
           float* __restrict__ out, unsigned long long* __restrict__ stats,
           unsigned long long* __restrict__ btimes, const __grid_constant__ Packed K) {
  __shared__ float4 slots[WARPS][SLOTS];
  if (STATS && threadIdx.x == 0) btimes[2 * blockIdx.x] = globaltimer();
  if constexpr (MIP_U8) {
    if (threadIdx.x < 4)
      s_mip_dq[threadIdx.x] =
          make_float2(__ldg(K.mip_dq + threadIdx.x), __ldg(K.mip_dq + 4 + threadIdx.x));
    __syncthreads();
  }
  const int last_fetch = P.n_groups + int(gridDim.x) * WARPS - 1;
  Counters<MIP_U8 ? N_STATS_U8 : N_STATS> cnt;
  for (;;) {
    int group = 0;
    if ((threadIdx.x & 31) == 0) {
      group = atomicAdd(&next_group, 1);
      if (group == last_fetch) atomicExch(&next_group, 0);
    }
    group = __shfl_sync(FULL, group, 0);
    if (group >= P.n_groups) break;
    render_group<USE_TF, HAS_EMI, STATS, MIP_U8, RGBE>(P, T, K, out, group,
                                                      slots[threadIdx.x >> 5], cnt);
  }
  if (STATS) cnt.flush(stats, btimes);
}

// the group tile of a dispatch: G = the least power of two with G * spp >=
// 32 (at most 32) pixels, as near square as a power-of-two split allows
void group_tile(int spp, int& tile_w, int& tile_h) {
  int g = 1, lg = 0;
  while (g < 32 && g * spp < 32) { g *= 2; ++lg; }
  tile_w = 1 << ((lg + 1) / 2);
  tile_h = g / tile_w;
}

int n_groups(int width, int rows, int spp) {
  int tw, th;
  group_tile(spp, tw, th);
  return ((width + tw - 1) / tw) * ((rows + th - 1) / th);
}

using Kernel = void (*)(const Params, const Tables, float*, unsigned long long*,
                       unsigned long long*, const Packed);

// the instantiations of one <MIP_U8, RGBE>: [use_tf][has_emi][stats]
template <bool MIP_U8, int RGBE>
Kernel pick_variant(bool use_tf, bool has_emi, bool stats) {
  const Kernel k[2][2][2] = {
      {{megakernel<false, false, false, MIP_U8, RGBE>, megakernel<false, false, true, MIP_U8, RGBE>},
       {megakernel<false, true, false, MIP_U8, RGBE>, megakernel<false, true, true, MIP_U8, RGBE>}},
      {{megakernel<true, false, false, MIP_U8, RGBE>, megakernel<true, false, true, MIP_U8, RGBE>},
       {megakernel<true, true, false, MIP_U8, RGBE>, megakernel<true, true, true, MIP_U8, RGBE>}}};
  return k[use_tf][has_emi][stats];
}

// the f32 tables' instantiations, or a packed one: all three packs at
// compile time (volren_tpu's default), the u8 pyramid with the RGBE reads
// under their flags (the u8 pyramid alone or with one RGBE read), or the
// f32 pyramid with the RGBE reads under their flags
Kernel pick_kernel(bool use_tf, bool has_emi, int packs, bool stats) {
  const bool mip_u8 = packs & PACK_MIP_U8;
  const int rgbe = packs & (PACK_ENV_RGBE | PACK_POOL_RGBE);
  if (mip_u8)
    return rgbe == (PACK_ENV_RGBE | PACK_POOL_RGBE)
               ? pick_variant<true, RGBE_ALL>(use_tf, has_emi, stats)
               : pick_variant<true, RGBE_FLAGS>(use_tf, has_emi, stats);
  return rgbe ? pick_variant<false, RGBE_FLAGS>(use_tf, has_emi, stats)
              : pick_variant<false, RGBE_OFF>(use_tf, has_emi, stats);
}

// ---- the RGBE encode of the packed tables' texels and pool radiance
// (pack.rgbe_encode_plain, bitwise): volren_tpu.ops.pallas.pack.rgbe_encode
// as XLA computes it on the CPU, its log2 and exp2 XLA's Cephes polynomials
// (xla/backends/cpu/codegen/polynomial_approximations.cc) with the
// multiply-adds that XLA contracts as explicit FMAs, every other operation
// rounded on its own (-fmad=false)

constexpr float LN2_F = float(0.69314718055994530942);
constexpr float INV_LN2_F = 1.0f / LN2_F;   // jnp.log2's divisor as XLA folds it

// XLA's log for positive normal x
__device__ __forceinline__ float xla_log(float x) {
  float t0 = vmax(x, __uint_as_float(0x00800000u));
  const uint32_t bits = __float_as_uint(t0);
  const int emm0 = int(bits >> 23) - 0x7f;
  t0 = __uint_as_float((bits & ~0x7f800000u) | 0x3f000000u);   // the mantissa in [0.5, 1)
  float e = 1.0f + float(emm0);
  const bool small = t0 < 0.707106781186547524f;
  const float t1 = small ? t0 : 0.0f;
  t0 = t0 - 1.0f;
  e = e - (small ? 1.0f : 0.0f);
  t0 = t0 + t1;
  const float x2 = t0 * t0, x3 = x2 * t0;
  float y = __fmaf_rn(t0, 7.0376836292e-2f, -1.1514610310e-1f);
  float y1 = __fmaf_rn(t0, -1.2420140846e-1f, 1.4249322787e-1f);
  float y2 = __fmaf_rn(t0, 2.0000714765e-1f, -2.4999993993e-1f);
  y = __fmaf_rn(y, t0, 1.1676998740e-1f);
  y1 = __fmaf_rn(y1, t0, -1.6668057665e-1f);
  y2 = __fmaf_rn(y2, t0, 3.3333331174e-1f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, -2.12194440e-4f * e);
  t0 = __fmaf_rn(-0.5f, x2, t0);
  t0 = t0 + y;
  return __fmaf_rn(0.693359375f, e, t0);
}

// XLA's exp
__device__ __forceinline__ float xla_exp(float x) {
  x = vmin(vmax(x, -87.8f), 88.8f);
  const float n = vmin(vmax(floorf(__fmaf_rn(x, 1.44269504088896341f, 0.5f)), -127.0f), 127.0f);
  x = __fmaf_rn(-0.693359375f, n, x);
  x = __fmaf_rn(2.12194440e-4f, n, x);
  float z = __fmaf_rn(x, 1.9875691500e-4f, 1.3981999507e-3f);
  z = __fmaf_rn(z, x, 8.3334519073e-3f);
  z = __fmaf_rn(z, x, 4.1665795894e-2f);
  z = __fmaf_rn(z, x, 1.6666665459e-1f);
  z = __fmaf_rn(z, x, 5.0000001201e-1f);
  z = 1.0f + __fmaf_rn(z, x * x, x);
  return z * __int_as_float((int(n) + 127) << 23);
}

__device__ __forceinline__ uint32_t rgbe_encode(float r, float g, float b) {
  r = vmax(r, 0.0f);
  g = vmax(g, 0.0f);
  b = vmax(b, 0.0f);
  const float m = vmax(vmax(r, g), b);
  const int e = clampi(int(floorf(xla_log(vmax(m, 1e-37f)) * INV_LN2_F)), -119, 119);
  const float scale = xla_exp((7.0f - float(e)) * LN2_F);
  const uint32_t mr = uint32_t(vmin(rintf(r * scale), 255.0f));
  const uint32_t mg = uint32_t(vmin(rintf(g * scale), 255.0f));
  const uint32_t mb = uint32_t(vmin(rintf(b * scale), 255.0f));
  const uint32_t word = mr | (mg << 8) | (mb << 16) | (uint32_t(e + 128) << 24);
  return m >= 0x1p-119f ? word : 0u;
}

// `n` rows of `stride` floats from `rows`: the word of each row's 3 floats
// from column `col`, and, where `head` is not null, the row's first 4
// floats copied to head (a packed pool's [w, pdf] rows before its words)
__global__ void rgbe_encode_rows(const float* __restrict__ rows, long long stride, int col,
                                 uint32_t* __restrict__ words, float* __restrict__ head,
                                 long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float* r = rows + i * stride;
    words[i] = rgbe_encode(r[col], r[col + 1], r[col + 2]);
    if (head != nullptr)
      for (int k = 0; k < 4; ++k) head[4 * i + k] = r[k];
  }
}

// the RGBE decode of the escape and of the NEE on `n` words (the card's
// tests hold it to pack.rgbe_decode on every word)
__global__ void rgbe_decode_words(const uint32_t* __restrict__ words, float* __restrict__ out,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float c[3];
    rgbe_decode(words[i], c);
    out[3 * i] = c[0];
    out[3 * i + 1] = c[1];
    out[3 * i + 2] = c[2];
  }
}

// ---- the NEE pool's draw (pack.env_pool_plain, bitwise): replaces
// volren_tpu/ops/pallas/pack.py:413-437 (build_env_pool) with
// volren_tpu/ops/envmap.py:149-195 (sample_environment_alias), XLA device
// code with no pallas_call. One thread a sample: the alias row picked by the
// first uniform, the texel kept or aliased by the second, the in-texel
// jitter, the equirect direction rotated by the sky's transform (written
// out, as geometry.matvec orders it) and the texel's radiance times the
// strength, in the plain version's operation order. It writes the
// (n, 8) float32 pool [w, pdf, le, 0] or, packed, n float4 [w, pdf] rows
// and then n RGBE words of the radiance (the layout volren_render reads
// under PACK_POOL_RGBE), so a packed pool needs no encode launch. The
// transform, strength and table size come as kernel arguments: nothing is
// copied for them. Bound by bytes: 8 B of uniforms and a 40 B alias row
// read, 32 B (20 B packed) written a sample, 1.3 MB for 16,384 samples,
// 0.4 us at 3.35 TB/s; in practice by its launch.

constexpr float PI_F = float(PI_D);

struct PoolXform {
  float m[9];   // the sky's (3, 3) transform, row-major
};

__global__ void __launch_bounds__(128)
env_pool_draw(const float2* __restrict__ u2, const float* __restrict__ alias, int n_alias,
              int dim, float inv_dim, PoolXform X, float strength, float4* __restrict__ rows,
              uint32_t* __restrict__ words, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2 u = __ldg(u2 + i);
  const float scaled = u.x * float(n_alias);
  const int j = clampi(int(scaled), 0, n_alias - 1);
  const float frac_x = scaled - float(j);
  const float* row = alias + 10LL * j;
  const float prob = __ldg(row);
  const bool keep = u.y < prob;
  const int texel = keep ? j : int(__ldg(row + 1));
  const float pdf = __ldg(row + (keep ? 2 : 3));
  const float* rgb = row + (keep ? 4 : 7);
  const float frac_y = keep ? u.y / vmax(prob, 1e-12f) : (u.y - prob) / vmax(1.0f - prob, 1e-12f);
  const int px = texel % dim, py = texel / dim;
  const float uv_x = (float(px) + frac_x) * inv_dim;
  const float uv_y = (float(py) + vmin(vmax(frac_y, 0.0f), 1.0f)) * inv_dim;
  const float theta = vmin(vmax(1.0f - uv_y, 0.0f), 1.0f) * PI_F;
  const float phi = (vmin(vmax(uv_x, 0.0f), 1.0f) * 2.0f - 1.0f) * PI_F;
  const float sin_t = sinf(theta);
  const float local[3] = {sin_t * cosf(phi), cosf(theta), sin_t * sinf(phi)};
  float w[3];
  mat3_vec(X.m, local, w);
  const float le[3] = {strength * __ldg(rgb), strength * __ldg(rgb + 1),
                       strength * __ldg(rgb + 2)};
  if (words != nullptr) {
    rows[i] = make_float4(w[0], w[1], w[2], pdf);
    words[i] = rgbe_encode(le[0], le[1], le[2]);
  } else {
    rows[2 * i] = make_float4(w[0], w[1], w[2], pdf);
    rows[2 * i + 1] = make_float4(le[0], le[1], le[2], 0.0f);
  }
}

// ---- the TF majorant's bake (pack.bake_tf_majorant_plain, bitwise):
// replaces volren_tpu/renderer.py:427-439 through
// volren_tpu/ops/transfer.py:26 (tf_alpha_majorant, onehot=False), XLA
// device code with no pallas_call. Each entry of the flat raw majorant
// pyramid becomes majorant * the lerped LUT alpha at density_scale * raw *
// inv_majorant, in the plain version's operation order, the window and the
// lerp those of K2's fetch (tf_bin, tf_lerp). One thread an entry; the
// LUT's alpha column by __ldg (a few hundred entries at most: it stays in
// L1). The trace's scalars come as kernel arguments, so nothing is copied
// and the host does not wait. Bound by bytes: 8 B an entry, 1.2 MB for
// cloud512's 149,760 entries, 0.36 us at 3.35 TB/s; in practice by its
// launch.

struct TfBake {
  float density_scale, inv_majorant, majorant, left, width;
  int size;
};

__global__ void __launch_bounds__(256)
tf_majorant_bake(const float* __restrict__ mip, const float* __restrict__ lut, TfBake B,
                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float d = B.density_scale * __ldg(mip + i) * B.inv_majorant;
  const TfBin b = tf_bin(d, B.left, B.width, B.size);
  out[i] = B.majorant * tf_lerp(__ldg(lut + 4 * b.idx + 3), __ldg(lut + 4 * b.idx1 + 3), b.fr);
}

// ---- the u8 majorant pyramid's build (pack.build_mip_u8, bitwise):
// volren_tpu.ops.pallas.pack.build_mip_u8, which XLA runs as device code
// with no pallas_call (_build_mip_u8_jit, volren_tpu/ops/pallas/pack.py:361-384).
// Per level: its min and max, scale = (max - min) * f32(1/254.99), each
// entry's byte ceil((v - min) / max(scale, 1e-37)) clamped to [0, 255] and
// bumped by one where min + q * scale, as one FMA (XLA's contraction), is
// still below v, and the levels' (min, scale) as the (2, 4) rows the
// megakernel reads.
//
// Bound by bytes: 5 B an entry, 0.75 MB for cloud512, 0.22 us at 3.35
// TB/s. What holds it is the reduction across blocks before any byte can
// be written. The design: one cooperative launch of one 1024-thread block
// an SM, each block a contiguous run of the table. Each thread loads its
// entries once, a quad of 4 at a time (one 16-byte load where the table is
// aligned), into registers (MIPQ_QUADS quads; a pyramid larger than the
// grid's registers hold folds the rest as it streams them and reads them
// again, from L2, to quantise them), and folds each level's (min, max):
// min and max do not depend on the order, and vmin / vmax propagate a NaN
// as the plain version's do. A warp folds a value with one reduction
// instruction on order-preserving keys (a warp with no entry skips it), a
// block in shared memory, a warp a column; each block writes its 8
// partials to a static table (no allocation), the grid syncs once, and a
// warp a column folds every block's partials, each lane loading its share
// at once. Then each thread quantises its registers and stores a quad's 4
// bytes as one word. The quantise runs on every SM: a single thread block
// cluster (16 SMs, distributed shared memory, no grid sync) measured
// slower, its division-bound quantise too much for 16 SMs (PERF.md section
// 6). Two builds on two streams must not overlap: they share the partials'
// table.

namespace cg = cooperative_groups;
constexpr int MIPQ_THREADS = 1024;
constexpr int MIPQ_QUADS = 3;                 // quads a thread holds in registers
constexpr int MIPQ_MAX_BLOCKS = 1024;         // the partials' table, in blocks
constexpr float INV_25499 = float(1.0 / 254.99);

struct MipLevels {
  int off[4], n[4];                 // one after another from 0
};

// the quad of entries [e, e + 4) of the table (times `factor` where
// `scaled`); entries from n on read as 0 and are neither folded nor stored
__device__ __forceinline__ float4 mipq_load(const float* __restrict__ mip, int e, int n, bool vec,
                                            float factor, int scaled) {
  float4 v;
  if (vec && e + 4 <= n) {
    v = __ldg(reinterpret_cast<const float4*>(mip + e));
  } else {
    v.x = __ldg(mip + e);
    v.y = e + 1 < n ? __ldg(mip + e + 1) : 0.0f;
    v.z = e + 2 < n ? __ldg(mip + e + 2) : 0.0f;
    v.w = e + 3 < n ? __ldg(mip + e + 3) : 0.0f;
  }
  if (scaled) {
    v.x = v.x * factor;
    v.y = v.y * factor;
    v.z = v.z * factor;
    v.w = v.w * factor;
  }
  return v;
}

__device__ __forceinline__ int mipq_level(const MipLevels& L, int e) {
  return (e >= L.off[1]) + (e >= L.off[2]) + (e >= L.off[3]);
}

__device__ __forceinline__ void mipq_merge(int m, float a, float b, float lo[4], float hi[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (m == k) {
      lo[k] = vmin(lo[k], a);
      hi[k] = vmax(hi[k], b);
    }
  }
}

// fold the quad [e, e + 4) into its levels' (min, max): a quad inside one
// level (all but the few that straddle a level's end) folds its own 4
// values first and merges once
__device__ __forceinline__ void mipq_fold4(const MipLevels& L, int e, int n, float4 v,
                                           float lo[4], float hi[4]) {
  const int m = mipq_level(L, e);
  if (e + 3 < n && mipq_level(L, e + 3) == m) {
    mipq_merge(m, vmin(vmin(v.x, v.y), vmin(v.z, v.w)), vmax(vmax(v.x, v.y), vmax(v.z, v.w)),
               lo, hi);
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e + j < n) mipq_merge(mipq_level(L, e + j), w[j], w[j], lo, hi);
  }
}

// an entry's byte under its level's (min, scale). An entry at its level's
// minimum (most of a sparse volume's) keeps the quotient 0, what 0 / x
// gives for the positive divisor; it divides the divisor by itself in its
// place, as a zero dividend would take the division's slow path.
__device__ __forceinline__ uint32_t mipq_byte(float v, float lo, float sc) {
  const float x = v - lo, den = vmax(sc, 1e-37f);
  const bool zero = x == 0.0f;
  const float quot = (zero ? den : x) / den;
  float qf = sc > 0.0f && !zero ? ceilf(quot) : 0.0f;
  qf = vmin(vmax(qf, 0.0f), 255.0f);
  qf = vmin(vmax(__fmaf_rn(qf, sc, lo) < v ? qf + 1.0f : qf, 0.0f), 255.0f);
  return uint32_t(uint8_t(qf));
}

// the quad's bytes, its levels' (min, scale) from shared memory: one word
// where the quad is whole and the table word-aligned, else byte by byte
__device__ __forceinline__ void mipq_store4(const MipLevels& L, int e, int n, float4 v, bool word,
                                            const float* lvl_lo, const float* lvl_sc,
                                            uint8_t* __restrict__ q) {
  const int m = mipq_level(L, e);
  if (word && e + 3 < n && mipq_level(L, e + 3) == m) {
    const float lo = lvl_lo[m], sc = lvl_sc[m];
    *reinterpret_cast<uint32_t*>(q + e) = mipq_byte(v.x, lo, sc) | (mipq_byte(v.y, lo, sc) << 8) |
                                          (mipq_byte(v.z, lo, sc) << 16) |
                                          (mipq_byte(v.w, lo, sc) << 24);
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e + j < n) {
      const int mj = mipq_level(L, e + j);
      q[e + j] = uint8_t(mipq_byte(w[j], lvl_lo[mj], lvl_sc[mj]));
    }
  }
}

// column k of a block's rows of (min[4], max[4]) folds by min (k < 4) or max
__device__ __forceinline__ float mipq_col(int k, float a, float b) {
  return k < 4 ? vmin(a, b) : vmax(a, b);
}

// a float's unsigned key in the order of the floats (-0 below +0; not for
// a NaN), and back
__device__ __forceinline__ uint32_t mipq_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float mipq_unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the warp's fold of x in column k: one reduction instruction on the keys,
// and a NaN where a lane holds one, as vmin / vmax propagate it
__device__ __forceinline__ float mipq_warp_col(int k, float x) {
  if (__any_sync(0xffffffffu, x != x)) return __int_as_float(0x7fffffff);
  const uint32_t key = mipq_key(x);
  return mipq_unkey(k < 4 ? __reduce_min_sync(0xffffffffu, key)
                          : __reduce_max_sync(0xffffffffu, key));
}

// each block's (min[4], max[4]), a column a row
__device__ float mipq_part[8][MIPQ_MAX_BLOCKS];

__global__ void __launch_bounds__(MIPQ_THREADS, 1)
mip_u8_build(const float* __restrict__ mip, float factor, int scaled, MipLevels L,
             uint8_t* __restrict__ q, float* __restrict__ dq) {
  const int n = L.off[3] + L.n[3], quads = (n + 3) >> 2;
  const int per = (quads + int(gridDim.x) - 1) / int(gridDim.x);    // a block's run of quads
  const int c0 = int(blockIdx.x) * per + int(threadIdx.x), c1 = min(quads, (int(blockIdx.x) + 1) * per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(mip) & 15) == 0;
  const bool word = (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  float lo[4], hi[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    lo[m] = __int_as_float(0x7f800000);
    hi[m] = -__int_as_float(0x7f800000);
  }
  float4 v[MIPQ_QUADS];
#pragma unroll
  for (int j = 0; j < MIPQ_QUADS; ++j) {
    const int c = c0 + j * MIPQ_THREADS;
    if (c < c1) v[j] = mipq_load(mip, 4 * c, n, vec, factor, scaled);
  }
#pragma unroll
  for (int j = 0; j < MIPQ_QUADS; ++j) {
    const int c = c0 + j * MIPQ_THREADS;
    if (c < c1) mipq_fold4(L, 4 * c, n, v[j], lo, hi);
  }
  for (int c = c0 + MIPQ_QUADS * MIPQ_THREADS; c < c1; c += MIPQ_THREADS)
    mipq_fold4(L, 4 * c, n, mipq_load(mip, 4 * c, n, vec, factor, scaled), lo, hi);

  __shared__ float red[MIPQ_THREADS / 32][8];
  __shared__ float lohi[8];
  __shared__ float lvl_lo[4], lvl_sc[4];
  // a warp with no quad (most of a block's at cloud512's size) keeps the
  // identities and skips its folds
  if (int(blockIdx.x) * per + warp * 32 < c1) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      lo[m] = mipq_warp_col(m, lo[m]);
      hi[m] = mipq_warp_col(4 + m, hi[m]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      red[warp][m] = lo[m];
      red[warp][4 + m] = hi[m];
    }
  }
  __syncthreads();
  // warp k < 8 folds column k: the block's 32 warps' rows, a row a lane,
  // then, after the grid's sync, every block's partial, a share a lane
  const int k = warp;
  if (k < 8) {
    const float x = mipq_warp_col(k, red[lane < MIPQ_THREADS / 32 ? lane : 0][k]);
    if (lane == 0) mipq_part[k][blockIdx.x] = x;
  }
  cg::this_grid().sync();
  if (k < 8) {
    // a lane's share of the partials, loaded before any is folded (5 a
    // lane cover 160 blocks), then the rest
    float y[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int b = lane + 32 * i;
      y[i] = __ldcg(&mipq_part[k][b < int(gridDim.x) ? b : 0]);
    }
    float x = y[0];
#pragma unroll
    for (int i = 1; i < 5; ++i) x = mipq_col(k, x, y[i]);
    for (int b = lane + 160; b < int(gridDim.x); b += 32) x = mipq_col(k, x, __ldcg(&mipq_part[k][b]));
    x = mipq_warp_col(k, x);
    if (lane == 0) lohi[k] = x;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int m = threadIdx.x;
    const float l = lohi[m], sc = (lohi[4 + m] - l) * INV_25499;
    lvl_lo[m] = l;
    lvl_sc[m] = sc;
    if (blockIdx.x == 0) {
      dq[m] = l;
      dq[4 + m] = sc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MIPQ_QUADS; ++j) {
    const int c = c0 + j * MIPQ_THREADS;
    if (c < c1) mipq_store4(L, 4 * c, n, v[j], word, lvl_lo, lvl_sc, q);
  }
  for (int c = c0 + MIPQ_QUADS * MIPQ_THREADS; c < c1; c += MIPQ_THREADS)
    mipq_store4(L, 4 * c, n, mipq_load(mip, 4 * c, n, vec, factor, scaled), word, lvl_lo,
                lvl_sc, q);
}

int mipq_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms < MIPQ_MAX_BLOCKS ? sms : MIPQ_MAX_BLOCKS;
  }();
  return blocks;
}

}  // namespace

// The launch's block count for a band of `rows` rows: as many blocks as fit
// on the card at once (asked once per instantiation), and no more than the
// groups need. Any count renders the same image. The STATS instantiation
// writes a (start, end) pair of %globaltimer per block.
extern "C" int volren_launch_blocks(int width, int rows, int spp, int use_tf, int has_emi,
                                    int packs, int stats) {
  static int resident[2][2][8][2] = {};
  int& fit = resident[use_tf != 0][has_emi != 0][packs & 7][stats != 0];
  if (fit == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pick_kernel(use_tf, has_emi, packs, stats), THREADS, 0);
    fit = sms * per_sm;
  }
  const int need = (n_groups(width, rows, spp) + WARPS - 1) / WARPS;
  return fit < need ? fit : need;
}

// `words` (n) uint32 = the RGBE encode of the 3 floats from column `col` of
// `n` rows `stride` floats apart at `rows` (pack_scene's texels; a
// dispatch's pool radiance), and where `head` is not null the rows' first 4
// floats into head, (n, 4) (the packed pool's [w, pdf] rows), on `stream`.
extern "C" int volren_rgbe_encode(const void* rows, long long stride, int col, void* words,
                                  void* head, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  rgbe_encode_rows<<<int(blocks < 65536 ? blocks : 65536), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, col, static_cast<uint32_t*>(words),
      static_cast<float*>(head), n);
  return int(cudaGetLastError());
}

// `pool` = the NEE pool of the `n` (u0, u1) float32 pairs at `u2` over the
// (n_alias, 10) float32 alias rows at `alias` (a dim x dim importance map),
// the sky's row-major (3, 3) `xform` (host memory, passed by value) and
// `strength`: (n, 8) float32 rows, or with `packed` n float4 [w, pdf] rows
// followed by n RGBE words; one launch on `stream`.
extern "C" int volren_env_pool(const void* u2, const void* alias, int n_alias, int dim,
                               const float* xform, float strength, void* pool, int packed, int n,
                               void* stream) {
  if (n <= 0) return 0;
  if (n_alias <= 0 || dim <= 0) return int(cudaErrorInvalidValue);
  PoolXform X;
  for (int k = 0; k < 9; ++k) X.m[k] = xform[k];
  float4* rows = static_cast<float4*>(pool);
  env_pool_draw<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(u2), static_cast<const float*>(alias), n_alias, dim,
      float(1.0 / double(dim)), X, strength, rows,
      packed ? reinterpret_cast<uint32_t*>(rows + n) : nullptr, n);
  return int(cudaGetLastError());
}

// `q` (M,) uint8 and `dq` (2, 4) float32 = the u8 pyramid of the flat
// float32 pyramid `mip` (times `factor` where `scaled`) of M entries, its 4
// levels `counts[m]` entries from `offsets[m]`, one after another from 0
// (scene.upload_grid's layout), in one cooperative launch on `stream`: no
// scratch allocated, no host round trip.
extern "C" int volren_build_mip_u8(const void* mip, float factor, int scaled, const int* offsets,
                                   const int* counts, void* q, void* dq, void* stream) {
  MipLevels L;
  long long n = 0;
  for (int m = 0; m < 4; ++m) {
    if (counts[m] <= 0 || offsets[m] != n) return int(cudaErrorInvalidValue);
    L.off[m] = offsets[m];
    L.n[m] = counts[m];
    n += counts[m];
  }
  if (n > 0x7ffffff0LL) return int(cudaErrorInvalidValue);
  const float* mip_p = static_cast<const float*>(mip);
  uint8_t* q_p = static_cast<uint8_t*>(q);
  float* dq_p = static_cast<float*>(dq);
  void* args[] = {&mip_p, &factor, &scaled, &L, &q_p, &dq_p};
  return int(cudaLaunchCooperativeKernel(mip_u8_build, dim3(mipq_blocks()), dim3(MIPQ_THREADS),
                                         args, 0, static_cast<cudaStream_t>(stream)));
}

// `out` (n,) float32 = the TF majorant table of the flat raw pyramid `mip`
// (n entries) through the alpha column of the (size, 4) float32 LUT `lut`
// under the window (left, width), with the trace's density_scale,
// inv_majorant and majorant passed by value, in one launch on `stream`.
extern "C" int volren_bake_tf_majorant(const void* mip, const void* lut, int size,
                                       float density_scale, float inv_majorant, float majorant,
                                       float left, float width, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  if (size <= 0) return int(cudaErrorInvalidValue);
  const TfBake B = {density_scale, inv_majorant, majorant, left, width, size};
  tf_majorant_bake<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mip), static_cast<const float*>(lut), B, static_cast<float*>(out),
      n);
  return int(cudaGetLastError());
}

// `out` (n, 3) float32 = the decode of `words` (n) uint32, on `stream`.
extern "C" int volren_rgbe_decode(const void* words, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  rgbe_decode_words<<<int(blocks < 65536 ? blocks : 65536), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n);
  return int(cudaGetLastError());
}

// Host entry, bound with ctypes. `pf` / `pi` are HOST arrays (the parameter
// block of pack.build_params); every other pointer is device memory. `out`
// holds the band's pixels, pi[PI_ROWS] x pi[PI_WIDTH], rows from
// pi[PI_ROW0] (`n_pix` of them). The
// parameter block selects the variant: pi[PI_TF_SIZE] > 0 needs `tf_lut`
// (and `mip` is then the TF-baked table), pi[PI_EMI_N_SLOTS] > 0 needs the
// four emission tables; pointers of an absent variant may be null. `packs`
// (PACK_* bits) says which tables are packed: PACK_MIP_U8 makes `mip` the
// (M,) u8 pyramid (pi[PI_MIP_U8] must be 1, its (2, 4) float32 (lo, scale)
// rows in device memory at `mip_dq`), PACK_ENV_RGBE makes `env` the (H*W,)
// RGBE words, PACK_POOL_RGBE makes `pool` POOL_N float4 [w, pdf] rows
// followed by POOL_N words. The launch goes on `stream`, and launches on two
// streams must not overlap (they share the group counter); returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a missing table. A non-null `stats` launches the
// STATS instantiation instead: it adds the counters (N_STATS u64) into
// `stats` and writes each block's (start, end) into `btimes`
// (2 x volren_launch_blocks u64, zeroed by the caller); the image is the same.
extern "C" int volren_render(const float* pf, const int* pi, const void* atlas,
                             const void* slot, const void* lo, const void* hi,
                             const void* mip, const void* mip_dq, const void* env,
                             const void* pool,
                             const void* tf_lut, const void* emi_atlas,
                             const void* emi_slot, const void* emi_lo,
                             const void* emi_hi, void* out, void* stats,
                             void* btimes, int packs, int n_pix, void* stream) {
  if (n_pix <= 0) return 0;
  Params P;
  for (int k = 0; k < 3; ++k) {
    P.cam_pos[k] = pf[PF_CAM_POS + k];
    P.bb_min[k] = pf[PF_BB_MIN + k];
    P.bb_max[k] = pf[PF_BB_MAX + k];
    P.albedo[k] = pf[PF_ALBEDO + k];
  }
  for (int k = 0; k < 9; ++k) {
    P.cam_m[k] = pf[PF_CAM_XFORM + k];
    P.env_inv[k] = pf[PF_ENV_INV + k];
  }
  for (int k = 0; k < 16; ++k) {
    P.inv_x[k] = pf[PF_INV_XFORM + k];
    P.emi_x[k] = pf[PF_EMI_X + k];
  }
  P.z_cam = pf[PF_ZCAM];
  P.phase_g = pf[PF_PHASE_G];
  P.density_scale = pf[PF_DENSITY_SCALE];
  P.env_strength = pf[PF_ENV_STRENGTH];
  P.imp_avg = pf[PF_IMP_AVG];
  P.majorant = pf[PF_MAJORANT];
  P.inv_majorant = pf[PF_INV_MAJORANT];
  P.tf_left = pf[PF_TF_LEFT];
  P.tf_width = pf[PF_TF_WIDTH];
  P.emi_scale = pf[PF_EMI_SCALE];
  P.emi_norm = pf[PF_EMI_NORM];
  P.show_env = pf[PF_SHOW_ENV] > 0.0f ? 1 : 0;
  P.width = pi[PI_WIDTH];
  P.height = pi[PI_HEIGHT];
  P.spp_base = pi[PI_SPP_BASE];
  P.bounces = pi[PI_BOUNCES];
  P.seed = uint32_t(pi[PI_SEED]);
  P.spp = pi[PI_SPP];
  P.env_h = pi[PI_ENV_H];
  P.env_w = pi[PI_ENV_W];
  for (int k = 0; k < 12; ++k) P.mip_dims[k] = pi[PI_MIP_DIMS + k];
  for (int k = 0; k < 4; ++k) P.mip_offsets[k] = pi[PI_MIP_OFFSETS + k];
  P.budget = pi[PI_MAX_ITERS];
  P.tf_size = pi[PI_TF_SIZE];
  P.row0 = pi[PI_ROW0];
  P.rows = pi[PI_ROWS];
  if (P.row0 < 0 || P.rows < 0 || P.row0 + P.rows > P.height || n_pix != P.rows * P.width ||
      (packs & ~7) != 0 || ((packs & PACK_MIP_U8) != 0) != (pi[PI_MIP_U8] != 0) ||
      ((packs & PACK_MIP_U8) != 0 && mip_dq == nullptr))
    return int(cudaErrorInvalidValue);
  group_tile(P.spp, P.tile_w, P.tile_h);
  P.tiles_x = (P.width + P.tile_w - 1) / P.tile_w;
  P.n_groups = n_groups(P.width, P.rows, P.spp);
  Tables T;
  T.dens = {static_cast<const uint8_t*>(atlas), static_cast<const int*>(slot),
            static_cast<const float*>(lo), static_cast<const float*>(hi),
            pi[PI_N_BRICKS], pi[PI_N_BRICKS + 1], pi[PI_N_BRICKS + 2], pi[PI_N_SLOTS]};
  T.emi = {static_cast<const uint8_t*>(emi_atlas), static_cast<const int*>(emi_slot),
           static_cast<const float*>(emi_lo), static_cast<const float*>(emi_hi),
           pi[PI_EMI_N_BRICKS], pi[PI_EMI_N_BRICKS + 1], pi[PI_EMI_N_BRICKS + 2],
           pi[PI_EMI_N_SLOTS]};
  T.mip = static_cast<const float*>(mip);
  T.env = static_cast<const float*>(env);
  T.pool = static_cast<const float*>(pool);
  T.tf_lut = static_cast<const float*>(tf_lut);
  Packed K;
  K.mip_u8 = static_cast<const uint8_t*>(mip);
  K.mip_dq = static_cast<const float*>(mip_dq);
  K.env_rgbe = static_cast<const uint32_t*>(env);
  K.pool_le = static_cast<const uint32_t*>(pool) + 4 * POOL_N;
  K.env_on = (packs & PACK_ENV_RGBE) ? 1 : 0;
  K.pool_on = (packs & PACK_POOL_RGBE) ? 1 : 0;
  const bool use_tf = P.tf_size > 0, has_emi = T.emi.n_slots > 0;
  if ((use_tf && !tf_lut) ||
      (has_emi && !(emi_atlas && emi_slot && emi_lo && emi_hi)) || (stats && !btimes))
    return int(cudaErrorInvalidValue);
  const Kernel kernel = pick_kernel(use_tf, has_emi, packs, stats != nullptr);
  kernel<<<volren_launch_blocks(P.width, P.rows, P.spp, use_tf, has_emi, packs, stats != nullptr),
           THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, T, static_cast<float*>(out), static_cast<unsigned long long*>(stats),
      static_cast<unsigned long long*>(btimes), K);
  return int(cudaGetLastError());
}
