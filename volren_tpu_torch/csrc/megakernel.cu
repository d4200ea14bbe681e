// The volume path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces volren_tpu/ops/pallas/kernel.py:602 (_make_kernel) in all four
// of its scene variants (in both its VMEM-atlas and HBM-atlas modes): the
// no-TF, no-emission kernel, the TF variant (`use_tf`, kernel.py:635) and
// the emission variant (`has_emi`, kernel.py:636), here the template
// parameters USE_TF and HAS_EMI. For every pixel, `spp` full volumetric
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
              PI_EMI_N_BRICKS = 30, PI_EMI_N_SLOTS = 33, PI_ROW0 = 34, PI_ROWS = 35;
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

// ---- the STATS instantiation's counters (never launched by the render
// path): per dispatch, warp-level loop and march-substep issues with the
// active lanes summed over them (their ratio is the SIMT efficiency), the
// lanes that ran each of render_plain's events (regen, march, test,
// emission, nee, escape, scatter; render_plain(stats=) counts the same),
// capped samples, the most march substeps of a sample, and each block's
// start and end on %globaltimer
enum { ST_LOOP = 0, ST_LOOP_LANES, ST_MARCH_ISSUES, ST_MARCH_LANES, ST_REGEN, ST_MARCH,
       ST_TEST, ST_EMISSION, ST_NEE, ST_ESCAPE, ST_SCATTER, ST_CAPPED, ST_MAX_STEPS, N_STATS };

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

struct Counters {
  unsigned v[N_STATS] = {};
  // sum (max) over the lanes converged here, one atomic per counter, and
  // the block's end time
  __device__ __forceinline__ void flush(unsigned long long* stats,
                                        unsigned long long* btimes) const {
    const unsigned m = __activemask();
    const bool leader = int(threadIdx.x & 31) == __ffs(m) - 1;
    for (int k = 0; k < N_STATS; ++k) {
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

template <bool USE_TF>
__device__ __forceinline__ float majorant_at(const Params& P, const Tables& T,
                                             const float c[3], int mip_i) {
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

// windowed, lerped LUT fetch (ops/transfer.py, common.glsl:195-212) of
// channels [c0, c0 + n) at normalised density d
__device__ __forceinline__ void tf_channels(const Params& P, const float* __restrict__ lut,
                                            float d, int c0, int n, float out[]) {
  const float tc = vmin(vmax((d - P.tf_left) / P.tf_width, 0.0f), TF_WINDOW_MAX) *
                   float(P.tf_size);
  const int idx = clampi(int(floorf(tc)), 0, P.tf_size - 1);
  const float fr = tc - float(idx);
  const int idx1 = min(idx + 1, P.tf_size - 1);
  for (int k = 0; k < n; ++k)
    out[k] = lut[4 * idx + c0 + k] * (1.0f - fr) + lut[4 * idx1 + c0 + k] * fr;
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
template <bool USE_TF>
__device__ __forceinline__ void march_substep(const Params& P, const Tables& T, Lane& s) {
  const bool is_extend = s.mode == MODE_EXTEND;
  float curr[3];
  for (int k = 0; k < 3; ++k) curr[k] = s.i0[k] + s.t * s.id[k];
  const int mip_i = int(rintf(s.mip));   // round half to even
  const float maj = majorant_at<USE_TF>(P, T, curr, mip_i);
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

// next-event estimation from the alias pool (phase_nee)
template <bool USE_TF>
__device__ __forceinline__ void nee(const Params& P, const Tables& T, Lane& s) {
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
  const float4 r0 = reinterpret_cast<const float4*>(T.pool)[2 * pidx];
  const float4 r1 = reinterpret_cast<const float4*>(T.pool)[2 * pidx + 1];
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
    for (int k = 0; k < 3; ++k) s.pn[k] = s.th[k] * wgt * le[k];
    s.mode = MODE_SHADOW;
    s.event = EV_NONE;
  } else {
    s.event = EV_SCATTER;
  }
  setup_ray(P, s, org, has_nee ? w_i : s.pd, has_nee);
}

// shadow / escape accumulation, Russian roulette, HG scatter
// (phase_finish) of a lane with an event. Returns true when the sample
// ends, with its sanitized (L.rgb, alpha) in `res`.
__device__ __forceinline__ bool finish(const Params& P, const Tables& T, Lane& s,
                                       float4& res) {
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
    const float* e = T.env + size_t(yc * P.env_w + xw) * 3;
    const float le_env[3] = {P.env_strength * e[0], P.env_strength * e[1],
                             P.env_strength * e[2]};
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
template <bool USE_TF, bool HAS_EMI, bool STATS>
__device__ __forceinline__ void render_group(const Params& P, const Tables& T,
                                             float* __restrict__ out, int group,
                                             float4* slot, Counters& cnt) {
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
        march_substep<USE_TF>(P, T, s);
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
        nee<USE_TF>(P, T, s);
      }
      float4 res;
      bool ended = false;
      if (s.event != EV_NONE) {
        const int ev = s.event;
        ended = finish(P, T, s, res);
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
template <bool USE_TF, bool HAS_EMI, bool STATS>
__global__ void __launch_bounds__(THREADS, min_blocks(USE_TF, HAS_EMI))
megakernel(const __grid_constant__ Params P, const __grid_constant__ Tables T,
           float* __restrict__ out, unsigned long long* __restrict__ stats,
           unsigned long long* __restrict__ btimes) {
  __shared__ float4 slots[WARPS][SLOTS];
  if (STATS && threadIdx.x == 0) btimes[2 * blockIdx.x] = globaltimer();
  const int last_fetch = P.n_groups + int(gridDim.x) * WARPS - 1;
  Counters cnt;
  for (;;) {
    int group = 0;
    if ((threadIdx.x & 31) == 0) {
      group = atomicAdd(&next_group, 1);
      if (group == last_fetch) atomicExch(&next_group, 0);
    }
    group = __shfl_sync(FULL, group, 0);
    if (group >= P.n_groups) break;
    render_group<USE_TF, HAS_EMI, STATS>(P, T, out, group, slots[threadIdx.x >> 5], cnt);
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
                       unsigned long long*);

Kernel pick_kernel(bool use_tf, bool has_emi, bool stats) {
  const Kernel main_k[2][2] = {{megakernel<false, false, false>, megakernel<false, true, false>},
                               {megakernel<true, false, false>, megakernel<true, true, false>}};
  const Kernel stats_k[2][2] = {{megakernel<false, false, true>, megakernel<false, true, true>},
                                {megakernel<true, false, true>, megakernel<true, true, true>}};
  return (stats ? stats_k : main_k)[use_tf][has_emi];
}

}  // namespace

// The launch's block count for a band of `rows` rows: as many blocks as fit
// on the card at once (asked once per instantiation), and no more than the
// groups need. Any count renders the same image. The STATS instantiation
// writes a (start, end) pair of %globaltimer per block.
extern "C" int volren_launch_blocks(int width, int rows, int spp, int use_tf, int has_emi,
                                    int stats) {
  static int resident[2][2][2] = {};
  int& fit = resident[use_tf != 0][has_emi != 0][stats != 0];
  if (fit == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick_kernel(use_tf, has_emi, stats),
                                                  THREADS, 0);
    fit = sms * per_sm;
  }
  const int need = (n_groups(width, rows, spp) + WARPS - 1) / WARPS;
  return fit < need ? fit : need;
}

// Host entry, bound with ctypes. `pf` / `pi` are HOST arrays (the parameter
// block of pack.build_params); every other pointer is device memory. `out`
// holds the band's pixels, pi[PI_ROWS] x pi[PI_WIDTH], rows from
// pi[PI_ROW0] (`n_pix` of them). The
// parameter block selects the variant: pi[PI_TF_SIZE] > 0 needs `tf_lut`
// (and `mip` is then the TF-baked table), pi[PI_EMI_N_SLOTS] > 0 needs the
// four emission tables; pointers of an absent variant may be null. The
// launch goes on `stream`, and launches on two streams must not overlap
// (they share the group counter); returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a missing table. A non-null `stats` launches the
// STATS instantiation instead: it adds the counters (N_STATS u64) into
// `stats` and writes each block's (start, end) into `btimes`
// (2 x volren_launch_blocks u64, zeroed by the caller); the image is the same.
extern "C" int volren_render(const float* pf, const int* pi, const void* atlas,
                             const void* slot, const void* lo, const void* hi,
                             const void* mip, const void* env, const void* pool,
                             const void* tf_lut, const void* emi_atlas,
                             const void* emi_slot, const void* emi_lo,
                             const void* emi_hi, void* out, void* stats,
                             void* btimes, int n_pix, void* stream) {
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
  if (P.row0 < 0 || P.rows < 0 || P.row0 + P.rows > P.height || n_pix != P.rows * P.width)
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
  const bool use_tf = P.tf_size > 0, has_emi = T.emi.n_slots > 0;
  if ((use_tf && !tf_lut) ||
      (has_emi && !(emi_atlas && emi_slot && emi_lo && emi_hi)) || (stats && !btimes))
    return int(cudaErrorInvalidValue);
  const Kernel kernel = pick_kernel(use_tf, has_emi, stats != nullptr);
  kernel<<<volren_launch_blocks(P.width, P.rows, P.spp, use_tf, has_emi, stats != nullptr),
           THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, T, static_cast<float*>(out), static_cast<unsigned long long*>(stats),
      static_cast<unsigned long long*>(btimes));
  return int(cudaGetLastError());
}
