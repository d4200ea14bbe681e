// The volume path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces volren_tpu/ops/pallas/kernel.py::_make_kernel (the no-TF,
// no-emission variant, in both its VMEM-atlas and HBM-atlas modes): for
// every pixel, `spp` full volumetric path samples, written once as the
// per-pixel SUM over samples of (L.rgb, alpha). The plain torch version of
// the same function is volren_tpu_torch/ops/kernels/megakernel.py::
// render_plain; this file repeats its arithmetic operation for operation
// (built with -fmad=false, IEEE division and square root).
//
// What bounds it on this card: dependent, latency-bound gathers (majorant
// pyramid, brick slot/range, u8 atlas byte, environment texel, NEE pool
// row) inside a divergent per-thread loop, not bytes or FLOPs. A DDA
// substep is ~60 instructions around one majorant load; a collision test
// adds a brick-meta load feeding an atlas load.
//
// What the design does about it: one thread owns one pixel and runs its
// samples back to back, so threads of a warp trace neighbouring pixels
// (coherent first bounces, shared cache lines). Every table stays in
// global memory and L2-resident: the 512x512x256 cloud is a 10 MB atlas
// plus about 2 MB of meta, mips, environment and pool, against 50 MB of
// L2, so the TPU kernel's HBM-atlas DMA machinery has no counterpart here.
// No atomics touch the image: each thread sums its samples in sample order
// in registers, so the image is bitwise identical from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// slot indices of the parameter block; must match
// volren_tpu_torch/ops/kernels/pack.py
constexpr int PF_CAM_POS = 0, PF_CAM_XFORM = 3, PF_ZCAM = 12, PF_BB_MIN = 13,
              PF_BB_MAX = 16, PF_ALBEDO = 21, PF_PHASE_G = 24,
              PF_DENSITY_SCALE = 25, PF_INV_XFORM = 26, PF_ENV_INV = 42,
              PF_ENV_STRENGTH = 51, PF_IMP_AVG = 52, PF_SHOW_ENV = 53;
constexpr int PI_WIDTH = 0, PI_HEIGHT = 1, PI_SPP_BASE = 2, PI_BOUNCES = 3,
              PI_SEED = 4, PI_SPP = 5, PI_N_BRICKS = 6, PI_N_SLOTS = 9,
              PI_ENV_H = 10, PI_ENV_W = 11, PI_MIP_DIMS = 12,
              PI_MIP_OFFSETS = 24, PI_MAX_ITERS = 28;
constexpr int POOL_N = 16384;

constexpr double PI_D = 3.14159265358979323846;
constexpr float INV_4PI = float(1.0 / (4.0 * PI_D));
constexpr float INV_2PI = float(1.0 / (2.0 * PI_D));
constexpr float INV_PI = float(1.0 / PI_D);
constexpr float TWO_PI = float(2.0 * PI_D);
constexpr float SIXTH = float(1.0 / 6.0);
constexpr float INV_255 = float(1.0 / 255.0);
constexpr float INV_2_24 = float(1.0 / 16777216.0);

enum { MODE_INACTIVE = 0, MODE_REGEN = 1, MODE_EXTEND = 2, MODE_SHADOW = 3 };
enum { EV_NONE = 0, EV_EXT_HIT = 1, EV_EXT_EXIT = 2, EV_SH_HIT = 3,
       EV_SH_EXIT = 4, EV_SCATTER = 5, EV_TEST = 6 };

struct Params {
  float cam_pos[3], cam_m[9], z_cam, bb_min[3], bb_max[3], albedo[3];
  float phase_g, density_scale, inv_x[16], env_inv[9], env_strength, imp_avg;
  int show_env, width, height, spp_base, bounces, spp;
  uint32_t seed;
  int nbx, nby, nbz, n_slots, env_h, env_w, mip_dims[12], mip_offsets[4];
  int max_iters;
};

struct Tables {
  const uint8_t* __restrict__ atlas;
  const int* __restrict__ slot;
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  const float* __restrict__ mip;
  const float* __restrict__ env;
  const float* __restrict__ pool;
};

// NaN-propagating min / max (torch.minimum / maximum / clamp semantics)
__device__ __forceinline__ float vmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float vmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// LCG step: the uniform comes from the next state; only an active draw
// advances the stream (the kernels' masked _rng)
__device__ __forceinline__ float rng(uint32_t& seed, bool active) {
  const uint32_t nxt = seed * 1664525u + 1013904223u;
  const float u = float(nxt & 0x00FFFFFFu) * INV_2_24;
  if (active) seed = nxt;
  return u;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

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

__device__ __forceinline__ float luma(const float c[3]) {
  return c[0] * 0.212671f + c[1] * 0.715160f + c[2] * 0.072169f;
}

__device__ __forceinline__ float sanitize(float x) {
  return isfinite(x) ? x : 0.0f;
}

__device__ __forceinline__ float hg_phase(float cos_t, float g) {
  const float denom = 1.0f + g * g + 2.0f * g * cos_t;
  return INV_4PI * (1.0f - g * g) / (denom * sqrtf(vmax(denom, 1e-12f)));
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

// per-thread path state (the Pallas kernel's lane state, one lane)
struct Lane {
  int mode, event;
  uint32_t seed;
  float po[3], pd[3], th[3], L[3], pn[3];
  int n_paths, free_path;
  float last_f_p, t, far_t, tau, mip;
  float i0[3], id[3], ri[3];
  int spp_done;
};

__device__ __forceinline__ void setup_ray(const Params& P, Lane& s, const float org[3], const float dir[3],
                          bool mask) {
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
  const float u_tau = rng(s.seed, mask && hit);
  if (!mask) return;
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

__device__ __forceinline__ float lookup_density(const Params& P, const Tables& T,
                                                const float tap[3]) {
  const int vx = clampi(int(tap[0]), 0, P.nbx * 8 - 1);
  const int vy = clampi(int(tap[1]), 0, P.nby * 8 - 1);
  const int vz = clampi(int(tap[2]), 0, P.nbz * 8 - 1);
  const int bidx = (vz >> 3) * (P.nby * P.nbx) + (vy >> 3) * P.nbx + (vx >> 3);
  const int voff = (vz & 7) * 64 + (vy & 7) * 8 + (vx & 7);
  const int slot = clampi(T.slot[bidx], 0, P.n_slots - 1);
  const float unorm = float(T.atlas[size_t(slot) * 512 + voff]) * INV_255;
  const float lo = T.lo[bidx], hi = T.hi[bidx];
  return lo + unorm * (hi - lo);
}

__global__ void __launch_bounds__(128)
megakernel(const Params P, const Tables T, float* __restrict__ out, int n_pix) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int px = pix % P.width, py = pix / P.width;
  const uint32_t lane_u = uint32_t(py) * uint32_t(P.width) + uint32_t(px);
  const float g = P.phase_g;
  const bool show_env = P.show_env != 0;

  Lane s;
  s.mode = MODE_REGEN;
  s.event = EV_NONE;
  s.seed = 0;
  for (int k = 0; k < 3; ++k) {
    s.po[k] = 0.0f; s.pd[k] = 0.0f; s.th[k] = 0.0f; s.L[k] = 0.0f; s.pn[k] = 0.0f;
    s.i0[k] = 0.0f; s.id[k] = 0.0f; s.ri[k] = 0.0f;
  }
  s.pd[2] = s.id[2] = s.ri[2] = 1.0f;
  s.n_paths = 0; s.free_path = 0; s.spp_done = 0;
  s.last_f_p = s.t = s.far_t = s.tau = s.mip = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int it = 0; it < P.max_iters; ++it) {
    // ---- regen (kernel.py phase_regen)
    if (s.mode == MODE_REGEN) {
      if (s.spp_done >= P.spp) {
        s.mode = MODE_INACTIVE;
      } else {
        s.mode = MODE_EXTEND;
        const uint32_t sample_idx = uint32_t(P.spp_base + s.spp_done + 1);
        s.seed = tea(P.seed * lane_u, sample_idx);
        const float u1 = rng(s.seed, true);
        const float u2 = rng(s.seed, true);
        float cl[3] = {(float(px) + u1 - float(P.width) * 0.5f) / float(P.height),
                       (float(py) + u2 - float(P.height) * 0.5f) / float(P.height),
                       P.z_cam};
        norm3(cl);
        float nd[3];
        mat3_vec(P.cam_m, cl, nd);
        norm3(nd);
        for (int k = 0; k < 3; ++k) {
          s.po[k] = P.cam_pos[k]; s.pd[k] = nd[k]; s.th[k] = 1.0f;
          s.L[k] = 0.0f; s.pn[k] = 0.0f;
        }
        s.n_paths = 0;
        s.last_f_p = 0.0f;
        s.free_path = 1;
        s.event = EV_NONE;
        setup_ray(P, s, s.po, s.pd, true);
      }
    }
    if (s.mode == MODE_INACTIVE) break;

    // ---- one DDA substep (phase_march + majorant_at)
    if ((s.mode == MODE_EXTEND || s.mode == MODE_SHADOW) && s.event == EV_NONE) {
      const bool is_extend = s.mode == MODE_EXTEND;
      float curr[3];
      for (int k = 0; k < 3; ++k) curr[k] = s.i0[k] + s.t * s.id[k];
      const int mip_i = int(rintf(s.mip));   // round half to even
      const float maj = majorant_at(P, T, curr, mip_i);
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
    }

    // ---- null-collision test (resolve_tests + stochastic_tricubic +
    // lookup_density_brick)
    if (s.event == EV_TEST) {
      const bool is_extend = s.mode == MODE_EXTEND;
      const float maj = s.tau;
      float pos[3], tap[3];
      for (int k = 0; k < 3; ++k) pos[k] = s.i0[k] + s.t * s.id[k];
      stochastic_tricubic(pos, s.seed, tap);
      const float d = P.density_scale * lookup_density(P, T, tap);
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

    // ---- next-event estimation from the alias pool (phase_nee)
    if (s.event == EV_EXT_HIT) {
      const float u0 = rng(s.seed, true);
      rng(s.seed, true);
      const int pidx = clampi(int(u0 * float(POOL_N)), 0, POOL_N - 1);
      const float4 r0 = reinterpret_cast<const float4*>(T.pool)[2 * pidx];
      const float4 r1 = reinterpret_cast<const float4*>(T.pool)[2 * pidx + 1];
      const float w_i[3] = {r0.x, r0.y, r0.z};
      const float pdf_nee = r0.w;
      const float le[3] = {r1.x, r1.y, r1.z};
      for (int k = 0; k < 3; ++k) s.th[k] = s.th[k] * P.albedo[k];
      float org[3];
      for (int k = 0; k < 3; ++k) org[k] = s.po[k] + s.t * s.pd[k];
      for (int k = 0; k < 3; ++k) s.po[k] = org[k];
      s.n_paths += 1;
      const float f_p = hg_phase(-dot3(s.pd, w_i), g);
      const float mis = show_env
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

    // ---- shadow / escape accumulation, Russian roulette, HG scatter
    // (phase_finish)
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
      if (show_env)
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
      for (int k = 0; k < 3; ++k) acc[k] = acc[k] + sanitize(Lc[k]);
      acc[3] = acc[3] + sanitize(alpha);
      s.spp_done += 1;
      for (int k = 0; k < 3; ++k) s.L[k] = 0.0f;
      s.mode = MODE_REGEN;
    } else {
      for (int k = 0; k < 3; ++k) s.L[k] = Lc[k];
      if (alive) s.mode = MODE_EXTEND;
    }
    if (scatter || esc) s.event = EV_NONE;
    setup_ray(P, s, s.po, s.pd, alive);
  }
  reinterpret_cast<float4*>(out)[pix] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

// Host entry, bound with ctypes. `pf` / `pi` are HOST arrays (the parameter
// block of pack.build_params); every other pointer is device memory. The
// launch goes on `stream`; returns cudaGetLastError() of the launch.
extern "C" int volren_render(const float* pf, const int* pi, const void* atlas,
                             const void* slot, const void* lo, const void* hi,
                             const void* mip, const void* env, const void* pool,
                             void* out, int n_pix, void* stream) {
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
  for (int k = 0; k < 16; ++k) P.inv_x[k] = pf[PF_INV_XFORM + k];
  P.z_cam = pf[PF_ZCAM];
  P.phase_g = pf[PF_PHASE_G];
  P.density_scale = pf[PF_DENSITY_SCALE];
  P.env_strength = pf[PF_ENV_STRENGTH];
  P.imp_avg = pf[PF_IMP_AVG];
  P.show_env = pf[PF_SHOW_ENV] > 0.0f ? 1 : 0;
  P.width = pi[PI_WIDTH];
  P.height = pi[PI_HEIGHT];
  P.spp_base = pi[PI_SPP_BASE];
  P.bounces = pi[PI_BOUNCES];
  P.seed = uint32_t(pi[PI_SEED]);
  P.spp = pi[PI_SPP];
  P.nbx = pi[PI_N_BRICKS];
  P.nby = pi[PI_N_BRICKS + 1];
  P.nbz = pi[PI_N_BRICKS + 2];
  P.n_slots = pi[PI_N_SLOTS];
  P.env_h = pi[PI_ENV_H];
  P.env_w = pi[PI_ENV_W];
  for (int k = 0; k < 12; ++k) P.mip_dims[k] = pi[PI_MIP_DIMS + k];
  for (int k = 0; k < 4; ++k) P.mip_offsets[k] = pi[PI_MIP_OFFSETS + k];
  P.max_iters = pi[PI_MAX_ITERS];
  Tables T;
  T.atlas = static_cast<const uint8_t*>(atlas);
  T.slot = static_cast<const int*>(slot);
  T.lo = static_cast<const float*>(lo);
  T.hi = static_cast<const float*>(hi);
  T.mip = static_cast<const float*>(mip);
  T.env = static_cast<const float*>(env);
  T.pool = static_cast<const float*>(pool);
  const int threads = 128;
  const int blocks = (n_pix + threads - 1) / threads;
  megakernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, T, static_cast<float*>(out), n_pix);
  return int(cudaGetLastError());
}
