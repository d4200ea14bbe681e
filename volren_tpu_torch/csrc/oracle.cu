// The oracle engine's progressive passes for NVIDIA Hopper (sm_90a).
//
// Replaces volren_tpu/ops/tracer.py::trace_pass, the JAX package's
// GLSL-order path tracer (an XLA program of masked lax.while_loops, not a
// Pallas kernel), for n passes in one launch: per (pixel, pass) the TEA
// seed of (pixel, sample), the jittered camera ray (view_dir), then
// trace_path as written -- the bounce loop; in it the volume sample (delta
// tracking against the global majorant, or DDA tracking over the majorant
// pyramid); next-event estimation through the hierarchical environment
// warp and the matching transmittance estimator (ratio tracking, or DDA);
// Russian roulette; the HG scatter -- and the free path's environment term
// with MIS through the warp's pdf. Then sanitize and, pass after pass, the
// running-mean update of the (H, W, 4) float32 framebuffer:
// fb + (rgba - fb) * (1 / current_sample).
//
// Three compile-time switches, the JAX package's TraceConfig: USE_DDA,
// USE_TF (classify the trilinear density through the LUT), HAS_EMI (the
// emission grid), eight instantiations behind one C entry point, and a
// STATS twin of each that counts the schedule (never launched by a render
// path).
//
// The plain torch version of the same function is
// volren_tpu_torch/ops/tracer.py (with ops/tracking.py, grid.py,
// envmap.py, phase.py, geometry.py). This file repeats its arithmetic
// operation for operation -- built with -fmad=false, IEEE division and
// square root, NaN-propagating min / max, the libm functions torch's CUDA
// kernels call -- so the two framebuffers are bitwise equal. A lane does
// what its tensor lane does there: it draws only where its lane's mask is
// set, evaluates only the branch a torch.where keeps, and leaves each
// tracking loop when its lane stops running or when the loop call has run
// max_steps iterations (the JAX loop's shared counter starts at 0 for
// every lane of a call), keeping its state as it stands.
//
// What bounds it on this card: latency, not bytes or FLOPs (a pass runs
// at a few percent of either bound). A path is a chain of dependent steps:
// a tracking iteration waits on a majorant or brick gather from the
// L2-resident tables, an NEE on nine levels of the importance pyramid, one
// after the other. Paths differ in length by two orders of magnitude: a
// sky pixel's path ends at its first volume sample, a cloud pixel's runs
// up to 100 bounces.
//
// What the schedule does about it (the megakernel's, csrc/megakernel.cu):
// the unit of work is a (pixel, pass) item. A warp owns a group of
// neighbouring pixels (one pixel at 32 passes or more, a tile of 32 / n of
// them below, rounded to a power of two; twice that where the launch has
// groups to spare) and all their passes; each lane
// traces one item a bounce at a time and, when its path ends, parks the
// sanitized rgba in shared memory and takes the group's next item (a
// ballot and a prefix count). So a sky group's lanes end together, and a
// cloud pixel's passes run side by side instead of holding a warp of sky
// pixels. The warps of persistent blocks (as many as fit on the card) take
// groups from one global counter, so no SM idles while groups remain, and
// the n passes of a launch pay one launch and one tail instead of n. The
// register bound keeps 8 blocks (32 warps) resident per SM. The
// importance pyramid is read from L2: a copy of its coarse levels in each
// block's shared memory was measured slower at 1024 x 1024 and no faster
// elsewhere on an H100 (PERF.md; the tracking loops carry the time). No
// atomics touch the image: after a group's items end, lane j folds pixel j's slots
// into the value it read from fb_in, in pass order, as the plain version
// does, so the framebuffer is bitwise identical from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// slot indices of the parameter block; must match
// volren_tpu_torch/ops/kernels/oracle.py
constexpr int OF_CAM_POS = 0, OF_CAM_XFORM = 3, OF_CAM_FOV = 12, OF_BB_MIN = 13,
              OF_BB_MAX = 16, OF_MAJORANT = 19, OF_INV_MAJORANT = 20, OF_ALBEDO = 21,
              OF_PHASE_G = 24, OF_DENSITY_SCALE = 25, OF_EMI_SCALE = 26, OF_EMI_NORM = 27,
              OF_INV_XFORM = 28, OF_XFORM = 44, OF_EMI_INV = 60, OF_ENV_XFORM = 76,
              OF_ENV_INV = 85, OF_ENV_STRENGTH = 94, OF_TF_LEFT = 95, OF_TF_WIDTH = 96,
              OF_SIZE = 100;
constexpr int OI_WIDTH = 0, OI_HEIGHT = 1, OI_FIRST_SAMPLE = 2, OI_BOUNCES = 3, OI_SEED = 4,
              OI_SHOW_ENV = 5, OI_MAX_STEPS = 6, OI_N_BRICKS = 7, OI_MIP_DIMS = 10,
              OI_MIP_OFFSETS = 22, OI_ENV_H = 26, OI_ENV_W = 27, OI_IMP_LEVELS = 28,
              OI_IMP_DIM = 29, OI_TF_SIZE = 30, OI_EMI_N_BRICKS = 31, OI_EMI_N_SLOTS = 34,
              OI_N_SLOTS = 35, OI_N_PASSES = 36, OI_SIZE = 40;

constexpr float PI_F = float(PI_D);
constexpr float HALF_PI = float(0.5 * PI_D);
constexpr float MIP_START = 3.0f, MIP_SPEED_UP = 0.25f, MIP_SPEED_DOWN = 2.0f;
constexpr int MAX_IMP_LEVELS = 16;

struct Params {
  float cam_pos[3], cam_m[9], cam_fov, bb_min[3], bb_max[3], majorant, inv_majorant;
  float albedo[3], phase_g, density_scale, emi_scale, emi_norm;
  float inv_x[16], x[16], emi_inv[16], env_m[9], env_inv[9], env_strength;
  float tf_left, tf_width;
  int width, height, first_sample, n_passes, bounces, show_env, max_steps;
  uint32_t seed;
  int env_h, env_w, imp_levels, imp_dim, tf_size;
  int imp_off[MAX_IMP_LEVELS];
  int tile_w, tile_h, tiles_x, n_groups;   // the schedule's pixel groups
};

// one brick grid: u8 atlas (slots, 512), per-brick slot / decode range
// and (the density grid's) flat majorant pyramid
struct Grid {
  const uint8_t* __restrict__ atlas;
  const int* __restrict__ slot;
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  const float* __restrict__ mip;
  int nbx, nby, nbz;
  int mip_dims[12], mip_offsets[4];
};

struct Tables {
  Grid dens, emi;                      // emi: HAS_EMI only
  const float* __restrict__ env;       // (env_h * env_w, 3)
  const float* __restrict__ imp;       // the importance pyramid, flat
  const float* __restrict__ tf_lut;    // USE_TF only: (tf_size, 4) RGBA
  unsigned* capped;                    // optional: + loop calls the cap stopped
};

// ---- the STATS instantiation's counters (never launched by a render
// path): the lanes that ran each unit the plain version counts (paths,
// bounce-loop iterations, tracking-loop iterations and DDA density tests
// of sample_volume and of transmittance, emission taps, capped loop
// calls), the warp-level issues of the bounce loop's body and of a
// tracking-loop iteration (the lanes over 32 x the issues: their SIMT
// efficiency), the groups the warps took (paths over groups: the items of
// a group), and each block's start and end on %globaltimer
enum { ST_PATHS = 0, ST_BOUNCE, ST_SV_ITERS, ST_TR_ITERS, ST_SV_TESTS, ST_TR_TESTS, ST_EMISSION,
       ST_CAPPED, ST_BOUNCE_ISSUES, ST_TRACK_ISSUES, ST_GROUPS, N_STATS };

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Counters {
  unsigned v[N_STATS] = {};
  // one issue of the calling code by the lanes now converged here: the
  // lowest of them counts it
  __device__ __forceinline__ void issue(int k) {
    if (int(threadIdx.x & 31) == __ffs(__activemask()) - 1) v[k] += 1;
  }
  // sum over the lanes converged here, one atomic per counter, and the
  // block's end time
  __device__ __forceinline__ void flush(unsigned long long* stats,
                                        unsigned long long* btimes) const {
    const unsigned m = __activemask();
    const bool leader = int(threadIdx.x & 31) == __ffs(m) - 1;
    for (int k = 0; k < N_STATS; ++k) {
      const unsigned x = __reduce_add_sync(m, v[k]);
      if (leader && x) atomicAdd(stats + k, (unsigned long long)x);
    }
    if (leader) atomicMax(btimes + 2 * blockIdx.x + 1, globaltimer());
  }
};

// floored modulo (torch.remainder / jnp.mod on ints)
__device__ __forceinline__ int fmodi(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// v / max(|v|, 1e-20), a division (geometry.normalize3)
__device__ __forceinline__ void normalize3(float v[3]) {
  const float n = vmax(sqrtf(dot3(v, v)), 1e-20f);
  v[0] = v[0] / n;
  v[1] = v[1] / n;
  v[2] = v[2] / n;
}

// out_j = (v0 m[j,0] + v1 m[j,1]) + v2 m[j,2] (geometry.matvec); m: 3x3
// row-major, or the 3x3 block of a 4x4 with stride 4
template <int STRIDE>
__device__ __forceinline__ void matvec(const float* m, const float v[3], float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = v[0] * m[STRIDE * j] + v[1] * m[STRIDE * j + 1] + v[2] * m[STRIDE * j + 2];
}

__device__ __forceinline__ void transform_point(const float* m, const float p[3], float out[3]) {
  matvec<4>(m, p, out);
  for (int j = 0; j < 3; ++j) out[j] = out[j] + m[4 * j + 3];
}

__device__ __forceinline__ float power_heuristic(float a, float b) {
  return a * a / (a * a + b * b);
}

// sample_phase_henyey_greenstein: the HG local direction, rotated into
// the frame around `dir` (align, normalised by a division)
__device__ __forceinline__ void sample_phase_hg(const float n[3], float g, float u0, float u1,
                                                float out[3]) {
  const float sqr = (1.0f - g * g) / (1.0f - g + 2.0f * g * u0);
  const bool small = fabsf(g) < 1e-4f;
  const float cos_aniso = (1.0f + g * g - sqr * sqr) / (2.0f * (small ? 1.0f : g));
  const float cos_t = small ? 1.0f - 2.0f * u0 : cos_aniso;
  const float sin_t = sqrtf(vmax(1.0f - cos_t * cos_t, 0.0f));
  const float phi = TWO_PI * u1;
  const float v[3] = {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
  const bool cond = fabsf(n[0]) > fabsf(n[1]);
  const float inv_xz = 1.0f / sqrtf(cond ? n[0] * n[0] + n[2] * n[2]
                                         : n[1] * n[1] + n[2] * n[2]);
  const float t[3] = {(cond ? -n[2] : 0.0f) * inv_xz, (cond ? 0.0f : n[2]) * inv_xz,
                      (cond ? n[0] : -n[1]) * inv_xz};
  const float b[3] = {n[1] * t[2] - n[2] * t[1], n[2] * t[0] - n[0] * t[2],
                      n[0] * t[1] - n[1] * t[0]};
  for (int k = 0; k < 3; ++k) out[k] = v[0] * t[k] + v[1] * b[k] + v[2] * n[k];
  normalize3(out);
}

// slab test (geometry.intersect_box): returns hit, sets near / far
__device__ __forceinline__ bool intersect_box(const Params& P, const float org[3],
                                              const float dir[3], float& near_t, float& far_t) {
  float tmin[3], tmax[3];
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / dir[k];
    const float lo = (P.bb_min[k] - org[k]) * inv;
    const float hi = (P.bb_max[k] - org[k]) * inv;
    tmin[k] = vmin(lo, hi);
    tmax[k] = vmax(lo, hi);
  }
  near_t = vmax(vmax(tmin[0], vmax(tmin[1], tmin[2])), 0.0f);
  far_t = vmin(tmax[0], vmin(tmax[1], tmax[2]));
  return near_t <= far_t;
}

// ---- the environment (ops/envmap.py)

// GL-style bilinear radiance * strength at (u, v): u wraps, v clamps
__device__ __forceinline__ void texture_env(const Params& P, const Tables& T, float u, float v,
                                            float out[3]) {
  const int h = P.env_h, w = P.env_w;
  const float x = u * float(w) - 0.5f;
  const float y = v * float(h) - 0.5f;
  const int x0 = int(floorf(x)), y0 = int(floorf(y));
  const float fx = x - float(x0), fy = y - float(y0);
  const int x0w = fmodi(x0, w), x1w = fmodi(x0 + 1, w);
  const int y0c = clampi(y0, 0, h - 1), y1c = clampi(y0 + 1, 0, h - 1);
  const float* t00 = T.env + size_t(y0c * w + x0w) * 3;
  const float* t01 = T.env + size_t(y0c * w + x1w) * 3;
  const float* t10 = T.env + size_t(y1c * w + x0w) * 3;
  const float* t11 = T.env + size_t(y1c * w + x1w) * 3;
  for (int k = 0; k < 3; ++k) {
    const float top = t00[k] * (1.0f - fx) + t01[k] * fx;
    const float bot = t10[k] * (1.0f - fx) + t11[k] * fx;
    out[k] = P.env_strength * (top * (1.0f - fy) + bot * fy);
  }
}

__device__ __forceinline__ void lookup_environment(const Params& P, const Tables& T,
                                                   const float dir[3], float out[3]) {
  float idir[3];
  matvec<3>(P.env_inv, dir, idir);
  const float u = atan2f(idir[2], idir[0]) / TWO_PI + 0.5f;
  const float v = 1.0f - acosf(vmin(vmax(idir[1], -1.0f), 1.0f)) / PI_F;
  texture_env(P, T, u, v, out);
}

// the hierarchical warp (sample_environment): Le, pdf, w_i for uniforms
// (p0, p1)
__device__ __forceinline__ float sample_environment(const Params& P, const Tables& T, float p0,
                                                    float p1, float le[3], float w_i[3]) {
  int px = 0, py = 0;
  for (int m = P.imp_levels - 2; m >= 0; --m) {
    const float* level = T.imp + P.imp_off[m];
    const int dim = P.imp_dim >> m;
    px = px * 2;
    py = py * 2;
    const int idx = py * dim + px;
    const float w0 = level[idx], w1 = level[idx + 1];
    const float w2 = level[idx + dim], w3 = level[idx + dim + 1];
    const float q0 = w0 + w2;
    const float q1 = w1 + w3;
    const float d = q0 / vmax(q0 + q1, 1e-8f);
    const bool go_right = p0 >= d;
    const float new_px = go_right ? (p0 - d) / (1.0f - d) : p0 / d;
    px = px + (go_right ? 1 : 0);
    const float e = go_right ? w1 / vmax(q1, 1e-20f) : w0 / vmax(q0, 1e-20f);
    const bool go_up = p1 >= e;
    const float new_py = go_up ? (p1 - e) / (1.0f - e) : p1 / e;
    py = py + (go_up ? 1 : 0);
    p0 = new_px;
    p1 = new_py;
  }
  const float inv_dim = float(1.0 / double(P.imp_dim));
  const float uv_x = (float(px) + p0) * inv_dim;
  const float uv_y = (float(py) + p1) * inv_dim;
  const float theta = vmin(vmax(1.0f - uv_y, 0.0f), 1.0f) * PI_F;
  const float phi = (vmin(vmax(uv_x, 0.0f), 1.0f) * 2.0f - 1.0f) * PI_F;
  const float sin_t = sinf(theta);
  const float w_local[3] = {sin_t * cosf(phi), cosf(theta), sin_t * sinf(phi)};
  matvec<3>(P.env_m, w_local, w_i);
  texture_env(P, T, uv_x, uv_y, le);
  const int idx = py * P.imp_dim + px;
  const float avg_w = T.imp[P.imp_off[P.imp_levels - 1]];
  const float pdf = T.imp[idx] / avg_w;
  return pdf * INV_4PI;
}

// ---- the brick grids (ops/grid.py)

__device__ __forceinline__ float lookup_density_brick(const Grid& G, const float ipos[3]) {
  const int vx = clampi(int(floorf(ipos[0])), 0, G.nbx * 8 - 1);
  const int vy = clampi(int(floorf(ipos[1])), 0, G.nby * 8 - 1);
  const int vz = clampi(int(floorf(ipos[2])), 0, G.nbz * 8 - 1);
  const int bidx = (vz >> 3) * (G.nby * G.nbx) + (vy >> 3) * G.nbx + (vx >> 3);
  const int voff = (vz & 7) * 64 + (vy & 7) * 8 + (vx & 7);
  const int slot = G.slot[bidx];
  const float unorm = float(G.atlas[size_t(slot) * 512 + voff]) * INV_255;
  const float lo = G.lo[bidx];
  return lo + unorm * (G.hi[bidx] - lo);
}

__device__ __forceinline__ float lookup_majorant(const Grid& G, const float ipos[3], int mip,
                                                 float density_scale) {
  const int ix = int(floorf(ipos[0])), iy = int(floorf(ipos[1])), iz = int(floorf(ipos[2]));
  int idx = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int mz = G.mip_dims[3 * m], my = G.mip_dims[3 * m + 1], mx = G.mip_dims[3 * m + 2];
    const int bxm = clampi(ix >> (3 + m), 0, mx - 1);
    const int bym = clampi(iy >> (3 + m), 0, my - 1);
    const int bzm = clampi(iz >> (3 + m), 0, mz - 1);
    if (mip == m) idx = G.mip_offsets[m] + (bzm * my + bym) * mx + bxm;
  }
  return density_scale * G.mip[idx];
}

// 8 corners, dx fastest, acc + w * decode, then * density_scale
__device__ __forceinline__ float lookup_density_trilinear(const Grid& G, const float ipos[3],
                                                          float density_scale) {
  float base[3], f[3];
  for (int k = 0; k < 3; ++k) {
    const float p = ipos[k] - 0.5f;
    base[k] = floorf(p);
    f[k] = p - base[k];
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i & 1, dy = (i >> 1) & 1, dz = i >> 2;
    const float w = (dx ? f[0] : 1.0f - f[0]) * (dy ? f[1] : 1.0f - f[1]) *
                    (dz ? f[2] : 1.0f - f[2]);
    const float tap[3] = {base[0] + float(dx), base[1] + float(dy), base[2] + float(dz)};
    acc = acc + w * lookup_density_brick(G, tap);
  }
  return density_scale * acc;
}

// weighted reservoir sampling of the tricubic taps: 9 masked draws
__device__ __forceinline__ void stochastic_tricubic(const float ipos[3], uint32_t& seed,
                                                    bool active, float tap[3]) {
  float iip[3], t[3], t2[3], t3[3], sum_wt[3], idx[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    iip[k] = floorf(ipos[k] - 0.5f);
    t[k] = (ipos[k] - 0.5f) - iip[k];
    t2[k] = t[k] * t[k];
    t3[k] = t[k] * t2[k];
    sum_wt[k] = SIXTH * (-t3[k] + 3.0f * t2[k] - 3.0f * t[k] + 1.0f);
  }
  for (int tap_idx = 1; tap_idx <= 3; ++tap_idx) {
    float w[3], r[3];
    for (int k = 0; k < 3; ++k) {
      if (tap_idx == 1)
        w[k] = SIXTH * (3.0f * t3[k] - 6.0f * t2[k] + 4.0f);
      else if (tap_idx == 2)
        w[k] = SIXTH * (-3.0f * t3[k] + 3.0f * t2[k] + 3.0f * t[k] + 1.0f);
      else
        w[k] = SIXTH * t3[k];
      sum_wt[k] = w[k] + sum_wt[k];
    }
    for (int k = 0; k < 3; ++k) r[k] = rng(seed, active);
    for (int k = 0; k < 3; ++k)
      if (r[k] < w[k] / vmax(sum_wt[k], 1e-3f)) idx[k] = float(tap_idx);
  }
  for (int k = 0; k < 3; ++k) tap[k] = iip[k] + idx[k] - 1.0f;
}

// windowed, lerped LUT fetch (ops/transfer.py tf_lookup)
__device__ __forceinline__ void tf_lookup(const Params& P, const float* __restrict__ lut,
                                          float d, float out[4]) {
  const float tc = vmin(vmax((d - P.tf_left) / P.tf_width, 0.0f), TF_WINDOW_MAX) *
                   float(P.tf_size);
  const int idx = int(floorf(tc));
  const float fr = tc - float(idx);
  const int idx1 = min(idx + 1, P.tf_size - 1);
  for (int k = 0; k < 4; ++k) out[k] = lut[4 * idx + k] * (1.0f - fr) + lut[4 * idx1 + k] * fr;
}

// ---- tracking (ops/tracking.py)

// the collision-test density (and the TF rgba); draws masked by `active`
template <bool USE_TF>
__device__ __forceinline__ float density_at(const Params& P, const Tables& T, const float pos[3],
                                            uint32_t& seed, bool active, float rgba[4]) {
  if (USE_TF) {
    tf_lookup(P, T.tf_lut, lookup_density_trilinear(T.dens, pos, P.density_scale) *
                               P.inv_majorant, rgba);
    return P.majorant * rgba[3];
  }
  float tap[3];
  stochastic_tricubic(pos, seed, active, tap);
  return P.density_scale * lookup_density_brick(T.dens, tap);
}

// L += throughput * (1 - albedo) * emission * weight where `active`
template <bool HAS_EMI, bool STATS>
__device__ __forceinline__ void add_emission(const Params& P, const Tables& T, const float pos[3],
                                             float weight, const float th[3], float L[3],
                                             uint32_t& seed, bool active, Counters& cnt) {
  if (!HAS_EMI) return;
  if (STATS) cnt.v[ST_EMISSION] += active ? 1u : 0u;
  float world[3], epos[3], tap[3];
  transform_point(P.x, pos, world);
  transform_point(P.emi_inv, world, epos);
  stochastic_tricubic(epos, seed, active, tap);
  const float t = lookup_density_brick(T.emi, tap) * P.emi_norm;
  const float t2 = t * t;
  const float e[3] = {P.emi_scale * t2, P.emi_scale * (t2 * t2),
                      P.emi_scale * (t2 * t2 * t2 * t2)};
  for (int k = 0; k < 3; ++k) {
    const float contrib = th[k] * (1.0f - P.albedo[k]) * e[k] * weight;
    L[k] = L[k] + (active ? contrib : 0.0f);
  }
}

__device__ __forceinline__ void to_index_space(const Params& P, const float org[3],
                                               const float dir[3], float ipos[3],
                                               float idir[3]) {
  transform_point(P.inv_x, org, ipos);
  matvec<4>(P.inv_x, dir, idir);
}

// Ratio tracking (transmittance) or delta tracking (sample_volume, SAMPLE)
// against the global majorant. A lane that is not active does not call it.
template <bool SAMPLE, bool USE_TF, bool HAS_EMI, bool STATS>
__device__ __forceinline__ float track_global(const Params& P, const Tables& T,
                                              const float org[3], const float dir[3],
                                              uint32_t& seed, float th[3], float L[3],
                                              bool& hit, float& t_out, Counters& cnt) {
  float near_t, far_t, ipos[3], idir[3];
  bool running = intersect_box(P, org, dir, near_t, far_t);
  to_index_space(P, org, dir, ipos, idir);
  const float inv_maj = P.inv_majorant;
  const float u = rng(seed, running);
  float t = near_t - logf(1.0f - u) * inv_maj;
  float tr = 1.0f;
  hit = false;
  for (int i = 0; running && i < P.max_steps; ++i) {
    if (STATS) {
      cnt.issue(ST_TRACK_ISSUES);
      cnt.v[SAMPLE ? ST_SV_ITERS : ST_TR_ITERS] += 1;
    }
    running = t < far_t;
    float pos[3], rgba[4];
    for (int k = 0; k < 3; ++k) pos[k] = ipos[k] + t * idir[k];
    const float d = density_at<USE_TF>(P, T, pos, seed, running, rgba);
    if (SAMPLE) {
      const float p_real = d * inv_maj;
      add_emission<HAS_EMI, STATS>(P, T, pos, p_real, th, L, seed, running, cnt);
      const float u_cls = rng(seed, running);
      const bool hit_now = running && u_cls < p_real;
      if (hit_now)
        for (int k = 0; k < 3; ++k)
          th[k] = th[k] * (USE_TF ? P.albedo[k] * rgba[k] : P.albedo[k]);
      hit = hit || hit_now;
      running = running && !hit_now;
    } else {
      if (running) tr = tr * (1.0f - d * inv_maj);
      // russian roulette below 0.1 (common.glsl:351-356)
      const bool rr = running && tr < 0.1f;
      const float u_rr = rng(seed, rr);
      const bool killed = rr && u_rr < (1.0f - tr);
      tr = killed ? 0.0f : (rr ? 1.0f : tr);
      running = running && !killed;
    }
    const float u_adv = rng(seed, running);
    if (running) t = t - logf(1.0f - u_adv) * inv_maj;
  }
  if (running && T.capped) atomicAdd(T.capped, 1u);
  if (STATS && running) cnt.v[ST_CAPPED] += 1;
  t_out = t;
  return tr;
}

// distance to the next (8 << mip)-aligned cell boundary (step_dda)
__device__ __forceinline__ float step_dda(const float pos[3], const float ri[3], int mip) {
  const float dim = float(8 << mip);
  float tm[3];
  for (int k = 0; k < 3; ++k) {
    const float offs = ri[k] >= 0.0f ? dim + 0.5f : -0.5f;
    tm[k] = (floorf(pos[k] / dim) * dim + offs - pos[k]) * ri[k];
  }
  return vmin(tm[0], vmin(tm[1], tm[2]));
}

// The DDA march (_dda_loop) with transmittance_dda's collision handling,
// or with sample_volume_dda's (SAMPLE). A lane that is not active does not
// call it.
template <bool SAMPLE, bool USE_TF, bool HAS_EMI, bool STATS>
__device__ __forceinline__ float track_dda(const Params& P, const Tables& T, const float org[3],
                                           const float dir[3], uint32_t& seed, float th[3],
                                           float L[3], bool& hit, float& t_out, Counters& cnt) {
  float near_t, far_t, ipos[3], idir[3], ri[3];
  bool running = intersect_box(P, org, dir, near_t, far_t);
  to_index_space(P, org, dir, ipos, idir);
  for (int k = 0; k < 3; ++k) ri[k] = 1.0f / idir[k];
  const float u0 = rng(seed, running);
  float t = near_t + 1e-6f;
  float tau = -logf(1.0f - u0);
  float mip = MIP_START;
  float tr = 1.0f;
  hit = false;
  for (int i = 0; running && i < P.max_steps; ++i) {
    if (STATS) {
      cnt.issue(ST_TRACK_ISSUES);
      cnt.v[SAMPLE ? ST_SV_ITERS : ST_TR_ITERS] += 1;
    }
    float curr[3];
    for (int k = 0; k < 3; ++k) curr[k] = ipos[k] + t * idir[k];
    const int mip_round = int(rintf(mip));   // round half to even
    float maj = lookup_majorant(T.dens, curr, mip_round, P.density_scale);
    if (USE_TF) {
      float rgba_m[4];
      tf_lookup(P, T.tf_lut, maj * P.inv_majorant, rgba_m);
      maj = P.majorant * rgba_m[3];
    }
    const float dt = step_dda(curr, ri, mip_round);
    const float t_adv = t + dt;
    const float tau_adv = tau - maj * dt;
    const float mip_up = vmin(mip + MIP_SPEED_UP, 3.0f);
    const bool collide = tau_adv <= 0.0f;
    t = collide ? t_adv + tau_adv / vmax(maj, 1e-20f) : t_adv;
    const bool exited = collide && t >= far_t;
    const bool do_test = collide && !exited;
    bool terminate = false;
    if (do_test) {
      if (STATS) cnt.v[SAMPLE ? ST_SV_TESTS : ST_TR_TESTS] += 1;
      float pos[3], rgba[4];
      for (int k = 0; k < 3; ++k) pos[k] = ipos[k] + t * idir[k];
      const float d = density_at<USE_TF>(P, T, pos, seed, true, rgba);
      const float u_cls = rng(seed, true);
      const bool real = u_cls * maj < d;
      if (SAMPLE) {
        add_emission<HAS_EMI, STATS>(P, T, pos, d * P.inv_majorant, th, L, seed, true, cnt);
        if (real)
          for (int k = 0; k < 3; ++k)
            th[k] = th[k] * (USE_TF ? P.albedo[k] * rgba[k] : P.albedo[k]);
        hit = hit || real;
        terminate = real;
      } else {
        // global over local majorant, <= 0 in practice: a real collision
        // zeroes Tr (tracking.py's module docstring)
        if (real) tr = tr * vmax(1.0f - P.majorant / vmax(maj, 1e-20f), 0.0f);
        const bool rr = real && tr < 0.1f;
        const float u_rr = rng(seed, rr);
        const bool killed = rr && u_rr < 1.0f - tr;
        tr = killed ? 0.0f : (rr ? 1.0f : tr);
        terminate = killed;
      }
    }
    // no-hit collisions: redraw tau, drop mips
    const bool redraw = do_test && !terminate;
    const float u_tau = rng(seed, redraw);
    tau = redraw ? -logf(1.0f - u_tau) : tau_adv;
    mip = redraw ? vmax(mip_up - MIP_SPEED_DOWN, 0.0f) : mip_up;
    running = !exited && !terminate && t < far_t;
  }
  if (running && T.capped) atomicAdd(T.capped, 1u);
  if (STATS && running) cnt.v[ST_CAPPED] += 1;
  t_out = t;
  return tr;
}

template <bool USE_DDA, bool USE_TF, bool HAS_EMI, bool STATS>
__device__ __forceinline__ void sample_volume(const Params& P, const Tables& T,
                                              const float org[3], const float dir[3],
                                              uint32_t& seed, float th[3], float L[3], bool& hit,
                                              float& t, Counters& cnt) {
  if (USE_DDA)
    track_dda<true, USE_TF, HAS_EMI, STATS>(P, T, org, dir, seed, th, L, hit, t, cnt);
  else
    track_global<true, USE_TF, HAS_EMI, STATS>(P, T, org, dir, seed, th, L, hit, t, cnt);
}

template <bool USE_DDA, bool USE_TF, bool STATS>
__device__ __forceinline__ float transmittance(const Params& P, const Tables& T,
                                               const float org[3], const float dir[3],
                                               uint32_t& seed, Counters& cnt) {
  float th[3] = {1.0f, 1.0f, 1.0f}, L[3] = {0.0f, 0.0f, 0.0f}, t;
  bool hit;
  if (USE_DDA)
    return track_dda<false, USE_TF, false, STATS>(P, T, org, dir, seed, th, L, hit, t, cnt);
  return track_global<false, USE_TF, false, STATS>(P, T, org, dir, seed, th, L, hit, t, cnt);
}

// ---- the path (ops/tracer.py), one bounce at a time

// a lane's path: trace_path's loop state
struct Path {
  uint32_t seed;
  float org[3], dir[3], th[3], L[3], last_f_p;
  int n_paths;
  bool free_path;
};

// trace_sample: the seed of (pixel, sample), the jittered camera ray
__device__ __forceinline__ void start_path(const Params& P, Path& s, int x, int y, int sample) {
  s.seed = tea(P.seed * uint32_t(y * P.width + x), uint32_t(sample));
  const float u0 = rng(s.seed, true);
  const float u1 = rng(s.seed, true);
  float cam[3] = {(float(x) + u0 - float(P.width) * 0.5f) / float(P.height),
                  (float(y) + u1 - float(P.height) * 0.5f) / float(P.height),
                  -0.5f / tanf(P.cam_fov * HALF_PI / 180.0f)};
  normalize3(cam);
  matvec<3>(P.cam_m, cam, s.dir);
  normalize3(s.dir);
  for (int k = 0; k < 3; ++k) {
    s.org[k] = P.cam_pos[k];
    s.th[k] = 1.0f;
    s.L[k] = 0.0f;
  }
  s.n_paths = 0;
  s.last_f_p = 0.0f;
  s.free_path = true;
}

// One iteration of trace_path's bounce loop: the volume sample, then for a
// hit NEE, termination and the scatter. Returns whether the path ended.
template <bool USE_DDA, bool USE_TF, bool HAS_EMI, bool STATS>
__device__ __forceinline__ bool bounce(const Params& P, const Tables& T, Path& s,
                                       Counters& cnt) {
  const float g = P.phase_g;
  bool hit;
  float t;
  sample_volume<USE_DDA, USE_TF, HAS_EMI, STATS>(P, T, s.org, s.dir, s.seed, s.th, s.L, hit, t,
                                                  cnt);
  // a ray that left the volume becomes a free path and stops bouncing
  if (!hit) return true;
  for (int k = 0; k < 3; ++k) s.org[k] = s.org[k] + t * s.dir[k];

  // next-event estimation (common.glsl:614-626)
  const float e0 = rng(s.seed, true);
  const float e1 = rng(s.seed, true);
  float le_env[3], w_i[3];
  const float pdf_env = sample_environment(P, T, e0, e1, le_env, w_i);
  const bool nee = pdf_env > 0.0f;
  const float cos_nee = -s.dir[0] * w_i[0] + -s.dir[1] * w_i[1] + -s.dir[2] * w_i[2];
  const float f_p = hg_phase(cos_nee, g);
  const float mis_weight = P.show_env > 0 ? power_heuristic(pdf_env, f_p) : 1.0f;
  const float tr =
      nee ? transmittance<USE_DDA, USE_TF, STATS>(P, T, s.org, w_i, s.seed, cnt) : 1.0f;
  const float sc_nee = mis_weight * f_p * tr / vmax(pdf_env, 1e-20f);
  for (int k = 0; k < 3; ++k) s.L[k] = s.L[k] + (nee ? s.th[k] * sc_nee * le_env[k] : 0.0f);

  // termination: bounce cap + russian roulette (common.glsl:629-636)
  s.n_paths = s.n_paths + 1;
  const bool capped = s.n_paths >= P.bounces;
  bool active = !capped;
  const float rr_val = luma(s.th);
  const bool rr = active && rr_val < 0.1f;
  const float u_rr = rng(s.seed, rr);
  const bool killed = rr && u_rr < 1.0f - rr_val;
  active = active && !killed;
  if (rr && !killed)
    for (int k = 0; k < 3; ++k) s.th[k] = s.th[k] / vmax(rr_val, 1e-20f);

  // scatter (common.glsl:639-641)
  const float s0 = rng(s.seed, active);
  const float s1 = rng(s.seed, active);
  if (active) {
    float sc[3];
    sample_phase_hg(s.dir, g, s0, s1, sc);
    s.last_f_p = hg_phase(-s.dir[0] * sc[0] + -s.dir[1] * sc[1] + -s.dir[2] * sc[2], g);
    for (int k = 0; k < 3; ++k) s.dir[k] = sc[k];
  }
  s.free_path = s.free_path && !(capped || killed);
  return !active;
}

// the ended path's free-path environment term (common.glsl:645-649) and
// its sanitized rgba
__device__ __forceinline__ float4 finish_path(const Params& P, const Tables& T, const Path& s) {
  float env_le[3], L[3];
  lookup_environment(P, T, s.dir, env_le);
  const float avg_w = T.imp[P.imp_off[P.imp_levels - 1]];
  const float pdf = luma(env_le) / avg_w * INV_4PI;
  const float mis = s.n_paths > 0 ? power_heuristic(s.last_f_p, pdf) : 1.0f;
  const bool add = s.free_path && P.show_env > 0;
  for (int k = 0; k < 3; ++k) L[k] = s.L[k] + (add ? s.th[k] * mis * env_le[k] : 0.0f);
  const float alpha = vmin(vmax(float(s.n_paths), 0.0f), 1.0f);
  return make_float4(sanitize(L[0]), sanitize(L[1]), sanitize(L[2]), sanitize(alpha));
}

// ---- the schedule

constexpr int WARPS = 4;                  // warps per block
constexpr int THREADS = 32 * WARPS;
// resident blocks per SM the registers must allow: 8 (64 registers, the
// whole register file); ptxas spills, and still 8 beat fewer at 1024x1024
// in every path (measured on an H100 with patched copies of this file,
// PERF.md)
constexpr int MIN_BLOCKS = 8;
constexpr int SLOTS = 64;                 // a warp's (pixel, pass) result slots: one round
constexpr unsigned FULL = 0xffffffffu;

// One warp traces one group: the pixels of a tile_w x tile_h tile (cut at
// the frame's edge) and all the launch's passes of each. Its items are
// (pixel j, pass k) = j * n_passes + k, served in rounds of SLOTS: each
// lane traces one item a bounce at a time and, when its path ends, leaves
// the sanitized rgba in the item's slot and takes the round's next item (a
// ballot and a prefix count, no atomics). After a round, lane j folds
// pixel j's slots into the value it read from fb_in, in pass order, as
// tracer.trace_passes does: f = f + (rgba_k - f) * (1 / sample_k).
template <bool USE_DDA, bool USE_TF, bool HAS_EMI, bool STATS>
__device__ __forceinline__ void trace_group(const Params& P, const Tables& T,
                                            const float* __restrict__ fb_in,
                                            float* __restrict__ fb_out, int group, float4* slot,
                                            Counters& cnt) {
  const int lane = threadIdx.x & 31;
  const int x0 = (group % P.tiles_x) * P.tile_w, y0 = (group / P.tiles_x) * P.tile_h;
  const int cw = min(P.tile_w, P.width - x0), ch = min(P.tile_h, P.height - y0);
  const int n = P.n_passes, n_items = cw * ch * n;
  const bool mine = lane < cw * ch;   // lane j folds pixel j
  const size_t pix = mine ? size_t(y0 + lane / cw) * P.width + x0 + lane % cw : 0;
  float4 f = mine ? reinterpret_cast<const float4*>(fb_in)[pix] : make_float4(0, 0, 0, 0);
  Path s;
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
          const int j = (base + item) / n, k = base + item - j * n;
          start_path(P, s, x0 + j % cw, y0 + j / cw, P.first_sample + k);
          if (STATS) cnt.v[ST_PATHS] += 1;
        }
      }
      next = min(n_round, next + __popc(idle));
      if (item < 0) continue;
      if (STATS) {
        cnt.issue(ST_BOUNCE_ISSUES);
        cnt.v[ST_BOUNCE] += 1;
      }
      if (bounce<USE_DDA, USE_TF, HAS_EMI, STATS>(P, T, s, cnt)) {
        slot[item] = finish_path(P, T, s);
        item = -1;
      }
    }
    __syncwarp();
    if (mine) {
      const int lo = max(base, lane * n), hi = min(base + n_round, (lane + 1) * n);
      for (int i = lo; i < hi; ++i) {
        const float4 v = slot[i - base];
        const float w = 1.0f / float(P.first_sample + i - lane * n);   // tracer.pass_weight
        f = make_float4(f.x + (v.x - f.x) * w, f.y + (v.y - f.y) * w, f.z + (v.z - f.z) * w,
                        f.w + (v.w - f.w) * w);
      }
    }
    __syncwarp();
  }
  if (mine) reinterpret_cast<float4*>(fb_out)[pix] = f;
}

// Persistent blocks: their warps take groups from the one global counter
// `next_group` (zeroed by the caller before each launch).
template <bool USE_DDA, bool USE_TF, bool HAS_EMI, bool STATS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
oracle_trace(const __grid_constant__ Params P, const __grid_constant__ Tables T,
             const float* __restrict__ fb_in, float* __restrict__ fb_out,
             int* __restrict__ next_group, unsigned long long* __restrict__ stats,
             unsigned long long* __restrict__ btimes) {
  __shared__ float4 slots[WARPS][SLOTS];
  if (STATS && threadIdx.x == 0) btimes[2 * blockIdx.x] = globaltimer();
  Counters cnt;
  for (;;) {
    int group = 0;
    if ((threadIdx.x & 31) == 0) group = atomicAdd(next_group, 1);
    group = __shfl_sync(FULL, group, 0);
    if (group >= P.n_groups) break;
    if (STATS && (threadIdx.x & 31) == 0) cnt.v[ST_GROUPS] += 1;
    trace_group<USE_DDA, USE_TF, HAS_EMI, STATS>(P, T, fb_in, fb_out, group,
                                                 slots[threadIdx.x >> 5], cnt);
  }
  if (STATS) cnt.flush(stats, btimes);
}

// the group tile of a launch: G = the least power of two with G * n_passes
// >= `items` (at most 32) pixels, as near square as a power-of-two split
// allows
void group_tile(int n_passes, int items, int& tile_w, int& tile_h) {
  int g = 1, lg = 0;
  while (g < 32 && g * n_passes < items) { g *= 2; ++lg; }
  tile_w = 1 << ((lg + 1) / 2);
  tile_h = g / tile_w;
}

int n_groups(int width, int height, int n_passes, int items) {
  int tw, th;
  group_tile(n_passes, items, tw, th);
  return ((width + tw - 1) / tw) * ((height + th - 1) / th);
}

// A group's items: 64, two a lane, where the launch keeps at least
// GROUPS_PER_WARP groups for every resident warp (a lane whose path ends
// takes another, so a warp waits less often on its longest path); 32
// otherwise, where fewer, larger groups would leave warps idle at the end.
constexpr int GROUPS_PER_WARP = 8;

int group_items(int width, int height, int n_passes, int resident_warps) {
  const bool spare = n_groups(width, height, n_passes, 64) >= GROUPS_PER_WARP * resident_warps;
  return spare ? 64 : 32;
}

using Kernel = void (*)(const Params, const Tables, const float*, float*, int*,
                        unsigned long long*, unsigned long long*);

template <bool STATS>
Kernel pick(bool use_dda, bool use_tf, bool has_emi) {
  const Kernel k[2][2][2] = {
      {{oracle_trace<false, false, false, STATS>, oracle_trace<false, false, true, STATS>},
       {oracle_trace<false, true, false, STATS>, oracle_trace<false, true, true, STATS>}},
      {{oracle_trace<true, false, false, STATS>, oracle_trace<true, false, true, STATS>},
       {oracle_trace<true, true, false, STATS>, oracle_trace<true, true, true, STATS>}}};
  return k[use_dda][use_tf][has_emi];
}

Kernel pick_kernel(bool use_dda, bool use_tf, bool has_emi, bool stats) {
  return stats ? pick<true>(use_dda, use_tf, has_emi) : pick<false>(use_dda, use_tf, has_emi);
}

void read_grid(Grid& G, const void* atlas, const void* slot, const void* lo, const void* hi,
               const void* mip, const int* n_bricks) {
  G.atlas = static_cast<const uint8_t*>(atlas);
  G.slot = static_cast<const int*>(slot);
  G.lo = static_cast<const float*>(lo);
  G.hi = static_cast<const float*>(hi);
  G.mip = static_cast<const float*>(mip);
  G.nbx = n_bricks[0];
  G.nby = n_bricks[1];
  G.nbz = n_bricks[2];
  for (int k = 0; k < 12; ++k) G.mip_dims[k] = 0;
  for (int k = 0; k < 4; ++k) G.mip_offsets[k] = 0;
}

// the blocks of an instantiation that fit on the card at once (asked once)
int resident_blocks(bool use_dda, bool use_tf, bool has_emi, bool stats) {
  static int resident[2][2][2][2] = {};
  int& fit = resident[use_dda][use_tf][has_emi][stats];
  if (fit == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pick_kernel(use_dda, use_tf, has_emi, stats), THREADS, 0);
    fit = sms * per_sm;
  }
  return fit;
}

// The launch's schedule: the group tile and count (chosen for the render
// instantiation, so its STATS twin counts the same schedule), and as many
// blocks as fit on the card at once, no more than the groups need. Any
// schedule traces the same framebuffer.
struct Launch {
  int blocks, tile_w, tile_h, n_groups;
};

Launch launch_shape(int width, int height, int n_passes, bool use_dda, bool use_tf, bool has_emi,
                    bool stats) {
  const int fit = resident_blocks(use_dda, use_tf, has_emi, stats);
  Launch L;
  const int items = group_items(width, height, n_passes,
                                resident_blocks(use_dda, use_tf, has_emi, false) * WARPS);
  group_tile(n_passes, items, L.tile_w, L.tile_h);
  L.n_groups = n_groups(width, height, n_passes, items);
  const int need = (L.n_groups + WARPS - 1) / WARPS;
  L.blocks = fit < need ? fit : need;
  return L;
}

}  // namespace

// The launch's block count (btimes of the STATS instantiation hold two
// entries a block).
extern "C" int volren_oracle_blocks(int width, int height, int n_passes, int use_dda, int use_tf,
                                    int has_emi, int stats) {
  return launch_shape(width, height, n_passes, use_dda != 0, use_tf != 0, has_emi != 0,
                      stats != 0).blocks;
}

// Host entry, bound with ctypes: pi[OI_N_PASSES] passes, samples
// pi[OI_FIRST_SAMPLE] on, in one launch. `pf` / `pi` are HOST arrays (the
// parameter block of ops/kernels/oracle.py); every other pointer is device
// memory: the density grid's atlas, slot, lo, hi and majorant pyramid, the
// environment (H*W*3), the flat importance pyramid, the TF LUT (USE_TF),
// the emission grid's atlas, slot, lo, hi (HAS_EMI; pointers of an absent
// variant may be null), the (H, W, 4) framebuffers in and out (distinct),
// and `next_group`, one int that must be 0 at the launch. A
// non-null `capped` (one u32) gains the number of tracking loop calls that
// the max_steps cap stopped. A non-null `stats` launches the STATS
// instantiation instead: it adds the counters (N_STATS u64) into `stats`
// and writes each block's (start, end) into `btimes` (2 x
// volren_oracle_blocks u64, zeroed by the caller); the framebuffer is the
// same. The launch goes on `stream`. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a missing table or a malformed block.
extern "C" int volren_oracle_trace(const float* pf, const int* pi, int use_dda, const void* atlas,
                                   const void* slot, const void* lo, const void* hi,
                                   const void* mip, const void* env, const void* imp,
                                   const void* tf_lut, const void* emi_atlas,
                                   const void* emi_slot, const void* emi_lo, const void* emi_hi,
                                   const void* fb_in, void* fb_out, void* capped,
                                   void* next_group, void* stats, void* btimes, void* stream) {
  Params P;
  for (int k = 0; k < 3; ++k) {
    P.cam_pos[k] = pf[OF_CAM_POS + k];
    P.bb_min[k] = pf[OF_BB_MIN + k];
    P.bb_max[k] = pf[OF_BB_MAX + k];
    P.albedo[k] = pf[OF_ALBEDO + k];
  }
  for (int k = 0; k < 9; ++k) {
    P.cam_m[k] = pf[OF_CAM_XFORM + k];
    P.env_m[k] = pf[OF_ENV_XFORM + k];
    P.env_inv[k] = pf[OF_ENV_INV + k];
  }
  for (int k = 0; k < 16; ++k) {
    P.inv_x[k] = pf[OF_INV_XFORM + k];
    P.x[k] = pf[OF_XFORM + k];
    P.emi_inv[k] = pf[OF_EMI_INV + k];
  }
  P.cam_fov = pf[OF_CAM_FOV];
  P.majorant = pf[OF_MAJORANT];
  P.inv_majorant = pf[OF_INV_MAJORANT];
  P.phase_g = pf[OF_PHASE_G];
  P.density_scale = pf[OF_DENSITY_SCALE];
  P.emi_scale = pf[OF_EMI_SCALE];
  P.emi_norm = pf[OF_EMI_NORM];
  P.env_strength = pf[OF_ENV_STRENGTH];
  P.tf_left = pf[OF_TF_LEFT];
  P.tf_width = pf[OF_TF_WIDTH];
  P.width = pi[OI_WIDTH];
  P.height = pi[OI_HEIGHT];
  P.first_sample = pi[OI_FIRST_SAMPLE];
  P.n_passes = pi[OI_N_PASSES];
  P.bounces = pi[OI_BOUNCES];
  P.seed = uint32_t(pi[OI_SEED]);
  P.show_env = pi[OI_SHOW_ENV];
  P.max_steps = pi[OI_MAX_STEPS];
  P.env_h = pi[OI_ENV_H];
  P.env_w = pi[OI_ENV_W];
  P.imp_levels = pi[OI_IMP_LEVELS];
  P.imp_dim = pi[OI_IMP_DIM];
  P.tf_size = pi[OI_TF_SIZE];
  if (P.imp_levels < 2 || P.imp_levels > MAX_IMP_LEVELS || P.imp_dim != 1 << (P.imp_levels - 1) ||
      P.first_sample < 1 || P.n_passes < 0)
    return int(cudaErrorInvalidValue);
  int off = 0;
  for (int m = 0; m < P.imp_levels; ++m) {
    P.imp_off[m] = off;
    off += (P.imp_dim >> m) * (P.imp_dim >> m);
  }
  Tables T;
  read_grid(T.dens, atlas, slot, lo, hi, mip, pi + OI_N_BRICKS);
  for (int k = 0; k < 12; ++k) T.dens.mip_dims[k] = pi[OI_MIP_DIMS + k];
  for (int k = 0; k < 4; ++k) T.dens.mip_offsets[k] = pi[OI_MIP_OFFSETS + k];
  read_grid(T.emi, emi_atlas, emi_slot, emi_lo, emi_hi, nullptr, pi + OI_EMI_N_BRICKS);
  T.env = static_cast<const float*>(env);
  T.imp = static_cast<const float*>(imp);
  T.tf_lut = static_cast<const float*>(tf_lut);
  T.capped = static_cast<unsigned*>(capped);
  const bool use_tf = P.tf_size > 0, has_emi = pi[OI_EMI_N_SLOTS] > 0;
  if ((use_tf && !tf_lut) || (has_emi && !(emi_atlas && emi_slot && emi_lo && emi_hi)) ||
      !next_group || (stats && !btimes))
    return int(cudaErrorInvalidValue);
  if (P.width <= 0 || P.height <= 0 || P.n_passes == 0) return 0;
  const Launch L = launch_shape(P.width, P.height, P.n_passes, use_dda != 0, use_tf, has_emi,
                                stats != nullptr);
  P.tile_w = L.tile_w;
  P.tile_h = L.tile_h;
  P.tiles_x = (P.width + P.tile_w - 1) / P.tile_w;
  P.n_groups = L.n_groups;
  pick_kernel(use_dda != 0, use_tf, has_emi, stats != nullptr)<<<
      L.blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, T, static_cast<const float*>(fb_in), static_cast<float*>(fb_out),
      static_cast<int*>(next_group), static_cast<unsigned long long*>(stats),
      static_cast<unsigned long long*>(btimes));
  return int(cudaGetLastError());
}
