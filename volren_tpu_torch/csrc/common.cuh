// Device helpers that csrc/megakernel.cu and csrc/oracle.cu share, bit
// for bit: constants, NaN-propagating min / max, the TEA seed hash, the
// masked LCG draw, and small float functions whose operation order
// follows the plain torch versions (ops/rng.py, ops/geometry.py,
// ops/phase.py). Both kernels are built with -fmad=false, so each
// expression rounds operation by operation as torch does.

#pragma once

#include <stdint.h>

namespace {

constexpr double PI_D = 3.14159265358979323846;
constexpr float INV_4PI = float(1.0 / (4.0 * PI_D));
constexpr float TWO_PI = float(2.0 * PI_D);
constexpr float SIXTH = float(1.0 / 6.0);
constexpr float INV_255 = float(1.0 / 255.0);
constexpr float INV_2_24 = float(1.0 / 16777216.0);
// upper clamp of the TF window coordinate (ops/transfer.py WINDOW_MAX)
constexpr float TF_WINDOW_MAX = float(1.0 - 1e-6);

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
// advances the stream (rng_masked)
__device__ __forceinline__ float rng(uint32_t& seed, bool active) {
  const uint32_t nxt = seed * 1664525u + 1013904223u;
  const float u = float(nxt & 0x00FFFFFFu) * INV_2_24;
  if (active) seed = nxt;
  return u;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float luma(const float c[3]) {
  return c[0] * 0.212671f + c[1] * 0.715160f + c[2] * 0.072169f;
}

__device__ __forceinline__ float sanitize(float x) {
  return isfinite(x) ? x : 0.0f;
}

// the Henyey-Greenstein phase function (phase.hg_phase)
__device__ __forceinline__ float hg_phase(float cos_t, float g) {
  const float denom = 1.0f + g * g + 2.0f * g * cos_t;
  return INV_4PI * (1.0f - g * g) / (denom * sqrtf(vmax(denom, 1e-12f)));
}

}  // namespace
