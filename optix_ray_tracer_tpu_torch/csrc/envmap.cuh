// The environment map's lookups on the card (render/envmap.EnvMap), each
// in the plain version's order of operations and with torch's CUDA
// rounding: atan2, acos, sin and cos of float32 tensors are the CUDA
// atan2f, acosf, sinf and cosf; a division by a Python scalar is a
// multiply by its float reciprocal; a float -> int64 conversion
// truncates; torch.remainder is a floor-mod.  Used by path_nee.cu (L,
// N).  The tables are small (config 5's sky: 64 x 128 texels) and stay in
// L2, so every read is an __ldg.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "shading.cuh"

namespace ort {

// torch's x / (2 PI): x times this float reciprocal; 2.0 * PI * PI,
// folded in double, then the scalar operand
constexpr float kInvTwoPi = 1.0f / static_cast<float>(2.0 * 3.1415926);
constexpr float kTwoPiPi = static_cast<float>(2.0 * 3.1415926 * 3.1415926);
constexpr int kEnvBlock = 128;   // EnvMap.BLOCK

// torch.searchsorted's left side over n sorted entries: the first index
// whose entry is >= u (n when none is), torch's test included.
__device__ __forceinline__ int lower_bound(const float* __restrict__ a, int n,
                                           float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(a + mid) >= u))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                              long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The longitude / colatitude of a direction: phi = atan2(y, x), theta =
// acos(clamp(z, -1, 1)).
struct Angles {
  float phi, theta;
};

__device__ __forceinline__ Angles angles(V3 d) {
  const float z = isnan(d.z) ? d.z : fminf(fmaxf(d.z, -1.0f), 1.0f);
  return {atan2f(d.y, d.x), acosf(z)};
}

// EnvMap.sample: the bilinear lookup of img (h, w, 3) at the angles of a
// direction.
__device__ __forceinline__ V3 env_lookup(const float* __restrict__ img,
                                         int h, int w, Angles a) {
  const float u = (a.phi * kInvTwoPi + 0.5f) * static_cast<float>(w) - 0.5f;
  const float v = (a.theta * kInvPi) * static_cast<float>(h) - 0.5f;
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = u - u0, fv = v - v0;
  const long long u0i = floor_mod(static_cast<long long>(u0), w);
  const long long u1i = floor_mod(u0i + 1, w);
  const long long v0i = clamp_ll(static_cast<long long>(v0), 0, h - 1);
  const long long v1i = clamp_ll(v0i + 1, 0, h - 1);
  const V3 c00 = load3(img, v0i * w + u0i), c01 = load3(img, v0i * w + u1i);
  const V3 c10 = load3(img, v1i * w + u0i), c11 = load3(img, v1i * w + u1i);
  const float gu = 1.0f - fu, gv = 1.0f - fv;
  const V3 top = {c00.x * gu + c01.x * fu, c00.y * gu + c01.y * fu,
                  c00.z * gu + c01.z * fu};
  const V3 bot = {c10.x * gu + c11.x * fu, c10.y * gu + c11.y * fu,
                  c10.z * gu + c11.z * fu};
  return {top.x * gv + bot.x * fv, top.y * gv + bot.y * fv,
          top.z * gv + bot.z * fv};
}

// EnvMap.pdf_solid_angle at the angles of a direction: the texel's pdf
// over 2 pi^2 sin(theta).
__device__ __forceinline__ float env_pdf(const float* __restrict__ pdf_tex,
                                         int h, int w, Angles a) {
  const float u = a.phi * kInvTwoPi + 0.5f;
  const float v = a.theta * kInvPi;
  const long long xi = clamp_ll(
      static_cast<long long>(u * static_cast<float>(w)), 0, w - 1);
  const long long yi = clamp_ll(
      static_cast<long long>(v * static_cast<float>(h)), 0, h - 1);
  return __ldg(pdf_tex + yi * w + xi) /
         (kTwoPiPi * clamp_min(sinf(a.theta), 1e-6f));
}

// EnvMap.sample_direction: the two-level CDF's texel for (ub, ut) (a
// left lower bound over the nb block entries, then the 7-step lower bound
// in the block's row of cond_cdf), jittered by (uj, vj); the direction
// and its solid-angle pdf.
__device__ __forceinline__ V3 env_sample_direction(
    const float* __restrict__ block_cdf, const float* __restrict__ cond_cdf,
    const float* __restrict__ pdf_tex, int nb, int h, int w, float ub,
    float ut, float uj, float vj, float* pdf) {
  int blk = lower_bound(block_cdf, nb, ub);
  blk = blk > nb - 1 ? nb - 1 : blk;
  int j = 0;
#pragma unroll
  for (int step = kEnvBlock / 2; step >= 1; step >>= 1) {
    const int t = j + step;
    if (__ldg(cond_cdf + blk * kEnvBlock + (t - 1)) < ut) j = t;
  }
  const long long idx =
      clamp_ll(static_cast<long long>(blk) * kEnvBlock + j, 0,
               static_cast<long long>(h) * w - 1);
  const long long y = idx / w;
  const long long x = idx - y * w;
  const float u =
      (static_cast<float>(x) + uj) * (1.0f / static_cast<float>(w));
  const float v =
      (static_cast<float>(y) + vj) * (1.0f / static_cast<float>(h));
  const float theta = v * kPi;
  const float phi = (u - 0.5f) * kTwoPi;
  const float st = sinf(theta);
  *pdf = __ldg(pdf_tex + idx) / (kTwoPiPi * clamp_min(st, 1e-6f));
  return {st * cosf(phi), st * sinf(phi), cosf(theta)};
}

}  // namespace ort
