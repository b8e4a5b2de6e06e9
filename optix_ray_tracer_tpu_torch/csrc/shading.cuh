// Shared float helpers of the bounce loop's shading kernels (scatter.cu:
// J; path_scatter.cu: K; path_nee.cu: L, N): utils/vecmath and the sphere / hemisphere
// samples of utils/rng, each in the plain version's order of operations.
// Built with -fmad=false, so nothing is contracted; with torch's own
// CUDA rounding: clamps pass NaN through, 1 / x is an IEEE divide, ** 5
// is powf, cos and sin are taken in double and rounded to float
// (rng._cos_sin).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ort {

// vecmath.PI (3.1415926); (2 * vecmath.PI) as the plain version's float32
// multiply rounds it; torch's CUDA x / PI, x times the float reciprocal
constexpr float kPi = static_cast<float>(3.1415926);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.1415926);
constexpr float kInvPi = 1.0f / static_cast<float>(3.1415926);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p,
                                    long long i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ void store3(float* __restrict__ p, long long i,
                                       V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// torch.clamp(x, min=lo) / (x, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// vecmath.dot: a0 b0 + a1 b1, then + a2 b2
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// vecmath.normalize (eps 0): zero vectors map to zero
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float n2 = dot3(v, v);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(clamp_min(n2, 1e-30f)) : 0.0f;
  return {v.x * inv, v.y * inv, v.z * inv};
}

// vecmath.reflect: v - (2 dot(v, n)) n
__device__ __forceinline__ V3 reflect3(V3 v, V3 n) {
  const float k = 2.0f * dot3(v, n);
  return {v.x - k * n.x, v.y - k * n.y, v.z - k * n.z};
}

// vecmath.refract
__device__ __forceinline__ V3 refract3(V3 uv, V3 n, float eta) {
  const float ct = clamp_max(-dot3(uv, n), 1.0f);
  const V3 rp = {eta * (uv.x + ct * n.x), eta * (uv.y + ct * n.y),
                 eta * (uv.z + ct * n.z)};
  const float s = -sqrtf(fabsf(1.0f - dot3(rp, rp)));
  return {rp.x + s * n.x, rp.y + s * n.y, rp.z + s * n.z};
}

// vecmath.schlick_fresnel: ** 2 is a square, ** 5 torch's powf
__device__ __forceinline__ float schlick(float c, float ior) {
  const float q = (1.0f - ior) / (1.0f + ior);
  const float r0 = q * q;
  return r0 + (1.0f - r0) * powf(1.0f - c, 5.0f);
}

// rng.unit_vector_from: the z / phi sphere point of (u1, u2), cos and sin
// in double rounded to float as rng._cos_sin takes them
__device__ __forceinline__ V3 unit_vector(float u1, float u2) {
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const double phi = static_cast<double>(kTwoPi * u2);
  const float c = static_cast<float>(cos(phi));
  const float s = static_cast<float>(sin(phi));
  return {r * c, r * s, z};
}

// rng.cosine_direction_from: the cosine-weighted hemisphere point about
// +z of (u1, u2)
__device__ __forceinline__ V3 cosine_direction(float u1, float u2) {
  const double phi = static_cast<double>(kTwoPi * u1);
  const float c = static_cast<float>(cos(phi));
  const float s = static_cast<float>(sin(phi));
  const float sq = sqrtf(u2);
  return {c * sq, s * sq, sqrtf(clamp_min(1.0f - u2, 0.0f))};
}

}  // namespace ort
