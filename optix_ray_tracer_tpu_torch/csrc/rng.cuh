// Shared device code of the bounce loop's kernels (rng.cu: H and I;
// scatter.cu: J): the counter RNG of utils/rng.py (PCG4D) and the
// Owen-scrambled Sobol pads of utils/qmc.py, on native uint32, so that
// the three kernels draw one stream from one source.
//
// The plain versions hold the uint32 lanes in int64 tensors masked to 32
// bits; here they are unsigned ints, whose arithmetic wraps mod 2^32 by
// definition, so every lane is bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>

// One argument of the RNG: an int32 or int64 tensor of the output's
// shape (element i, low 32 bits taken) or a value passed by value
// (ops/kernels/bounce.lane_args decides which).
#define ORT_LANE_VALUE 0
#define ORT_LANE_I32 1
#define ORT_LANE_I64 2

struct OrtLane {
  const void* p;
  int kind;
  unsigned v;
};

__host__ __forceinline__ OrtLane ort_make_lane(const void* p, int kind,
                                               unsigned v) {
  OrtLane l;
  l.p = p;
  l.kind = kind;
  l.v = v;
  return l;
}

__device__ __forceinline__ unsigned ort_lane(const OrtLane& l, long long i) {
  if (l.kind == ORT_LANE_I32)
    return static_cast<unsigned>(__ldg(static_cast<const int*>(l.p) + i));
  if (l.kind == ORT_LANE_I64)
    return static_cast<unsigned>(
        __ldg(static_cast<const long long*>(l.p) + i));
  return l.v;
}

// PCG4D (Jarzynski & Olano 2020), utils/rng.pcg4d_plain step for step.
__device__ __forceinline__ void ort_pcg4d_hash(unsigned& x, unsigned& y,
                                               unsigned& z, unsigned& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

// uint32 -> float32 in [0, 1) from the top 24 bits (both steps exact).
__device__ __forceinline__ float ort_unit_float(unsigned u) {
  return __uint2float_rn(u >> 8) * 5.9604644775390625e-8f;   // 2^-24
}

// Laine-Karras hash (Burley 2020, listing 4), utils/qmc._laine_karras.
__device__ __forceinline__ unsigned ort_laine_karras(unsigned x,
                                                     unsigned seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

// Nested uniform (Owen) scramble, utils/qmc.owen_scramble.
__device__ __forceinline__ unsigned ort_owen(unsigned x, unsigned seed) {
  return __brev(ort_laine_karras(__brev(x), seed));
}

// Raw Sobol point of idx in dimension dim from the (32, 4) direction
// table dirs (row j, column dim: utils/qmc._DIRECTIONS[:, :4]): the XOR
// of the rows of idx's set bits, the same XOR as the plain version's
// 32-step loop in any order.
__device__ __forceinline__ unsigned ort_sobol(unsigned idx, int dim,
                                              const unsigned* __restrict__ dirs) {
  unsigned acc = 0u;
  while (idx) {
    const int j = __ffs(static_cast<int>(idx)) - 1;
    acc ^= __ldg(dirs + 4 * j + dim);
    idx &= idx - 1u;
  }
  return acc;
}

// The first NDIMS of utils/qmc.sobol_owen4_plain's four uniforms: PCG4D
// seeds from (pixel, bounce, seed, 0x9E3779B9), one Owen index shuffle of
// the sample, then per dimension a Sobol point and its own scramble
// (seeds s0, s1, s2, s0 ^ s1).
template <int NDIMS>
__device__ __forceinline__ void ort_sobol_owen(
    unsigned pix, unsigned sample, unsigned bounce, unsigned seed,
    const unsigned* __restrict__ dirs, float* out) {
  unsigned s_shuf = pix, s0 = bounce, s1 = seed, s2 = 0x9E3779B9u;
  ort_pcg4d_hash(s_shuf, s0, s1, s2);
  const unsigned idx = ort_owen(sample, s_shuf);
  const unsigned seeds[4] = {s0, s1, s2, s0 ^ s1};
#pragma unroll
  for (int i = 0; i < NDIMS; ++i)
    out[i] = ort_unit_float(ort_owen(ort_sobol(idx, i, dirs), seeds[i]));
}

// The first NDIMS of utils/rng.uniform4's four uniforms by sampler:
// 0 PCG4D, 1 Sobol (ORT_SAMPLER_*).
#define ORT_SAMPLER_PCG 0
#define ORT_SAMPLER_SOBOL 1

template <int NDIMS>
__device__ __forceinline__ void ort_uniform(int sampler, unsigned pix,
                                            unsigned sample, unsigned bounce,
                                            unsigned seed,
                                            const unsigned* __restrict__ dirs,
                                            float* out) {
  if (sampler == ORT_SAMPLER_SOBOL) {
    ort_sobol_owen<NDIMS>(pix, sample, bounce, seed, dirs, out);
    return;
  }
  unsigned x = pix, y = sample, z = bounce, w = seed;
  ort_pcg4d_hash(x, y, z, w);
  const unsigned u[4] = {x, y, z, w};
#pragma unroll
  for (int i = 0; i < NDIMS; ++i) out[i] = ort_unit_float(u[i]);
}
