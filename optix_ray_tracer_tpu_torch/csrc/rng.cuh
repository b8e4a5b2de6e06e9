// Shared device code of the bounce loop's kernels (rng.cu: H and I;
// scatter.cu: J; path_scatter.cu: K): the counter RNG of utils/rng.py
// (PCG4D) and the Owen-scrambled Sobol pads of utils/qmc.py, on native
// uint32, so that the kernels draw one stream from one source.
//
// The plain versions hold the uint32 lanes in int64 tensors masked to 32
// bits; here they are unsigned ints, whose arithmetic wraps mod 2^32 by
// definition, so every lane is bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

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

// The per-byte Sobol tables (utils/qmc.sobol_byte_tables): row 256 k + v
// holds, for dimensions 0-3, the XOR of the direction rows 8 k + j of the
// set bits j of v, so the raw Sobol point of an index is the XOR of the
// four rows its bytes select: the plain version's 32-step XOR, in another
// order, which XOR does not see.  A kernel that draws from the Sobol
// sampler stages them in shared memory (16 KB) with ort_stage_sobol and
// passes the staged copy to the draws: four 16-byte lookups per index,
// where a loop over the index's set bits waited for its warp's longest
// (~22 bits, four loops of dependent loads; PERF.md).
#define ORT_SOBOL_ROWS 1024
#define ORT_SOBOL_BYTES (ORT_SOBOL_ROWS * 16)

// Every thread of the block calls it, before any draw.
__device__ __forceinline__ void ort_stage_sobol(const uint4* __restrict__ g,
                                                uint4* s) {
  for (int k = threadIdx.x; k < ORT_SOBOL_ROWS; k += blockDim.x)
    s[k] = __ldg(g + k);
  __syncthreads();
}

// The raw Sobol points of idx in dimensions 0-3 from the staged tables.
__device__ __forceinline__ uint4 ort_sobol(unsigned idx, const uint4* tab) {
  const uint4 a = tab[idx & 255u], b = tab[256 + ((idx >> 8) & 255u)],
              c = tab[512 + ((idx >> 16) & 255u)], d = tab[768 + (idx >> 24)];
  return make_uint4(a.x ^ b.x ^ c.x ^ d.x, a.y ^ b.y ^ c.y ^ d.y,
                    a.z ^ b.z ^ c.z ^ d.z, a.w ^ b.w ^ c.w ^ d.w);
}

// The first NDIMS of utils/qmc.sobol_owen4_plain's four uniforms: PCG4D
// seeds from (pixel, bounce, seed, 0x9E3779B9), one Owen index shuffle of
// the sample, then per dimension a Sobol point and its own scramble
// (seeds s0, s1, s2, s0 ^ s1).
template <int NDIMS>
__device__ __forceinline__ void ort_sobol_owen(unsigned pix, unsigned sample,
                                               unsigned bounce, unsigned seed,
                                               const uint4* tab, float* out) {
  unsigned s_shuf = pix, s0 = bounce, s1 = seed, s2 = 0x9E3779B9u;
  ort_pcg4d_hash(s_shuf, s0, s1, s2);
  const uint4 p = ort_sobol(ort_owen(sample, s_shuf), tab);
  const unsigned raw[4] = {p.x, p.y, p.z, p.w};
  const unsigned seeds[4] = {s0, s1, s2, s0 ^ s1};
#pragma unroll
  for (int i = 0; i < NDIMS; ++i)
    out[i] = ort_unit_float(ort_owen(raw[i], seeds[i]));
}

// The first NDIMS of utils/rng.uniform4's four uniforms by sampler:
// 0 PCG4D, 1 Sobol (ORT_SAMPLER_*).
#define ORT_SAMPLER_PCG 0
#define ORT_SAMPLER_SOBOL 1

// tab: the staged Sobol tables (read with sampler 1 only).
template <int NDIMS>
__device__ __forceinline__ void ort_uniform(int sampler, unsigned pix,
                                            unsigned sample, unsigned bounce,
                                            unsigned seed, const uint4* tab,
                                            float* out) {
  if (sampler == ORT_SAMPLER_SOBOL) {
    ort_sobol_owen<NDIMS>(pix, sample, bounce, seed, tab, out);
    return;
  }
  unsigned x = pix, y = sample, z = bounce, w = seed;
  ort_pcg4d_hash(x, y, z, w);
  const unsigned u[4] = {x, y, z, w};
#pragma unroll
  for (int i = 0; i < NDIMS; ++i) out[i] = ort_unit_float(u[i]);
}

// The grid of a grid-stride kernel that stages the Sobol tables: one
// block per `threads` elements, at most the blocks the device holds at
// once, so that each resident block stages them once.  `fit` is the
// caller's cache of that number of blocks per device (0 until the first
// launch there), so the occupancy query runs once per kernel and device.
// Returns the error of a failed query, with the runtime's last error
// cleared.
#define ORT_MAX_DEVICES 64

template <typename Kernel>
__host__ cudaError_t ort_resident_grid(Kernel kernel, long long n,
                                       int threads, size_t dynamic_smem,
                                       std::atomic<int>* fit, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  int most = e == cudaSuccess && dev < ORT_MAX_DEVICES
                 ? fit[dev].load(std::memory_order_relaxed)
                 : 0;
  if (e == cudaSuccess && most == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dynamic_smem);
    most = sms * (per_sm > 0 ? per_sm : 1);
    if (e == cudaSuccess && dev < ORT_MAX_DEVICES)
      fit[dev].store(most, std::memory_order_relaxed);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  const long long need = (n + threads - 1) / threads;
  *grid = static_cast<int>(need < most ? need : most);
  return cudaSuccess;
}
