// The bounce loop's counter RNG: kernels H (PCG4D) and I (Owen-scrambled
// Sobol), the draws of utils/rng.uniform4 and utils/qmc.sobol_owen4.
//
// No TPU kernel is replaced: the JAX package leaves these hashes to XLA,
// which fuses them into the bounce step's programs
// (optix_ray_tracer_tpu/utils/rng.py pcg4d, uniform4;
// optix_ray_tracer_tpu/utils/qmc.py sobol_owen4).  Eager PyTorch has no
// full uint32 arithmetic, so the plain versions emulate each 32-bit
// product in int64 (about 110 launches per PCG4D draw, a 32-step loop per
// Sobol point).  Here one thread computes one element's four lanes from
// its (pixel, sample, bounce, seed) in registers.
//
// What bounds them on the H100: bytes.  An element reads its tensor
// arguments (two int64 ids on the main path: 16 bytes) and writes four
// 4-byte uniforms (or four int64 lanes); its integer work, ~50 operations
// for H and ~120 for I, is below the bytes' time.  So the design is the
// plain one: one element per thread, coalesced loads of each tensor
// argument, the scalars (bounce, seed) passed by value, the four outputs
// as four contiguous rows (the plain version's four tensors).  I's Sobol
// points come from the per-byte tables (rng.cuh), which each block of a
// resident grid stages once in shared memory: four 16-byte lookups per
// element, where a walk over the index's set bits would wait, per
// dimension, on one dependent load per bit of its warp's longest index
// (PERF.md).
#include "rng.cuh"

namespace {

constexpr int kThreads = 256;

__host__ int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

// H: PCG4D of (a, b, c, d); AS_INT writes the four uint32 lanes as int64
// (utils/rng.pcg4d), else the four uniforms (utils/rng.uniform4).
template <bool AS_INT>
__global__ void __launch_bounds__(kThreads)
    pcg4d_kernel(OrtLane a, OrtLane b, OrtLane c, OrtLane d, long long n,
                 float* __restrict__ out_f, long long* __restrict__ out_i) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    unsigned x = ort_lane(a, i), y = ort_lane(b, i), z = ort_lane(c, i),
             w = ort_lane(d, i);
    ort_pcg4d_hash(x, y, z, w);
    if (AS_INT) {
      out_i[i] = x;
      out_i[n + i] = y;
      out_i[2 * n + i] = z;
      out_i[3 * n + i] = w;
    } else {
      out_f[i] = ort_unit_float(x);
      out_f[n + i] = ort_unit_float(y);
      out_f[2 * n + i] = ort_unit_float(z);
      out_f[3 * n + i] = ort_unit_float(w);
    }
  }
}

// I: the four Sobol-Owen uniforms of (pixel, sample, bounce, seed).
__global__ void __launch_bounds__(kThreads)
    sobol_owen4_kernel(OrtLane pix, OrtLane sample, OrtLane bounce,
                       OrtLane seed, long long n,
                       const uint4* __restrict__ tables,
                       float* __restrict__ out) {
  __shared__ uint4 tab[ORT_SOBOL_ROWS];
  ort_stage_sobol(tables, tab);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    float u[4];
    ort_sobol_owen<4>(ort_lane(pix, i), ort_lane(sample, i),
                      ort_lane(bounce, i), ort_lane(seed, i), tab, u);
    out[i] = u[0];
    out[n + i] = u[1];
    out[2 * n + i] = u[2];
    out[3 * n + i] = u[3];
  }
}

}  // namespace

// Each lane argument is (pointer, kind, value): see OrtLane.  out is
// (4, n): float32 uniforms, or int64 lanes with as_int.
extern "C" int ort_pcg4d(const void* ap, int ak, unsigned av, const void* bp,
                         int bk, unsigned bv, const void* cp, int ck,
                         unsigned cv, const void* dp, int dk, unsigned dv,
                         long long n, int as_int, void* out, void* stream) {
  const OrtLane a = ort_make_lane(ap, ak, av), b = ort_make_lane(bp, bk, bv),
                c = ort_make_lane(cp, ck, cv), d = ort_make_lane(dp, dk, dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (as_int)
    pcg4d_kernel<true><<<grid_for(n), kThreads, 0, s>>>(
        a, b, c, d, n, nullptr, static_cast<long long*>(out));
  else
    pcg4d_kernel<false><<<grid_for(n), kThreads, 0, s>>>(
        a, b, c, d, n, static_cast<float*>(out), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// tables: the (1024, 4) per-byte Sobol tables (rng.cuh).
extern "C" int ort_sobol_owen4(const void* ap, int ak, unsigned av,
                               const void* bp, int bk, unsigned bv,
                               const void* cp, int ck, unsigned cv,
                               const void* dp, int dk, unsigned dv,
                               long long n, const uint4* tables, float* out,
                               void* stream) {
  static std::atomic<int> fit[ORT_MAX_DEVICES];
  int grid = 0;
  const cudaError_t e =
      ort_resident_grid(sobol_owen4_kernel, n, kThreads, 0, fit, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  sobol_owen4_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ort_make_lane(ap, ak, av), ort_make_lane(bp, bk, bv),
      ort_make_lane(cp, ck, cv), ort_make_lane(dp, dk, dv), n, tables, out);
  return static_cast<int>(cudaGetLastError());
}
