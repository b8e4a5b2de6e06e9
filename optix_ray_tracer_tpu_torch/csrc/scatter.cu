// The Whitted scatter of the bounce loop: kernel J, the work of
// render/wavefront.scatter (the material switch of the reference's
// closest-hit shader) for one bounce wave.
//
// No TPU kernel is replaced: the JAX package's scatter
// (optix_ray_tracer_tpu/render/wavefront.py:59) is plain jnp, which XLA
// fuses into the bounce step.  The plain version (wavefront.scatter_plain)
// evaluates every BSDF branch for every ray and blends them by masks, in
// some hundred eager launches per wave with three RNG draws among them.
// Here one thread takes one ray: the clamped material gather, then only
// the branch its material selects, with that branch's one draw (H's or
// I's stream from rng.cuh), the non-finite fallback and the outputs.  A
// branch the masks discard cannot change a selected value, so skipping it
// keeps every output bit-equal.
//
// Exactness: every float step is the plain version's operation in its
// order (dot products left to right, normalize as v * (1 / sqrt(max(n2,
// 1e-30))) under the n2 > 0 guard, clamps that pass NaN through as
// torch.clamp does, the Schlick fifth power as powf as torch's CUDA pow
// computes it, cos and sin in double rounded to float), and the library
// is built with -fmad=false, so nothing is contracted.
//
// What bounds it on the H100: bytes.  A ray reads its material id, d_in,
// normal, front flag and two int64 ids (45 bytes) and writes new_dir,
// attenuation, emission and terminate (37 bytes); its arithmetic (~60
// float32 operations, two double cos/sin, ~50 integer operations for a
// PCG draw) is a small fraction of that time.
#include <math.h>

#include "rng.cuh"
#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kDimScatter = 0x1E3779B9u;   // wavefront._DIM_SCATTER
constexpr unsigned kDimFuzz = 0x05EBCA6Bu;      // wavefront._DIM_FUZZ
constexpr unsigned kDimFresnel = 0x42B2AE35u;   // wavefront._DIM_FRESNEL
constexpr float kEps = 1e-6f;                   // vecmath.EPS
constexpr int kMetal = 1, kDielectric = 2, kEmissive = 3;

using namespace ort;

// the fallback test: a non-finite component or length^2 <= EPS
__device__ __forceinline__ bool bad_dir(V3 v) {
  return !(isfinite(v.x) && isfinite(v.y) && isfinite(v.z)) ||
         dot3(v, v) <= kEps;
}

template <int SAMPLER>
__global__ void __launch_bounds__(kThreads) whitted_scatter_kernel(
    const void* __restrict__ mid, int mid_kind, const float* __restrict__ d_in,
    const float* __restrict__ normal, const bool* __restrict__ front_face,
    OrtLane pix, OrtLane sample, OrtLane bounce, OrtLane seed, long long n,
    const uint4* __restrict__ tables, const int* __restrict__ mtypes,
    const float* __restrict__ albedos, const float* __restrict__ params,
    const float* __restrict__ emissions, int n_mat,
    float* __restrict__ new_dir, float* __restrict__ attenuation,
    float* __restrict__ emission, bool* __restrict__ terminate) {
  extern __shared__ uint4 tab[];   // the Sobol tables (Sobol only)
  if (SAMPLER == ORT_SAMPLER_SOBOL) ort_stage_sobol(tables, tab);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    long long m = mid_kind == ORT_LANE_I32
                      ? __ldg(static_cast<const int*>(mid) + i)
                      : __ldg(static_cast<const long long*>(mid) + i);
    m = m < 0 ? 0 : (m > n_mat - 1 ? n_mat - 1 : m);
    const int mtype = __ldg(mtypes + m);
    const float param = __ldg(params + m);
    const V3 din = load3(d_in, i);
    const V3 nn = normalize3(load3(normal, i));
    const unsigned p = ort_lane(pix, i), s = ort_lane(sample, i),
                   b = ort_lane(bounce, i), sd = ort_lane(seed, i);
    V3 nd;
    if (mtype == kDielectric) {
      const float ior = param > 0.0f ? param : 1.5f;
      const float eta = front_face[i] ? 1.0f / ior : ior;
      const float ct = clamp_max(-dot3(din, nn), 1.0f);
      const float st = sqrtf(clamp_min(1.0f - ct * ct, 0.0f));
      float u;
      ort_uniform<1>(SAMPLER, p, s, b, sd ^ kDimFresnel, tab, &u);
      const bool reflects = (eta * st > 1.0f) || (schlick(ct, ior) > u);
      nd = reflects ? normalize3(reflect3(din, nn)) : refract3(din, nn, eta);
    } else if (mtype == kMetal) {
      float u[2];
      ort_uniform<2>(SAMPLER, p, s, b, sd ^ kDimFuzz, tab, u);
      const V3 fz = unit_vector(u[0], u[1]);
      const V3 mr = normalize3(reflect3(din, nn));
      nd = {mr.x + param * fz.x, mr.y + param * fz.y, mr.z + param * fz.z};
    } else {   // ROUGH, and EMISSIVE (its direction is never followed)
      float u[2];
      ort_uniform<2>(SAMPLER, p, s, b, sd ^ kDimScatter, tab, u);
      const V3 ru = unit_vector(u[0], u[1]);
      nd = {nn.x + ru.x, nn.y + ru.y, nn.z + ru.z};
      if (dot3(nd, nd) < kEps) nd = nn;
    }
    if (bad_dir(nd)) nd = nn;
    if (bad_dir(nd)) nd = {0.0f, 0.0f, 1.0f};
    store3(new_dir, i, normalize3(nd));
    store3(attenuation, i,
           mtype == kDielectric ? V3{1.0f, 1.0f, 1.0f} : load3(albedos, m));
    store3(emission, i, load3(emissions, m));
    terminate[i] = mtype == kEmissive;
  }
}

}  // namespace

// J.  mid: int32 (mid_kind ORT_LANE_I32) or int64 material ids; d_in,
// normal (n, 3) float32; front_face (n,) bool; the four RNG lanes as in
// rng.cu; tables the (1024, 4) per-byte Sobol tables (read with sampler 1
// only, staged per block of a resident grid); the
// material table's mtype (M,) int32, albedo (M, 3), param (M,), emission
// (M, 3).  Outputs new_dir, attenuation, emission (n, 3), terminate (n,).
extern "C" int ort_whitted_scatter(
    const void* mid, int mid_kind, const float* d_in, const float* normal,
    const bool* front_face, const void* ap, int ak, unsigned av,
    const void* bp, int bk, unsigned bv, const void* cp, int ck, unsigned cv,
    const void* dp, int dk, unsigned dv, long long n, int sampler,
    const uint4* tables, const int* mtypes, const float* albedos,
    const float* params, const float* emissions, int n_mat, float* new_dir,
    float* attenuation, float* emission, bool* terminate, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1LL << 20) ? blocks
                                                         : (1LL << 20));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const OrtLane a = ort_make_lane(ap, ak, av), b = ort_make_lane(bp, bk, bv),
                c = ort_make_lane(cp, ck, cv), d = ort_make_lane(dp, dk, dv);
  if (sampler == ORT_SAMPLER_SOBOL) {
    auto kernel = whitted_scatter_kernel<ORT_SAMPLER_SOBOL>;
    static std::atomic<int> fit[ORT_MAX_DEVICES];
    int sgrid = 0;
    const cudaError_t e =
        ort_resident_grid(kernel, n, kThreads, ORT_SOBOL_BYTES, fit, &sgrid);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<sgrid, kThreads, ORT_SOBOL_BYTES, st>>>(
        mid, mid_kind, d_in, normal, front_face, a, b, c, d, n, tables,
        mtypes, albedos, params, emissions, n_mat, new_dir, attenuation,
        emission, terminate);
  } else {
    whitted_scatter_kernel<ORT_SAMPLER_PCG><<<grid, kThreads, 0, st>>>(
        mid, mid_kind, d_in, normal, front_face, a, b, c, d, n, tables,
        mtypes, albedos, params, emissions, n_mat, new_dir, attenuation,
        emission, terminate);
  }
  return static_cast<int>(cudaGetLastError());
}
