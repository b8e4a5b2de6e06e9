// The path tracer's BSDF step: kernel K, the work of
// render/pathtracer.bsdf_step for one bounce wave.
//
// No TPU kernel is replaced: the JAX package's step
// (optix_ray_tracer_tpu/render/pathtracer.py:326-384) is plain jnp, which
// XLA fuses into the bounce step.  The plain version
// (pathtracer.bsdf_step_plain) evaluates every lobe for every ray and
// blends them by masks: the cosine lobe about Frisvad's basis with its
// pdf, the metal mirror plus fuzz, the dielectric's Schlick choice between
// reflection and refraction, the normalised direction, the attenuation,
// Russian roulette and the +-1e-3 offset, in some hundred and fifty eager
// launches per wave with three RNG draws among them.  Here one thread
// takes one ray: only the lobe its material selects, with only that
// lobe's draw (_DIM_BSDF lanes 0-1 for ROUGH and EMISSIVE, _DIM_LOBE lanes
// 0-1 for METAL's fuzz, lane 1 of the same draw for DIELECTRIC's Fresnel
// choice), then _DIM_RR lane 0 where roulette applies, all through
// rng.cuh.  A lobe the masks discard cannot change a selected value, so
// skipping it keeps every output bit-equal.
//
// Exactness: every float step is the plain version's operation in its
// order (shading.cuh), -1 / x as torch's reciprocal times -1, x / PI as
// torch's CUDA division by a scalar (x times the float reciprocal of PI),
// the largest throughput channel as amax (NaN wins) and the continuation
// probability as torch.clamp(.., 0.05, 1.0); the library is built with
// -fmad=false, so nothing is contracted.
//
// What bounds it on the H100: bytes.  A ray writes o, d and throughput
// (36 bytes), prev_pdf (4) and alive (1), and reads mtype, shading_alive
// and throughput (17); the rest it needs only on some rows: the two int64
// ids (16) where a draw is taken, n_unit and point (24) where the ray
// goes on, o (12) where it stops, d (12) where it stops or leaves a METAL
// or DIELECTRIC hit, param and front_face (5) there, albedo (12) on live
// rows.  That is 82 to 126 bytes a ray (chip_smoke.bsdf_bytes counts a
// wave's).  Its arithmetic (~120 float32 operations on the longest lobe,
// a double cos / sin, ~50 integer operations per PCG draw) is a small
// fraction of that time.
#include <math.h>

#include "rng.cuh"
#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kDimBsdf = 0x3C6EF372u;   // pathtracer._DIM_BSDF
constexpr unsigned kDimLobe = 0x165667B1u;   // pathtracer._DIM_LOBE
constexpr unsigned kDimRR = 0x2545F491u;     // pathtracer._DIM_RR
constexpr int kRough = 0, kMetal = 1, kDielectric = 2;

using namespace ort;

// pathtracer._onb: Frisvad's basis (t, b) about the unit normal n
__device__ __forceinline__ void onb(V3 n, V3& t, V3& bt) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (s + n.z)) * -1.0f;
  const float b = (n.x * n.y) * a;
  t = {1.0f + ((s * n.x) * n.x) * a, s * b, -s * n.x};
  bt = {b, s + (n.y * n.y) * a, -n.y};
}

// torch's amax over three channels: a NaN channel wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

template <int SAMPLER>
__global__ void __launch_bounds__(kThreads) path_bsdf_kernel(
    const float* __restrict__ d_in, const float* __restrict__ n_unit,
    const float* __restrict__ point, const bool* __restrict__ front_face,
    const int* __restrict__ mtype, const float* __restrict__ albedo,
    const float* __restrict__ param, const float* __restrict__ thr_in,
    const bool* __restrict__ alive_in, const float* __restrict__ o_in,
    OrtLane pix, OrtLane sample, OrtLane bounce, OrtLane seed, long long n,
    int rr, const uint4* __restrict__ tables, float* __restrict__ o_out,
    float* __restrict__ d_out, float* __restrict__ thr_out,
    float* __restrict__ pdf_out, bool* __restrict__ alive_out) {
  extern __shared__ uint4 tab[];   // the Sobol tables (Sobol only)
  if (SAMPLER == ORT_SAMPLER_SOBOL) ort_stage_sobol(tables, tab);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const int mt = __ldg(mtype + i);
    const V3 din = load3(d_in, i);
    const V3 nn = load3(n_unit, i);
    const unsigned p = ort_lane(pix, i), s = ort_lane(sample, i),
                   b = ort_lane(bounce, i), sd = ort_lane(seed, i);
    V3 nd;
    float pdf = 0.0f;
    bool refracts = false;
    if (mt == kDielectric) {
      const float prm = __ldg(param + i);
      const float ior = prm > 0.0f ? prm : 1.5f;
      const float eta = front_face[i] ? 1.0f / ior : ior;
      const float ct = clamp_max(-dot3(din, nn), 1.0f);
      const float st = sqrtf(clamp_min(1.0f - ct * ct, 0.0f));
      float u[2];
      ort_uniform<2>(SAMPLER, p, s, b, sd ^ kDimLobe, tab, u);
      const bool reflects = (eta * st > 1.0f) || (schlick(ct, ior) > u[1]);
      refracts = !reflects;
      nd = normalize3(reflects ? normalize3(reflect3(din, nn))
                               : refract3(din, nn, eta));
    } else if (mt == kMetal) {
      const float prm = __ldg(param + i);
      float u[2];
      ort_uniform<2>(SAMPLER, p, s, b, sd ^ kDimLobe, tab, u);
      const V3 fz = unit_vector(u[0], u[1]);
      const V3 mr = normalize3(reflect3(din, nn));
      nd = normalize3(normalize3(
          {mr.x + prm * fz.x, mr.y + prm * fz.y, mr.z + prm * fz.z}));
    } else {   // ROUGH, and EMISSIVE (its direction is never followed)
      float u[2];
      ort_uniform<2>(SAMPLER, p, s, b, sd ^ kDimBsdf, tab, u);
      const V3 l = cosine_direction(u[0], u[1]);
      V3 t, bt;
      onb(nn, t, bt);
      const V3 dv = {(l.x * t.x + l.y * bt.x) + l.z * nn.x,
                     (l.x * t.y + l.y * bt.y) + l.z * nn.y,
                     (l.x * t.z + l.y * bt.z) + l.z * nn.z};
      nd = normalize3(normalize3(dv));
      if (mt == kRough) pdf = clamp_min(l.z, 1e-6f) * kInvPi;
    }
    bool alive = alive_in[i];
    V3 thr = load3(thr_in, i);
    if (alive) {
      const V3 att = mt == kDielectric ? V3{1.0f, 1.0f, 1.0f}
                                       : load3(albedo, i);
      thr = {thr.x * att.x, thr.y * att.y, thr.z * att.z};
    }
    if (rr && alive) {   // Russian roulette from rr_start
      const float m = max_nan(max_nan(thr.x, thr.y), thr.z);
      const float pc = isnan(m) ? m : fminf(fmaxf(m, 0.05f), 1.0f);
      float u;
      ort_uniform<1>(SAMPLER, p, s, b, sd ^ kDimRR, tab, &u);
      thr = {thr.x / pc, thr.y / pc, thr.z / pc};
      alive = u < pc;
    }
    const float off = refracts ? -1e-3f : 1e-3f;
    const V3 pt = load3(point, i);
    store3(o_out, i,
           alive ? V3{pt.x + nn.x * off, pt.y + nn.y * off,
                      pt.z + nn.z * off}
                 : load3(o_in, i));
    store3(d_out, i, alive ? nd : din);
    store3(thr_out, i, thr);
    pdf_out[i] = pdf;
    alive_out[i] = alive;
  }
}

}  // namespace

// K.  d, n_unit, point, albedo, throughput, o (n, 3) float32; front_face,
// alive (n,) bool; mtype (n,) int32; param (n,) float32; the four RNG
// lanes as in rng.cu; rr: Russian roulette at this bounce (b >=
// rr_start); tables the (1024, 4) per-byte Sobol tables (read with
// sampler 1 only, staged per block of a resident grid).  Outputs o, d,
// throughput (n, 3), prev_pdf (n,), alive (n,).
extern "C" int ort_path_bsdf(
    const float* d, const float* n_unit, const float* point,
    const bool* front_face, const int* mtype, const float* albedo,
    const float* param, const float* throughput, const bool* alive,
    const float* o, const void* ap, int ak, unsigned av, const void* bp,
    int bk, unsigned bv, const void* cp, int ck, unsigned cv, const void* dp,
    int dk, unsigned dv, long long n, int sampler, int rr,
    const uint4* tables, float* o_out, float* d_out, float* thr_out,
    float* pdf_out, bool* alive_out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1LL << 20) ? blocks
                                                         : (1LL << 20));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const OrtLane a = ort_make_lane(ap, ak, av), b = ort_make_lane(bp, bk, bv),
                c = ort_make_lane(cp, ck, cv), dl = ort_make_lane(dp, dk, dv);
  if (sampler == ORT_SAMPLER_SOBOL) {
    auto kernel = path_bsdf_kernel<ORT_SAMPLER_SOBOL>;
    static std::atomic<int> fit[ORT_MAX_DEVICES];
    int sgrid = 0;
    const cudaError_t e =
        ort_resident_grid(kernel, n, kThreads, ORT_SOBOL_BYTES, fit, &sgrid);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<sgrid, kThreads, ORT_SOBOL_BYTES, st>>>(
        d, n_unit, point, front_face, mtype, albedo, param, throughput, alive,
        o, a, b, c, dl, n, rr, tables, o_out, d_out, thr_out, pdf_out,
        alive_out);
  } else {
    path_bsdf_kernel<ORT_SAMPLER_PCG><<<grid, kThreads, 0, st>>>(
        d, n_unit, point, front_face, mtype, albedo, param, throughput, alive,
        o, a, b, c, dl, n, rr, tables, o_out, d_out, thr_out, pdf_out,
        alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}
