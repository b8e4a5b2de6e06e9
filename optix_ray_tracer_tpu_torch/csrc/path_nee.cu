// The path tracer's next-event estimation and MIS: kernels L (the light
// and environment samples), M (their shadowed contributions) and N (the
// miss and emitter terms), the work of render/pathtracer.nee_sample,
// nee_add and hit_radiance for one bounce wave.
//
// No TPU kernel is replaced: the JAX package's sections
// (optix_ray_tracer_tpu/render/pathtracer.py:201-322, scene/lights.py
// sample_lights and light_pdf_solid_angle, render/envmap.py
// sample_direction, pdf_solid_angle and sample) are plain jnp, which XLA
// fuses into the bounce step.  The plain versions (nee_sample_plain,
// nee_add_plain, hit_radiance_plain) run them eagerly: some 150 launches
// per bounce for the light and environment samples (the env sample's
// seven-step lower bound alone takes ~35), ~70 for the miss term over
// every lane and a few dozen for the emitter term.  A shadow query sits
// between each sample and its contribution, so the work splits there:
// L before the queries, M after them, N at the hit.  Here one thread
// takes one ray and does only what its lane needs: the contributions
// only where a sample is valid, the miss lookup only on missed lanes, the
// light pdf only on emitter hits.  A value the plain version computes
// and then discards by a mask cannot change a kept one, so skipping it
// keeps every output bit-equal.
//
// Exactness: every float step is the plain version's operation in its
// order (shading.cuh, envmap.cuh); the draws go through rng.cuh (both
// samplers, the Sobol tables staged per block of a resident grid as K
// stages them); the library is built with -fmad=false, so nothing is
// contracted.  The light and environment tables (a few hundred KB at
// most) stay in L2 and are read with __ldg.
//
// What bounds them on the H100: bytes.  L reads shading_alive, point,
// n_unit and the two int64 ids on every lane (41 B), mtype on live lanes
// and throughput and albedo where a sample is valid (24 B), and writes the
// origin and each part's direction, t_max, validity and contribution (12 +
// 29 a part); M reads radiance and each part's validity and occlusion
// masks on every lane and writes radiance (24 + 2 a part), and reads a
// contribution only where its sample is valid and unoccluded (12 B); N
// reads radiance, mtype and the two masks on every lane (21 B) and d,
// prev_pdf and throughput on missed and emitter lanes, emission on
// emitter lanes, and writes radiance (12 B).  Their arithmetic (a few
// dozen float operations, a handful of libm calls, one PCG4D or Sobol
// draw per part) is a small fraction of that time.
#include <math.h>

#include "envmap.cuh"
#include "rng.cuh"
#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kDimLight = 0x27220A95u;   // pathtracer._DIM_LIGHT
constexpr unsigned kDimEnv = 0x4F6CDD1Du;     // pathtracer._DIM_ENV
constexpr int kRough = 0, kEmissive = 3;      // scene/materials
constexpr int kPrimTriangle = 2;              // ops/intersect.PRIM_TRIANGLE
// the plain version's scalars, as torch converts them to float32
constexpr float kOffset = static_cast<float>(1e-3);
constexpr float kEndGap = static_cast<float>(2e-3);
constexpr float kInf = static_cast<float>(1e16);   // vecmath.INF

using namespace ort;

// The light table of scene/lights.AreaLights: (L, 3) rows v0, e1, e2,
// normal, emission; (L,) cdf and pdf_scale; (T,) tri_light_idx.
struct Lights {
  const float *v0, *e1, *e2, *normal, *emission, *cdf, *pdf_scale;
  const int* tri_light_idx;
  int count, n_tris;
};

// An EnvMap: image (h, w, 3), block_cdf (nb,), cond_cdf (nb, 128),
// pdf_tex (h, w); the tables may be null where the map has none.
struct Env {
  const float *image, *block_cdf, *cond_cdf, *pdf_tex;
  int h, w, nb;
};

__device__ __forceinline__ V3 cap3(V3 c, float cap) {
  if (cap > 0.0f) c = {clamp_max(c.x, cap), clamp_max(c.y, cap),
                       clamp_max(c.z, cap)};
  return c;
}

// ((throughput * (albedo / PI)) * radiance) * ((cos / clamp(pdf, 1e-12))
// * w), w the balance heuristic pdf / clamp(pdf + cos / PI, 1e-12): the
// NEE contribution of a valid sample (cos > 0), capped.
__device__ __forceinline__ V3 nee_contrib(V3 thr, V3 alb, V3 le, float cos_s,
                                          float pdf, float cap) {
  const float cos_c = clamp_min(cos_s, 0.0f);
  const float w = pdf / clamp_min(pdf + cos_c * kInvPi, 1e-12f);
  const float s = (cos_c / clamp_min(pdf, 1e-12f)) * w;
  return cap3({((thr.x * (alb.x * kInvPi)) * le.x) * s,
               ((thr.y * (alb.y * kInvPi)) * le.y) * s,
               ((thr.z * (alb.z * kInvPi)) * le.z) * s},
              cap);
}

template <int SAMPLER, bool LIGHTS, bool ENV>
__global__ void __launch_bounds__(kThreads) path_nee_sample_kernel(
    const float* __restrict__ point, const float* __restrict__ n_unit,
    const bool* __restrict__ alive, const int* __restrict__ mtype,
    const float* __restrict__ throughput, const float* __restrict__ albedo,
    OrtLane pix, OrtLane sample, OrtLane bounce, OrtLane seed, long long n,
    float cap, const uint4* __restrict__ tables, Lights lt, Env env,
    float* __restrict__ origin, float* __restrict__ wl_out,
    float* __restrict__ tl_out, bool* __restrict__ vl_out,
    float* __restrict__ cl_out, float* __restrict__ we_out,
    float* __restrict__ te_out, bool* __restrict__ ve_out,
    float* __restrict__ ce_out) {
  extern __shared__ uint4 tab[];   // the Sobol tables (Sobol only)
  if (SAMPLER == ORT_SAMPLER_SOBOL) ort_stage_sobol(tables, tab);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const V3 pt = load3(point, i), nn = load3(n_unit, i);
    store3(origin, i,
           {pt.x + nn.x * kOffset, pt.y + nn.y * kOffset,
            pt.z + nn.z * kOffset});
    const bool live = alive[i] && __ldg(mtype + i) == kRough;
    const unsigned p = ort_lane(pix, i), s = ort_lane(sample, i),
                   b = ort_lane(bounce, i), sd = ort_lane(seed, i);
    if (LIGHTS) {   // scene/lights.sample_lights, then the weights
      float u[3];
      ort_uniform<3>(SAMPLER, p, s, b, sd ^ kDimLight, tab, u);
      float u1 = u[0], u2 = u[1], u3 = u[2];
      if (SAMPLER == ORT_SAMPLER_SOBOL) {   // the CDF pick rides dim 2
        u1 = u[2];
        u2 = u[0];
        u3 = u[1];
      }
      int li = lower_bound(lt.cdf, lt.count, u1);
      li = li > lt.count - 1 ? lt.count - 1 : li;
      const V3 v0 = load3(lt.v0, li), e1 = load3(lt.e1, li),
               e2 = load3(lt.e2, li);
      const float su = sqrtf(clamp_min(u2, 1e-12f));
      const float b1 = 1.0f - su, b2 = u3 * su;
      const V3 to = {((v0.x + b1 * e1.x) + b2 * e2.x) - pt.x,
                     ((v0.y + b1 * e1.y) + b2 * e2.y) - pt.y,
                     ((v0.z + b1 * e1.z) + b2 * e2.z) - pt.z};
      const float dist2 = dot3(to, to);
      const float dist = sqrtf(clamp_min(dist2, 1e-20f));
      const V3 w = {to.x / dist, to.y / dist, to.z / dist};
      const float cos_l = fabsf(dot3(w, load3(lt.normal, li)));
      float pdf =
          (dist2 * __ldg(lt.pdf_scale + li)) / clamp_min(cos_l, 1e-12f);
      pdf = cos_l > 1e-6f ? pdf : 0.0f;
      const float cos_s = dot3(w, nn);
      const bool valid = live && cos_s > 0.0f && pdf > 0.0f;
      store3(wl_out, i, w);
      tl_out[i] = valid ? dist - kEndGap : 0.0f;
      vl_out[i] = valid;
      store3(cl_out, i,
             valid ? nee_contrib(load3(throughput, i), load3(albedo, i),
                                 load3(lt.emission, li), cos_s, pdf, cap)
                   : V3{0.0f, 0.0f, 0.0f});
    }
    if (ENV) {   // EnvMap.sample_direction, then the weights and sample
      float u[4];
      ort_uniform<4>(SAMPLER, p, s, b, sd ^ kDimEnv, tab, u);
      float pdf;
      const V3 we = env_sample_direction(env.block_cdf, env.cond_cdf,
                                         env.pdf_tex, env.nb, env.h, env.w,
                                         u[0], u[1], u[2], u[3], &pdf);
      const float cos_e = dot3(we, nn);
      const bool valid = live && cos_e > 0.0f && pdf > 0.0f;
      store3(we_out, i, we);
      te_out[i] = valid ? kInf : 0.0f;
      ve_out[i] = valid;
      store3(ce_out, i,
             valid ? nee_contrib(load3(throughput, i), load3(albedo, i),
                                 env_lookup(env.image, env.h, env.w,
                                            angles(we)),
                                 cos_e, pdf, cap)
                   : V3{0.0f, 0.0f, 0.0f});
    }
  }
}

__global__ void __launch_bounds__(kThreads) path_nee_add_kernel(
    const float* __restrict__ radiance, const float* __restrict__ c_l,
    const bool* __restrict__ valid_l, const bool* __restrict__ occ_l,
    const float* __restrict__ c_e, const bool* __restrict__ valid_e,
    const bool* __restrict__ occ_e, long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    V3 r = load3(radiance, i);
    const float* cs[2] = {c_l, c_e};
    const bool* valid[2] = {valid_l, valid_e};
    const bool* occ[2] = {occ_l, occ_e};
#pragma unroll
    for (int k = 0; k < 2; ++k) {   // area first, then the environment
      if (cs[k] == nullptr) continue;
      // a contribution is read only where its sample is valid and its
      // segment unoccluded; elsewhere it adds +0.0, as the plain version's
      // where(valid & ~occluded, c, 0)
      const V3 c = valid[k][i] && !occ[k][i] ? load3(cs[k], i)
                                             : V3{0.0f, 0.0f, 0.0f};
      r = {r.x + c.x, r.y + c.y, r.z + c.z};
    }
    store3(out, i, r);
  }
}

// ENV: 0 the background, 1 the map's lookup, 2 the lookup MIS-weighted
// against the environment sample.  EMIT: 0 every emitter hit, 1 none
// (restir_direct at bounce 0), 2 those whose primary vertex was not
// diffuse (restir_direct at bounce 1).
template <int ENV, bool LIGHTS>
__global__ void __launch_bounds__(kThreads) path_hit_radiance_kernel(
    const float* __restrict__ radiance, const float* __restrict__ d_in,
    const float* __restrict__ prev_pdf, const float* __restrict__ throughput,
    const bool* __restrict__ missed, const bool* __restrict__ hit_alive,
    const int* __restrict__ mtype, const float* __restrict__ emission,
    const float* __restrict__ hit_t, const int* __restrict__ prim_id,
    const int* __restrict__ prim_type, const bool* __restrict__ prim_diff,
    long long n, int emit, float cap, const float* __restrict__ background,
    Env env, Lights lt, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    V3 r = load3(radiance, i);
    V3 m = {0.0f, 0.0f, 0.0f};
    if (missed[i]) {
      const V3 d = load3(d_in, i), thr = load3(throughput, i);
      V3 mr = ENV == 0 ? load3(background, 0) : V3{0.0f, 0.0f, 0.0f};
      float w = 1.0f;
      if (ENV > 0) {
        const Angles a = angles(d);
        mr = env_lookup(env.image, env.h, env.w, a);
        if (ENV == 2) {
          const float pp = __ldg(prev_pdf + i);
          w = pp > 0.0f
                  ? pp / clamp_min(pp + env_pdf(env.pdf_tex, env.h, env.w, a),
                                   1e-12f)
                  : 1.0f;
        }
      }
      m = cap3({(thr.x * mr.x) * w, (thr.y * mr.y) * w, (thr.z * mr.z) * w},
               cap);
    }
    r = {r.x + m.x, r.y + m.y, r.z + m.z};
    bool vis = hit_alive[i] && __ldg(mtype + i) == kEmissive;
    if (emit == 1) vis = false;
    if (emit == 2) vis = vis && !prim_diff[i];
    V3 e = {0.0f, 0.0f, 0.0f};
    if (vis) {   // scene/lights.light_pdf_solid_angle, then w_bsdf
      const V3 thr = load3(throughput, i), em = load3(emission, i);
      float w = 1.0f;
      if (LIGHTS) {
        int tid = __ldg(prim_id + i);
        const int top = lt.n_tris - 1 > 0 ? lt.n_tris - 1 : 0;
        tid = tid < 0 ? 0 : (tid > top ? top : tid);
        const int li = __ldg(lt.tri_light_idx + tid);
        const bool is_light = __ldg(prim_type + i) == kPrimTriangle && li >= 0;
        const int lc = li > 0 ? li : 0;
        const float scale = is_light ? __ldg(lt.pdf_scale + lc) : 0.0f;
        const float cos_l = fabsf(dot3(load3(d_in, i), load3(lt.normal, lc)));
        const float t = __ldg(hit_t + i);
        float pdf = ((t * t) * scale) / clamp_min(cos_l, 1e-12f);
        pdf = cos_l > 1e-6f ? pdf : 0.0f;
        const float pp = __ldg(prev_pdf + i);
        w = pp > 0.0f ? pp / clamp_min(pp + pdf, 1e-12f) : 1.0f;
      }
      e = cap3({(thr.x * em.x) * w, (thr.y * em.y) * w, (thr.z * em.z) * w},
               cap);
    }
    store3(out, i, {r.x + e.x, r.y + e.y, r.z + e.z});
  }
}

int grid_of(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

template <int SAMPLER, bool LIGHTS, bool ENV>
int launch_nee_sample(const float* point, const float* n_unit,
                      const bool* alive, const int* mtype,
                      const float* throughput, const float* albedo,
                      OrtLane a, OrtLane b, OrtLane c, OrtLane d, long long n,
                      float cap, const uint4* tables, Lights lt, Env env,
                      float* origin, float* wl, float* tl, bool* vl,
                      float* cl, float* we, float* te, bool* ve, float* ce,
                      cudaStream_t st) {
  auto kernel = path_nee_sample_kernel<SAMPLER, LIGHTS, ENV>;
  if (SAMPLER == ORT_SAMPLER_SOBOL) {
    static std::atomic<int> fit[ORT_MAX_DEVICES];
    int grid = 0;
    const cudaError_t e =
        ort_resident_grid(kernel, n, kThreads, ORT_SOBOL_BYTES, fit, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, ORT_SOBOL_BYTES, st>>>(
        point, n_unit, alive, mtype, throughput, albedo, a, b, c, d, n, cap,
        tables, lt, env, origin, wl, tl, vl, cl, we, te, ve, ce);
  } else {
    kernel<<<grid_of(n), kThreads, 0, st>>>(
        point, n_unit, alive, mtype, throughput, albedo, a, b, c, d, n, cap,
        tables, lt, env, origin, wl, tl, vl, cl, we, te, ve, ce);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int SAMPLER>
int nee_sample_parts(bool lights, bool env_on, const float* point,
                     const float* n_unit, const bool* alive, const int* mtype,
                     const float* throughput, const float* albedo, OrtLane a,
                     OrtLane b, OrtLane c, OrtLane d, long long n, float cap,
                     const uint4* tables, Lights lt, Env env, float* origin,
                     float* wl, float* tl, bool* vl, float* cl, float* we,
                     float* te, bool* ve, float* ce, cudaStream_t st) {
  if (lights && env_on)
    return launch_nee_sample<SAMPLER, true, true>(
        point, n_unit, alive, mtype, throughput, albedo, a, b, c, d, n, cap,
        tables, lt, env, origin, wl, tl, vl, cl, we, te, ve, ce, st);
  if (lights)
    return launch_nee_sample<SAMPLER, true, false>(
        point, n_unit, alive, mtype, throughput, albedo, a, b, c, d, n, cap,
        tables, lt, env, origin, wl, tl, vl, cl, we, te, ve, ce, st);
  return launch_nee_sample<SAMPLER, false, true>(
      point, n_unit, alive, mtype, throughput, albedo, a, b, c, d, n, cap,
      tables, lt, env, origin, wl, tl, vl, cl, we, te, ve, ce, st);
}

template <int ENV, bool LIGHTS>
int launch_hit_radiance(const float* radiance, const float* d,
                        const float* prev_pdf, const float* throughput,
                        const bool* missed, const bool* hit_alive,
                        const int* mtype, const float* emission,
                        const float* hit_t, const int* prim_id,
                        const int* prim_type, const bool* prim_diff,
                        long long n, int emit, float cap, const float* bg,
                        Env env, Lights lt, float* out, cudaStream_t st) {
  path_hit_radiance_kernel<ENV, LIGHTS><<<grid_of(n), kThreads, 0, st>>>(
      radiance, d, prev_pdf, throughput, missed, hit_alive, mtype, emission,
      hit_t, prim_id, prim_type, prim_diff, n, emit, cap, bg, env, lt, out);
  return static_cast<int>(cudaGetLastError());
}

Lights make_lights(const float* v0, const float* e1, const float* e2,
                   const float* normal, const float* emission,
                   const float* cdf, const float* pdf_scale,
                   const int* tri_light_idx, int count, int n_tris) {
  return {v0, e1, e2, normal, emission, cdf, pdf_scale, tri_light_idx,
          count, n_tris};
}

}  // namespace

// L.  point, n_unit, throughput, albedo (n, 3) float32; alive
// (shading_alive) (n,) bool; mtype (n,) int32; the four RNG lanes as in
// rng.cu; sampler 0 PCG4D / 1 Sobol (tables: the (1024, 4) per-byte Sobol
// tables); parts: bit 0 the area-light sample, bit 1 the environment
// sample; cap the firefly clamp (0: off); the light table (count rows,
// n_tris entries of tri_light_idx; null when bit 0 is clear) and the map
// (h x w texels, nb blocks; null when bit 1 is clear).  Outputs: origin
// (n, 3); per part on, the direction (n, 3), t_max (n,), validity (n,)
// bool and contribution (n, 3).
extern "C" int ort_path_nee_sample(
    const float* point, const float* n_unit, const bool* alive,
    const int* mtype, const float* throughput, const float* albedo,
    const void* ap, int ak, unsigned av, const void* bp, int bk, unsigned bv,
    const void* cp, int ck, unsigned cv, const void* dp, int dk, unsigned dv,
    long long n, int sampler, int parts, float cap, const uint4* tables,
    const float* lv0, const float* le1, const float* le2,
    const float* lnormal, const float* lemission, const float* lcdf,
    const float* lpdf_scale, int lcount, const float* image,
    const float* block_cdf, const float* cond_cdf, const float* pdf_tex,
    int h, int w, int nb, float* origin, float* wl, float* tl, bool* vl,
    float* cl, float* we, float* te, bool* ve, float* ce, void* stream) {
  if ((parts & 3) == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const OrtLane a = ort_make_lane(ap, ak, av), b = ort_make_lane(bp, bk, bv),
                c = ort_make_lane(cp, ck, cv), d = ort_make_lane(dp, dk, dv);
  const Lights lt = make_lights(lv0, le1, le2, lnormal, lemission, lcdf,
                                lpdf_scale, nullptr, lcount, 0);
  const Env env = {image, block_cdf, cond_cdf, pdf_tex, h, w, nb};
  const bool lights = parts & 1, env_on = parts & 2;
  if (sampler == ORT_SAMPLER_SOBOL)
    return nee_sample_parts<ORT_SAMPLER_SOBOL>(
        lights, env_on, point, n_unit, alive, mtype, throughput, albedo, a,
        b, c, d, n, cap, tables, lt, env, origin, wl, tl, vl, cl, we, te, ve,
        ce, st);
  return nee_sample_parts<ORT_SAMPLER_PCG>(
      lights, env_on, point, n_unit, alive, mtype, throughput, albedo, a, b,
      c, d, n, cap, tables, lt, env, origin, wl, tl, vl, cl, we, te, ve, ce,
      st);
}

// M.  radiance (n, 3) float32; per part its contribution (n, 3), its
// validity (L's) and its occlusion mask (n,) bool, all null for a part
// that is off.  Output: the new radiance (n, 3).
extern "C" int ort_path_nee_add(const float* radiance, const float* c_l,
                                const bool* valid_l, const bool* occ_l,
                                const float* c_e, const bool* valid_e,
                                const bool* occ_e, long long n, float* out,
                                void* stream) {
  path_nee_add_kernel<<<grid_of(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      radiance, c_l, valid_l, occ_l, c_e, valid_e, occ_e, n, out);
  return static_cast<int>(cudaGetLastError());
}

// N.  radiance, d, throughput, emission (n, 3) float32; prev_pdf, hit_t
// (n,) float32; missed, hit_alive, prim_diff (n,) bool; mtype, prim_id,
// prim_type (n,) int32; env_mode 0 the background (bg, 3 floats on the
// card), 1 the map's lookup (image, h x w), 2 with the environment MIS
// weight (pdf_tex); a light table (tri_light_idx of n_tris entries,
// normal, pdf_scale; null: none) weighs the emitter hits; emit as in
// path_hit_radiance_kernel; cap the firefly clamp (0: off).  Output: the
// new radiance (n, 3).
extern "C" int ort_path_hit_radiance(
    const float* radiance, const float* d, const float* prev_pdf,
    const float* throughput, const bool* missed, const bool* hit_alive,
    const int* mtype, const float* emission, const float* hit_t,
    const int* prim_id, const int* prim_type, const bool* prim_diff,
    long long n, int env_mode, const float* bg, const float* image,
    const float* pdf_tex, int h, int w, const int* tri_light_idx, int n_tris,
    const float* lnormal, const float* lpdf_scale, int emit, float cap,
    float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Env env = {image, nullptr, nullptr, pdf_tex, h, w, 0};
  const Lights lt = make_lights(nullptr, nullptr, nullptr, lnormal, nullptr,
                                nullptr, lpdf_scale, tri_light_idx, 0, n_tris);
#define ORT_HIT_RADIANCE(E, L)                                              \
  return launch_hit_radiance<E, L>(radiance, d, prev_pdf, throughput,      \
                                   missed, hit_alive, mtype, emission,     \
                                   hit_t, prim_id, prim_type, prim_diff, n, \
                                   emit, cap, bg, env, lt, out, st)
  if (tri_light_idx != nullptr) {
    if (env_mode == 2) ORT_HIT_RADIANCE(2, true);
    if (env_mode == 1) ORT_HIT_RADIANCE(1, true);
    ORT_HIT_RADIANCE(0, true);
  }
  if (env_mode == 2) ORT_HIT_RADIANCE(2, false);
  if (env_mode == 1) ORT_HIT_RADIANCE(1, false);
  ORT_HIT_RADIANCE(0, false);
#undef ORT_HIT_RADIANCE
}
