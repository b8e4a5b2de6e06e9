// The marcher's wave glue: kernels O (coherence-sort keys), P (the sorted
// ray pack) and Q (the hit record, unsorted, with its u and v), the work
// ops/march.MarchIntersector.intersect does around kernels B, C and F.
//
// No TPU kernel is replaced: the JAX package's intersect
// (optix_ray_tracer_tpu/ops/march.py:313-378, with ray_sort_keys at
// ops/raysort.py:17, the probe keys at ops/march.py:70-79, morton_codes at
// ops/bvh.py:71 and the u/v recompute at ops/pallas/block_march.py:901) is
// plain jnp that XLA fuses into a few passes around its pallas_call.  The
// plain versions (ops/kernels/march_glue.*_plain) run it as some thirty
// eager launches a wave: Morton codes in int64, an int64 argsort, an
// (R, 8) cat and gather, four cats of padding, a cat of transposes, a
// Woop-row gather and four dots, an index scatter and four gathers to
// unsort, a prim_index gather and five selects.  Here:
//
// - O writes one int32 key a ray: the JAX package's uint32 key XOR
//   0x80000000, read as int32, which sorts in the uint32 key's order, so a
//   stable argsort of 4-byte keys gives the permutation of the 8-byte ones.
// - P writes the (8, R_pad) SoA rows B, C and F read, each ray read
//   through the permutation (or in place), the tail padded with dead rays;
//   with a permutation also its inverse, inv[perm[j]] = j (int32).
// - Q writes the Hit fields in the caller's order: ray i reads B's or F's
//   (t, slot) at its sorted position inv[i] (or i), recomputes u and v
//   from the winner's Woop row and its own o and d (the sorted o and d
//   the plain version uses are the same bits), and writes element i.
//   The unsort is a gather, not a scatter: writing the five fields at
//   perm[j] takes five scattered 4-byte stores a ray, each a partial
//   32-byte sector (17% of Q's bound on the H100, PERF.md); this way one
//   scattered store a ray remains, P's inverse, and Q's two scattered
//   loads read (t, slot) that B or F has just written.
//
// One thread per ray in each.  What bounds them on the H100: bytes (O ~20
// or 28 B a ray, P ~72, Q 30-100); their arithmetic is a few dozen
// operations a ray.
//
// Exactness: every float step is the plain version's in its order (true
// IEEE divides, clamps that pass NaN through, dot products left to right)
// and the library is built with -fmad=false.  A float-to-int64 cast of a
// NaN coordinate is the instruction torch's own cast compiles to, and only
// the low 32 bits of the cell reach the key, as in the plain version's
// int64 arithmetic.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeyMorton = 0, kKeyProbe = 1;
// Q's modes: u and v recomputed from the Woop rows, zero (occlusion
// waves), or given (the raster and bundle routes)
constexpr int kUvRecompute = 0, kUvZero = 1, kUvGiven = 2;
constexpr int kPrimNone = 0, kPrimTriangle = 2;   // ops/intersect.PRIM_*

using namespace ort;

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

// ops/bvh._expand_bits_10 on the low 32 bits of a cell
__device__ __forceinline__ unsigned expand_bits10(unsigned v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// One axis of ops/bvh.morton_codes: the clamped cell of p in [lo, hi]
__device__ __forceinline__ unsigned morton_cell(float p, float lo, float hi) {
  const float extent = clamp_min(hi - lo, 1e-30f);
  float q = (p - lo) / extent;
  q = isnan(q) ? q : fminf(fmaxf(q, 0.0f), 1.0f);
  long long g = static_cast<long long>(q * 1024.0f);
  g = g > 1023 ? 1023 : g;
  return expand_bits10(static_cast<unsigned>(g));
}

__device__ __forceinline__ unsigned morton3(V3 p, V3 lo, V3 hi) {
  return (morton_cell(p.x, lo.x, hi.x) << 2) |
         (morton_cell(p.y, lo.y, hi.y) << 1) | morton_cell(p.z, lo.z, hi.z);
}

__global__ void __launch_bounds__(kThreads) march_keys_kernel(
    int mode, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const int* __restrict__ cid, long long n, int* __restrict__ keys) {
  const V3 unit_lo = {-1.0f, -1.0f, -1.0f}, unit_hi = {1.0f, 1.0f, 1.0f};
  V3 box_lo = unit_lo, box_hi = unit_hi;
  if (mode == kKeyMorton) {
    box_lo = {__ldg(lo), __ldg(lo + 1), __ldg(lo + 2)};
    box_hi = {__ldg(hi), __ldg(hi + 1), __ldg(hi + 2)};
  }
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const unsigned d_m = morton3(load3(d, i), unit_lo, unit_hi);
    unsigned key;
    if (mode == kKeyProbe) {
      key = (static_cast<unsigned>(__ldg(cid + i)) << 18) | (d_m >> 12);
    } else {
      const unsigned o_m = morton3(load3(o, i), box_lo, box_hi);
      key = ((o_m >> 18) << 20) | (d_m >> 10);
    }
    keys[i] = static_cast<int>(key ^ 0x80000000u);
  }
}

__global__ void __launch_bounds__(kThreads) gather_rays_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, long long tmin_step,
    const float* __restrict__ t_max, long long tmax_step,
    const long long* __restrict__ perm, long long n, long long n_pad,
    float* __restrict__ rays, int* __restrict__ inv) {
  for (long long j = first_index(); j < n_pad; j += grid_stride()) {
    V3 ov = {0.0f, 0.0f, 0.0f}, dv = {0.0f, 0.0f, 1.0f};
    float t0 = 1.0f, t1 = 0.0f;          // pad_rays' dead ray
    if (j < n) {
      long long s = j;
      if (perm) {
        s = __ldg(perm + j);
        inv[s] = static_cast<int>(j);
      }
      ov = load3(o, s);
      dv = load3(d, s);
      t0 = __ldg(t_min + s * tmin_step);
      t1 = clamp_max(__ldg(t_max + s * tmax_step), ORT_INF);
    }
    rays[j] = ov.x;
    rays[n_pad + j] = ov.y;
    rays[2 * n_pad + j] = ov.z;
    rays[3 * n_pad + j] = dv.x;
    rays[4 * n_pad + j] = dv.y;
    rays[5 * n_pad + j] = dv.z;
    rays[6 * n_pad + j] = t0;
    rays[7 * n_pad + j] = t1;
  }
}

// block_march._finish's barycentric: (dot(w, o) - off) + t dot(w, d)
__device__ __forceinline__ float woop_bary(V3 w, float off, V3 o, V3 d,
                                           float t) {
  return (dot3(w, o) - off) + t * dot3(w, d);
}

template <int UV>
__global__ void __launch_bounds__(kThreads) finish_hits_kernel(
    const float* __restrict__ t, const int* __restrict__ slot,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ woop, const int* __restrict__ prim_index,
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const int* __restrict__ inv, long long n, float* __restrict__ t_out,
    int* __restrict__ prim_type, int* __restrict__ prim_id,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const long long j = inv ? __ldg(inv + i) : i;
    const int s = __ldg(slot + j);
    const bool miss = s < 0;
    float tt = ORT_INF, u = 0.0f, v = 0.0f;
    int id = 0;
    if (!miss) {
      tt = __ldg(t + j);
      id = __ldg(prim_index + s);
      if (UV == kUvRecompute) {
        const float* w = woop + 12LL * s;
        const V3 ov = load3(o, i), dv = load3(d, i);
        u = woop_bary({__ldg(w), __ldg(w + 1), __ldg(w + 2)}, __ldg(w + 9),
                      ov, dv, tt);
        v = woop_bary({__ldg(w + 3), __ldg(w + 4), __ldg(w + 5)},
                      __ldg(w + 10), ov, dv, tt);
      } else if (UV == kUvGiven) {
        u = __ldg(u_in + j);
        v = __ldg(v_in + j);
      }
    }
    t_out[i] = tt;
    prim_type[i] = miss ? kPrimNone : kPrimTriangle;
    prim_id[i] = id;
    u_out[i] = u;
    v_out[i] = v;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace

// O.  mode 0 (Morton): o, d (n, 3) float32 and the scene box lo, hi (3,)
// on the card; mode 1 (probe): d and C's cluster ids cid (n,) int32.
// Writes keys (n,) int32: the uint32 key XOR 0x80000000.
extern "C" int ort_march_keys(int mode, const float* o, const float* d,
                              const float* lo, const float* hi,
                              const int* cid, long long n, int* keys,
                              void* stream) {
  march_keys_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(mode, o, d, lo, hi,
                                                           cid, n, keys);
  return static_cast<int>(cudaGetLastError());
}

// P.  o, d (n, 3) float32; t_min, t_max float32, element i at
// t[i * step] (step 0: one bound for every ray); perm (n,) int64 or null
// (the identity).  Writes rays (8, n_pad), n_pad >= n, and with perm its
// inverse inv (n,) int32.
extern "C" int ort_gather_rays(const float* o, const float* d,
                               const float* t_min, long long tmin_step,
                               const float* t_max, long long tmax_step,
                               const long long* perm, long long n,
                               long long n_pad, float* rays, int* inv,
                               void* stream) {
  gather_rays_kernel<<<grid_for(n_pad), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, tmin_step, t_max, tmax_step, perm, n, n_pad, rays, inv);
  return static_cast<int>(cudaGetLastError());
}

// Q.  t, slot: a march's sorted (t, slot) (at least n); o, d (n, 3) the
// rays in the caller's order (read in mode 0); woop (rows, 12) and
// prim_index (rows,) int32 of the ClusterSet; u_in, v_in (n,) (mode 2,
// the caller's order); inv (n,) int32, ray i's sorted position, or null
// (in place).  Writes the Hit fields t, prim_type, prim_id, u, v (n,) in
// the caller's order.
extern "C" int ort_finish_hits(int mode, const float* t, const int* slot,
                               const float* o, const float* d,
                               const float* woop, const int* prim_index,
                               const float* u_in, const float* v_in,
                               const int* inv, long long n, float* t_out,
                               int* prim_type, int* prim_id, float* u_out,
                               float* v_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  if (mode == kUvRecompute) {
    finish_hits_kernel<kUvRecompute><<<grid, kThreads, 0, st>>>(
        t, slot, o, d, woop, prim_index, u_in, v_in, inv, n, t_out,
        prim_type, prim_id, u_out, v_out);
  } else if (mode == kUvZero) {
    finish_hits_kernel<kUvZero><<<grid, kThreads, 0, st>>>(
        t, slot, o, d, woop, prim_index, u_in, v_in, inv, n, t_out,
        prim_type, prim_id, u_out, v_out);
  } else {
    finish_hits_kernel<kUvGiven><<<grid, kThreads, 0, st>>>(
        t, slot, o, d, woop, prim_index, u_in, v_in, inv, n, t_out,
        prim_type, prim_id, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
