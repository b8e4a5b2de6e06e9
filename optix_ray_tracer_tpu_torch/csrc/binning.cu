// The raster binning: kernels S (window rects), T (block bounds and pair
// counts) and U (the sorted pair schedule), the work ops/raster's
// _coarse_stage and bundle_stage and ops/raster_instanced's
// instanced_coarse_stage do to build the (ray block, window) schedules
// kernels A and D run.
//
// No TPU kernel is replaced: the JAX package bins in plain jnp that XLA
// fuses around its pallas_call (optix_ray_tracer_tpu/ops/raster.py:142-304
// and :512-604, ops/raster_instanced.py:52-120).  The plain versions
// (ops/kernels/binning.*_plain) run it as a few hundred eager launches a
// wave: the padding and transposes of the ray pack, masked reductions of
// the block rects, the dense (blocks, windows) overlap test (per direction
// octant for bundles), a cumsum and searchsorted, an 11-round bisection
// over the (blocks, windows) cumsum, and two stable argsorts.  Here:
//
// - S writes each window's margined rect (6, C) and its full-plane flag,
//   from its triangles' vertices (8-triangle groups, one thread a group,
//   the window reduced over the group threads of a warp), from a TLAS
//   pair's 8 box corners (one thread a pair), or, for bundles, from its
//   sub boxes (one thread a window).
// - T runs one CTA per W-ray block: it writes the block's columns of the
//   transposed ray pack A and D read (the trailing dead block by one more
//   CTA), reduces the block's bounds (projective: the rect, depth range
//   and live flag; bundle: per direction octant the origin, direction and
//   t ranges of the live lanes), tests every window against them and
//   writes the block's pair count; the last CTA to finish scans the counts
//   into row offsets (offs[nb] is the pair total).
// - U runs one CTA per block: it repeats T's test for its row in ascending
//   window order, keeps the row's first windows up to the capacity
//   pc_max, sorts them by (key, window) and writes the schedule at the
//   row's offset; the slots past the total get the plain version's
//   padding (nb - 1, C - 1, invalid), cut in nb slices.  The key is a
//   window's near depth (projective) or the bundle's smallest admitted
//   entry t, as a float: -0.0 ties +0.0, equal keys keep ascending window
//   ids, as the plain version's stable argsorts keep them.  A row sorts in
//   shared memory (up to 8,192 pairs); a longer one sorts in place in its
//   output segment (the key bits in b_i, the window in c_i), each
//   8,192-pair chunk in shared memory, then the bitonic merges across
//   chunks in device memory.
//
// What bounds them on the H100: T reads 32 B and writes 32 B a ray, and T
// and U test every (block, window) pair (a dozen operations projective,
// up to some 40 per live octant with four divides for bundles); each
// CTA reads the window table from L2.  They are latency-scale at the
// waves' sizes (tens of microseconds).
//
// Exactness: every float step is the plain version's in its order, with
// IEEE divides (no fast math) and the library built with -fmad=false.
// nanmin / nanmax reduce with fminf / fmaxf (NaN skipped, NaN only when
// every element is NaN); torch's amin / amax, minimum / maximum with
// min_nan / max_nan (a NaN operand gives NaN).  Min and max do not depend
// on the order of their operands, so T's and S's reductions equal the
// plain version's (a zero may differ in sign, which compares equal).
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "shading.cuh"

namespace {

using namespace ort;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupVerts = 24;          // an 8-triangle group's vertices
// S's window sources (ops/kernels/binning.RECTS_*)
constexpr int kSrcCluster = 0, kSrcPair = 1, kSrcBox = 2;
// T's and U's modes (binning.MODE_IDS)
constexpr int kOrigin = 0, kOrtho = 2, kBundle = 3;
// floats of a block's bounds: projective (bx0, bx1, by0, by1, bz0, bz1,
// live, 0); bundle, per octant (olo, ohi, dlo, dhi (3 each), t_lo, t_hi)
constexpr int kRectVals = 8;
constexpr int kBoxVals = 14;
constexpr int kMaxOctants = 8;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.minimum / maximum (and a step of amin / amax): NaN propagates
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// the binning's conservative margin: 1e-5 (|lo| + |hi|) + 1e-6
__device__ __forceinline__ float margin(float lo, float hi) {
  return 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
}

struct Basis {
  V3 u, v, w;
};

__device__ __forceinline__ Basis load_basis(const float* __restrict__ b) {
  return {load3(b, 0), load3(b, 1), load3(b, 2)};
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

// raster._proj of one row: (x, y, depth, good)
__device__ __forceinline__ void project(V3 q, const Basis& B, bool persp,
                                        float& x, float& y, float& w,
                                        bool& good) {
  const float qu = dot3(q, B.u), qv = dot3(q, B.v), qw = dot3(q, B.w);
  w = qw;
  if (!persp) {
    x = qu;
    y = qv;
    good = !isnan(qu);
    return;
  }
  good = qw > 0.0f;
  const float den = good ? qw : 1.0f;
  x = qu / den;
  y = qv / den;
}

// A rect on the projection plane with its depth range: (x0, x1, y0, y1,
// z0, z1) and the full-plane flag (a point on or behind the plane)
struct Rect {
  float v[6];
  bool full;
};

__device__ __forceinline__ void rect_init(Rect& r) {
#pragma unroll
  for (int k = 0; k < 6; ++k) r.v[k] = nan_f();
  r.full = false;
}

// one point q (already relative to the shared point) into the rect: x, y
// of good points, the depth of every point, nanmin / nanmax
__device__ __forceinline__ void rect_add(Rect& r, V3 q, const Basis& B,
                                         bool persp) {
  float x, y, w;
  bool good;
  project(q, B, persp, x, y, w, good);
  if (good) {
    r.v[0] = fminf(r.v[0], x);
    r.v[1] = fmaxf(r.v[1], x);
    r.v[2] = fminf(r.v[2], y);
    r.v[3] = fmaxf(r.v[3], y);
  }
  r.v[4] = fminf(r.v[4], w);
  r.v[5] = fmaxf(r.v[5], w);
  r.full = r.full || (!good && !isnan(x));
}

__device__ __forceinline__ void rect_margin(Rect& r) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float m = margin(r.v[2 * a], r.v[2 * a + 1]);
    r.v[2 * a] = r.v[2 * a] - m;
    r.v[2 * a + 1] = r.v[2 * a + 1] + m;
  }
}

__device__ __forceinline__ void rect_store(const Rect& r, int c, int C,
                                           float* __restrict__ rects,
                                           bool* __restrict__ cfull) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    rects[static_cast<long long>(k) * C + c] = r.v[k];
  if (cfull) cfull[c] = r.full;
}

// S.  kSrcCluster: a = the sorted vertices (n_items groups x 24 points),
// per_window groups a window; kSrcPair: a, b = the pairs' world boxes
// (n_items, 3); kSrcBox: a, b = the sub boxes (n_items windows x
// per_window, 3).  point: the shared point (perspective) or null
// (orthographic).  Writes rects (6, C) and cfull (C,) (not for boxes).
template <int SRC>
__global__ void __launch_bounds__(kThreads) bin_rects_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ basis, const float* __restrict__ point,
    int per_window, int n_items, int C, float* __restrict__ rects,
    bool* __restrict__ cfull) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  if (SRC == kSrcBox) {
    if (gid >= n_items) return;
    Rect r;
    rect_init(r);
    for (int s = 0; s < per_window; ++s) {
      const long long row = static_cast<long long>(gid) * per_window + s;
      const V3 lo = load3(a, row), hi = load3(b, row);
      r.v[0] = fminf(r.v[0], lo.x);
      r.v[1] = fmaxf(r.v[1], hi.x);
      r.v[2] = fminf(r.v[2], lo.y);
      r.v[3] = fmaxf(r.v[3], hi.y);
      r.v[4] = fminf(r.v[4], lo.z);
      r.v[5] = fmaxf(r.v[5], hi.z);
    }
    rect_margin(r);
    rect_store(r, gid, C, rects, nullptr);
    return;
  }
  const bool persp = point != nullptr;
  const V3 p = persp ? load3(point, 0) : V3{0.0f, 0.0f, 0.0f};
  const Basis B = load_basis(basis);
  Rect r;
  rect_init(r);
  if (SRC == kSrcPair) {
    if (gid >= n_items) return;
    const V3 lo = load3(a, gid), hi = load3(b, gid);
    for (int k = 0; k < 8; ++k) {
      // corner k: bit a of k picks the max on axis a, as min (1 - s) + max s
      const float sx = static_cast<float>(k & 1);
      const float sy = static_cast<float>((k >> 1) & 1);
      const float sz = static_cast<float>((k >> 2) & 1);
      V3 q = {lo.x * (1.0f - sx) + hi.x * sx, lo.y * (1.0f - sy) + hi.y * sy,
              lo.z * (1.0f - sz) + hi.z * sz};
      if (persp) q = sub3(q, p);
      rect_add(r, q, B, persp);
    }
    rect_margin(r);
    rect_store(r, gid, C, rects, cfull);
    return;
  }
  // clusters: whole warps, so that the window reduction's shuffles see
  // every lane (n_items, whole clusters of 32 groups, is a multiple of 32)
  if ((gid & ~31) >= n_items) return;
  if (gid < n_items) {
    for (int k = 0; k < kGroupVerts; ++k) {
      V3 q = load3(a, static_cast<long long>(gid) * kGroupVerts + k);
      if (persp) q = sub3(q, p);
      rect_add(r, q, B, persp);
    }
    rect_margin(r);          // each group's rect gets its margin
  }
  for (int s = per_window >> 1; s >= 1; s >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, r.v[k], s);
      r.v[k] = (k & 1) ? fmaxf(r.v[k], o) : fminf(r.v[k], o);
    }
    r.full = __shfl_xor_sync(0xffffffffu, static_cast<int>(r.full), s) ||
             r.full;
  }
  if (gid < n_items && gid % per_window == 0)
    rect_store(r, gid / per_window, C, rects, cfull);
}

// The wave T packs and bins: element i of o and d at o + i * o_step (3,
// or 0 for one row broadcast), of the bounds at t + i * t_step (1 or 0).
struct Wave {
  const float* o;
  long long o_step;
  const float* d;
  long long d_step;
  const float* t_min;
  long long tmin_step;
  const float* t_max;
  long long tmax_step;
  long long n;
};

struct Ray {
  V3 o, d;
  float t0, t1;
};

// ray i of the wave (t_max clamped to INF), or _pad_wave's dead ray past
// its end
__device__ __forceinline__ Ray load_ray(const Wave& w, long long i) {
  Ray r;
  if (i < w.n) {
    const float* o = w.o + i * w.o_step;
    const float* d = w.d + i * w.d_step;
    r.o = {__ldg(o), __ldg(o + 1), __ldg(o + 2)};
    r.d = {__ldg(d), __ldg(d + 1), __ldg(d + 2)};
    r.t0 = __ldg(w.t_min + i * w.tmin_step);
    r.t1 = clamp_max(__ldg(w.t_max + i * w.tmax_step), ORT_INF);
  } else {
    r.o = {0.0f, 0.0f, 0.0f};
    r.d = {0.0f, 0.0f, 1.0f};
    r.t0 = 1.0f;
    r.t1 = 0.0f;
  }
  return r;
}

__device__ __forceinline__ int octant(V3 d) {
  return (d.x > 0.0f ? 1 : 0) + (d.y > 0.0f ? 2 : 0) + (d.z > 0.0f ? 4 : 0);
}

// the reductions of the projective bounds: nanmin / nanmax of the rect,
// amin / amax of the depth range, any of the live flags (0 / 1)
struct RectOp {
  __device__ __forceinline__ float operator()(int k, float a, float b) const {
    return k < 4 ? ((k & 1) ? fmaxf(a, b) : fminf(a, b))
                 : k == 4 ? min_nan(a, b) : k == 5 ? max_nan(a, b)
                                                   : fmaxf(a, b);
  }
};

// whether bundle bound k is a minimum (olo, dlo, t_lo) or a maximum
__device__ __forceinline__ bool box_low(int k) {
  return k < 12 ? (k / 3) % 2 == 0 : k == 12;
}

// the bundle bounds' amin and amax
struct BoxOp {
  __device__ __forceinline__ float operator()(int k, float a, float b) const {
    return box_low(k) ? min_nan(a, b) : max_nan(a, b);
  }
};

// v[0..N) reduced over the CTA with op; every thread gets the result.
// scratch: kWarps * N floats.
template <int N, class Op>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* scratch,
                                             Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = op(k, v[k], __shfl_xor_sync(0xffffffffu, v[k], s));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[warp * N + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float r = scratch[k];
    for (int w = 1; w < kWarps; ++w) r = op(k, r, scratch[w * N + k]);
    v[k] = r;
  }
  __syncthreads();
}

__device__ __forceinline__ int block_sum(int x, int* scratch) {
  x = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Window c against a block's bounds sb: the projective rect, depth and
// full-plane test, or the bundle's interval test OR'd over the octants;
// key: the window's near depth, or the smallest admitted entry t.
__device__ __forceinline__ bool window_test(int mode, int n_oct,
                                            const float* sb,
                                            const float* __restrict__ rects,
                                            const bool* __restrict__ cfull,
                                            int C, int c, float& key) {
  float r[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    r[k] = __ldg(rects + static_cast<long long>(k) * C + c);
  if (mode != kBundle) {
    key = r[4];
    const bool plane = (sb[0] <= r[1] && sb[1] >= r[0] && sb[2] <= r[3] &&
                        sb[3] >= r[2]) || cfull[c];
    return plane && sb[4] <= r[5] && sb[5] >= r[4] && sb[6] != 0.0f;
  }
  bool any = false;
  key = ORT_INF;
  for (int q = 0; q < n_oct; ++q) {
    const float* s = sb + q * kBoxVals;
    // no live lane in the octant: its bounds are +-INF and it admits
    // nothing (t_lo of a live lane is below its t_max <= INF)
    if (!(s[12] < ORT_INF)) continue;
    float lo_t = 0.0f, hi_t = ORT_INF;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float u = r[2 * ax + 1] - s[ax];      // want t dlo <= u
      const float v = r[2 * ax] - s[3 + ax];      // want t dhi >= v
      const float dl = s[6 + ax], dh = s[9 + ax];
      const float hi1 = dl > kEps ? u / dl : ORT_INF;
      const float lo1 = dl < -kEps ? u / dl : 0.0f;
      const float hi2 = dh < -kEps ? v / dh : ORT_INF;
      const float lo2 = dh > kEps ? v / dh : 0.0f;
      lo_t = max_nan(lo_t, max_nan(lo1, lo2));
      hi_t = min_nan(hi_t, min_nan(hi1, hi2));
    }
    lo_t = lo_t - (fabsf(lo_t) * 1e-6f + 1e-8f);
    hi_t = hi_t + (fabsf(hi_t) * 1e-6f + 1e-8f);
    const float lo_eff = max_nan(lo_t, s[12]);
    const float hi_eff = min_nan(hi_t, s[13]);
    if (lo_eff <= hi_eff) {          // NaN anywhere compares False
      any = true;
      key = min_nan(key, lo_eff);
    }
  }
  return any;
}

// T.  One CTA per block b < nb, one more for the trailing dead block's
// pack.  rays (8, (nb + 1) W); bounds (nb, 8) or (nb, n_oct, 14); cnt
// (nb,); offs (nb + 2,): the row offsets, offs[nb] the total, offs[nb + 1]
// the count of finished CTAs (zeroed before the launch).
__global__ void __launch_bounds__(kThreads) bin_count_kernel(
    int mode, int n_oct, Wave wave, int W, int nb,
    const float* __restrict__ basis, const float* __restrict__ point,
    const float* __restrict__ rects, const bool* __restrict__ cfull, int C,
    float* __restrict__ rays, float* __restrict__ bounds,
    int* __restrict__ cnt, int* __restrict__ offs) {
  __shared__ float scratch[kWarps * kBoxVals];
  __shared__ float sb[kMaxOctants * kBoxVals];
  __shared__ int s_int[kWarps];
  __shared__ bool s_last;
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long np = static_cast<long long>(nb + 1) * W;
  for (int l = tid; l < W; l += kThreads) {
    const long long i = static_cast<long long>(b) * W + l;
    const Ray r = load_ray(wave, i);
    rays[i] = r.o.x;
    rays[np + i] = r.o.y;
    rays[2 * np + i] = r.o.z;
    rays[3 * np + i] = r.d.x;
    rays[4 * np + i] = r.d.y;
    rays[5 * np + i] = r.d.z;
    rays[6 * np + i] = r.t0;
    rays[7 * np + i] = r.t1;
  }
  if (b < nb) {
    const long long first = static_cast<long long>(b) * W;
    if (mode == kBundle) {
      for (int q = 0; q < n_oct; ++q) {
        float v[kBoxVals];
#pragma unroll
        for (int k = 0; k < kBoxVals; ++k)
          v[k] = box_low(k) ? ORT_INF : -ORT_INF;     // no live lane
        for (int l = tid; l < W; l += kThreads) {
          const Ray r = load_ray(wave, first + l);
          if (!(r.t1 > r.t0) || (n_oct > 1 && octant(r.d) != q)) continue;
          const float x[kBoxVals] = {r.o.x, r.o.y, r.o.z, r.o.x, r.o.y, r.o.z,
                                     r.d.x, r.d.y, r.d.z, r.d.x, r.d.y, r.d.z,
                                     r.t0, r.t1};
#pragma unroll
          for (int k = 0; k < kBoxVals; ++k) v[k] = BoxOp()(k, v[k], x[k]);
        }
        block_reduce(v, scratch, BoxOp());
        if (tid < kBoxVals) {
          sb[q * kBoxVals + tid] = v[tid];
          bounds[(static_cast<long long>(b) * n_oct + q) * kBoxVals + tid] =
              v[tid];
        }
      }
    } else {
      const bool persp = mode != kOrtho;
      const V3 p = point ? load3(point, 0) : V3{0.0f, 0.0f, 0.0f};
      const Basis B = load_basis(basis);
      float v[kRectVals] = {nan_f(), nan_f(), nan_f(), nan_f(),
                            ORT_INF, -ORT_INF, 0.0f, 0.0f};
      for (int l = tid; l < W; l += kThreads) {
        const Ray r = load_ray(wave, first + l);
        if (!(r.t1 > r.t0)) continue;
        const V3 q = mode == kOrigin ? r.d : mode == kOrtho ? r.o
                                                             : sub3(r.o, p);
        float x, y, qw;
        bool good;
        project(q, B, persp, x, y, qw, good);
        if (good) {
          v[0] = fminf(v[0], x);
          v[1] = fmaxf(v[1], x);
          v[2] = fminf(v[2], y);
          v[3] = fmaxf(v[3], y);
        }
        // depth along the ray: w0 + t (d . w)
        const float wd = mode == kOrigin ? qw : dot3(r.d, B.w);
        const float w0 = mode == kOrigin ? 0.0f : qw;
        const float a0 = r.t0 * wd, a1 = r.t1 * wd;
        v[4] = min_nan(v[4], w0 + min_nan(a0, a1));
        v[5] = max_nan(v[5], w0 + max_nan(a0, a1));
        v[6] = 1.0f;
      }
      block_reduce(v, scratch, RectOp());
      if (tid < kRectVals) {
        sb[tid] = v[tid];
        bounds[static_cast<long long>(b) * kRectVals + tid] = v[tid];
      }
    }
    __syncthreads();
    int count = 0;
    if (mode == kBundle || sb[6] != 0.0f) {
      for (int c = tid; c < C; c += kThreads) {
        float key;
        count += window_test(mode, n_oct, sb, rects, cfull, C, c, key);
      }
    }
    count = block_sum(count, s_int);
    if (tid == 0) cnt[b] = count;
  }
  // the last CTA to finish scans the counts into the row offsets
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(reinterpret_cast<unsigned*>(offs + nb + 1), 1u) ==
             gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int per = (nb + kThreads - 1) / kThreads;
  const int lo = min(tid * per, nb), hi = min(lo + per, nb);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += __ldcg(cnt + i);
  // exclusive scan of the per-thread sums
  const int lane = tid & 31, warp = tid >> 5;
  int incl = sum;
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += o;
  }
  if (lane == 31) s_int[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += s_int[w];
  for (int i = lo; i < hi; ++i) {
    offs[i] = run;
    run += __ldcg(cnt + i);
  }
  if (tid == kThreads - 1) offs[nb] = run;
}

// (key, window) as one sortable 64-bit key: the float's order-preserving
// bits (-0.0 as +0.0, NaN above every number), then the window id
__device__ __forceinline__ unsigned long long sort_key(float key, int c) {
  const unsigned bits = __float_as_uint(key);
  const unsigned ord = isnan(key) ? 0xFFC00000u
                       : (bits << 1) == 0u ? 0x80000000u : ort_ordered(key);
  return (static_cast<unsigned long long>(ord) << 32) |
         static_cast<unsigned>(c);
}

// comparator t's lower index in a stage of the bitonic network whose
// comparators pair i with i + span (span a power of two)
__device__ __forceinline__ int low_index(int t, int span) {
  return ((t & ~(span - 1)) << 1) | (t & (span - 1));
}

__device__ __forceinline__ void cas_shared(unsigned long long* s, int i,
                                           int l) {
  const unsigned long long a = s[i], c = s[l];
  if (c < a) {
    s[i] = c;
    s[l] = a;
  }
}

// The bitonic network with a reversed first stage per merge: for k = 2,
// 4, .., the comparators (i, i ^ (k - 1)), then (i, i + j) for j = k / 4
// .. 1; every comparator puts the smaller key at the lower index.  Keys
// past n are +inf and never move, so a comparator reaching past n is
// skipped and n needs no padding.
__device__ void flip_stage_shared(unsigned long long* s, int n, int np,
                                  int k) {
  for (int t = threadIdx.x; t < np / 2; t += kThreads) {
    const int i = low_index(t, k >> 1), l = i ^ (k - 1);
    if (l < n) cas_shared(s, i, l);
  }
}

__device__ void half_stage_shared(unsigned long long* s, int n, int np,
                                  int j) {
  for (int t = threadIdx.x; t < np / 2; t += kThreads) {
    const int i = low_index(t, j), l = i + j;
    if (l < n) cas_shared(s, i, l);
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// sort s[0, n) in shared memory
__device__ void sort_shared(unsigned long long* s, int n) {
  const int np = pow2_at_least(n);
  for (int k = 2; k <= np; k <<= 1) {
    flip_stage_shared(s, n, np, k);
    __syncthreads();
    for (int j = k >> 2; j >= 1; j >>= 1) {
      half_stage_shared(s, n, np, j);
      __syncthreads();
    }
  }
}

// a long row's key at i: the key bits in kb, the window in ids
__device__ __forceinline__ unsigned long long row_key(const int* kb,
                                                      const int* ids, int i) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(kb[i]))
          << 32) | static_cast<unsigned>(ids[i]);
}

__device__ __forceinline__ void row_store(int* kb, int* ids, int i,
                                          unsigned long long k) {
  kb[i] = static_cast<int>(k >> 32);
  ids[i] = static_cast<int>(k & 0xffffffffu);
}

__device__ void cas_global(int* kb, int* ids, int i, int l) {
  const unsigned long long a = row_key(kb, ids, i), c = row_key(kb, ids, l);
  if (c < a) {
    row_store(kb, ids, i, c);
    row_store(kb, ids, l, a);
  }
}

// chunk [cs, cs + m) of a long row into shared memory and back, with the
// half stages j = from .. 1 (from 0: the whole sort) in between
__device__ void chunk_pass(int* kb, int* ids, int cs, int m,
                           unsigned long long* s, int ch, int from) {
  for (int t = threadIdx.x; t < m; t += kThreads)
    s[t] = row_key(kb, ids, cs + t);
  __syncthreads();
  if (from == 0) {
    sort_shared(s, m);
  } else {
    for (int j = from; j >= 1; j >>= 1) {
      half_stage_shared(s, m, ch, j);
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < m; t += kThreads)
    row_store(kb, ids, cs + t, s[t]);
  __syncthreads();
}

// sort a long row of n keys in place: each ch-key chunk in shared
// memory, then each merge's stages that span chunks in device memory and
// the rest chunk by chunk in shared memory (ch a power of two)
__device__ void sort_long(int* kb, int* ids, int n, unsigned long long* s,
                          int ch) {
  for (int cs = 0; cs < n; cs += ch)
    chunk_pass(kb, ids, cs, min(ch, n - cs), s, ch, 0);
  const int np = pow2_at_least(n);
  for (int k = 2 * ch; k <= np; k <<= 1) {
    for (int t = threadIdx.x; t < np / 2; t += kThreads) {
      const int i = low_index(t, k >> 1), l = i ^ (k - 1);
      if (l < n) cas_global(kb, ids, i, l);
    }
    __syncthreads();
    for (int j = k >> 2; j >= ch; j >>= 1) {
      for (int t = threadIdx.x; t < np / 2; t += kThreads) {
        const int i = low_index(t, j), l = i + j;
        if (l < n) cas_global(kb, ids, i, l);
      }
      __syncthreads();
    }
    for (int cs = 0; cs < n; cs += ch)
      chunk_pass(kb, ids, cs, min(ch, n - cs), s, ch, ch >> 1);
  }
}

struct Emit {
  int* b_i;
  int* c_i;
  bool* validc;
  int* pair_tiles;
  int* pair_clusters;
  const int* lib_of;
  const int* inst_of;
  int* pair_libs;
  int* pair_insts;
  int nb;

  // schedule slot i: (block, window, valid), the kernels' pair arrays
  // (tile nb and window 0 where invalid), and with the TLAS tables the
  // pair's library shape and instance
  __device__ __forceinline__ void operator()(long long i, int b, int c,
                                             bool valid) const {
    const int cc = valid ? c : 0;
    b_i[i] = b;
    c_i[i] = c;
    validc[i] = valid;
    pair_tiles[i] = valid ? b : nb;
    pair_clusters[i] = cc;
    if (lib_of) {
      pair_libs[i] = __ldg(lib_of + cc);
      pair_insts[i] = __ldg(inst_of + cc);
    }
  }
};

// U.  One CTA per block; cap: the longest row sorted in shared memory
// (cap 64-bit keys of dynamic shared memory, a power of two).
__global__ void __launch_bounds__(kThreads) bin_emit_kernel(
    int mode, int n_oct, int C, int pc_max, int cap,
    const float* __restrict__ rects, const bool* __restrict__ cfull,
    const float* __restrict__ bounds, const int* __restrict__ cnt,
    const int* __restrict__ offs, Emit emit) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ float sb[kMaxOctants * kBoxVals];
  __shared__ int s_warp[kWarps];
  const int nb = emit.nb, b = blockIdx.x, tid = threadIdx.x;
  const int total = __ldg(offs + nb), off = __ldg(offs + b);
  const int n_row = __ldg(cnt + b);
  if (total < pc_max) {
    // the slots past the total, cut in nb slices
    const long long tail = pc_max - total, per = (tail + nb - 1) / nb;
    const long long t0 = total + b * per;
    const long long t1 = t0 + per < pc_max ? t0 + per : pc_max;
    for (long long i = t0 + tid; i < t1; i += kThreads)
      emit(i, nb - 1, C - 1, false);
  }
  const int keep = min(n_row, max(pc_max - off, 0));
  if (keep <= 0) return;
  const int n_vals = mode == kBundle ? n_oct * kBoxVals : kRectVals;
  for (int k = tid; k < n_vals; k += kThreads)
    sb[k] = __ldg(bounds + static_cast<long long>(b) * n_vals + k);
  __syncthreads();
  const bool long_row = keep > cap;
  int* kb = emit.b_i + off;
  int* ids = emit.c_i + off;
  const int lane = tid & 31, warp = tid >> 5;
  // the row's first `keep` windows in ascending order
  int found = 0;
  for (int base = 0; base < C && found < keep; base += kThreads) {
    const int c = base + tid;
    float key = 0.0f;
    const bool hit = c < C && window_test(mode, n_oct, sb, rects, cfull, C,
                                          c, key);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      all += s_warp[w];
    }
    const int pos = found + before + __popc(ballot & ((1u << lane) - 1u));
    if (hit && pos < keep) {
      const unsigned long long k64 = sort_key(key, c);
      if (long_row)
        row_store(kb, ids, pos, k64);
      else
        s_keys[pos] = k64;
    }
    found += all;
    __syncthreads();
  }
  if (long_row)
    sort_long(kb, ids, keep, s_keys, cap);
  else
    sort_shared(s_keys, keep);
  for (int r = tid; r < keep; r += kThreads) {
    const int c = long_row ? ids[r]
                           : static_cast<int>(s_keys[r] & 0xffffffffu);
    emit(static_cast<long long>(off) + r, b, c, true);
  }
}

int grid_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// S.  source 0 (clusters): a = the sorted vertices (n_items * 24 points,
// 3), per_window groups a window; source 1 (TLAS pairs): a, b = pair_min,
// pair_max (n_items, 3); source 2 (bundle boxes): a, b = sub_min, sub_max
// (n_items * per_window, 3).  basis (3, 3) rows u, v, w; point (3,) or
// null (orthographic).  Writes rects (6, C) and, but for boxes, cfull
// (C,).
extern "C" int ort_bin_rects(int source, const float* a, const float* b,
                             const float* basis, const float* point,
                             int per_window, int n_items, int C, float* rects,
                             bool* cfull, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n_items);
  if (source == kSrcCluster) {
    bin_rects_kernel<kSrcCluster><<<grid, kThreads, 0, st>>>(
        a, b, basis, point, per_window, n_items, C, rects, cfull);
  } else if (source == kSrcPair) {
    bin_rects_kernel<kSrcPair><<<grid, kThreads, 0, st>>>(
        a, b, basis, point, per_window, n_items, C, rects, cfull);
  } else {
    bin_rects_kernel<kSrcBox><<<grid, kThreads, 0, st>>>(
        a, b, basis, point, per_window, n_items, C, rects, cfull);
  }
  return static_cast<int>(cudaGetLastError());
}

// T.  mode 0-2 projective ("origin", "target", "ortho": basis (3, 3),
// point (3,) for "target"), 3 bundle (n_oct direction octants, 8 or 1);
// the wave (Wave above) in W-ray blocks, nb of them; rects (6, C), cfull
// (C,) (projective).  Writes rays (8, (nb + 1) W), bounds, cnt (nb,) and
// offs (nb + 2,).
extern "C" int ort_bin_count(int mode, int n_oct, const float* o,
                             long long o_step, const float* d,
                             long long d_step, const float* t_min,
                             long long tmin_step, const float* t_max,
                             long long tmax_step, long long n, int W, int nb,
                             const float* basis, const float* point,
                             const float* rects, const bool* cfull, int C,
                             float* rays, float* bounds, int* cnt, int* offs,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(offs + nb + 1, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Wave wave = {o, o_step, d, d_step, t_min, tmin_step, t_max,
                     tmax_step, n};
  bin_count_kernel<<<nb + 1, kThreads, 0, st>>>(
      mode, n_oct, wave, W, nb, basis, point, rects, cfull, C, rays, bounds,
      cnt, offs);
  return static_cast<int>(cudaGetLastError());
}

// U.  T's bounds, cnt and offs, the rects of S; pc_max slots; cap a power
// of two, the longest row sorted in shared memory.  lib_of, inst_of (C,)
// int32 or null: the TLAS pairs' library shape and instance.  Writes
// b_i, c_i, pair_tiles, pair_clusters (pc_max,) int32, validc (pc_max,)
// bool, and with the tables pair_libs, pair_insts (pc_max,) int32.
extern "C" int ort_bin_emit(int mode, int n_oct, int nb, int C, int pc_max,
                            int cap, const float* rects, const bool* cfull,
                            const float* bounds, const int* cnt,
                            const int* offs, const int* lib_of,
                            const int* inst_of, int* b_i, int* c_i,
                            bool* validc, int* pair_tiles,
                            int* pair_clusters, int* pair_libs,
                            int* pair_insts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(cap) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Emit emit = {b_i,     c_i,     validc,    pair_tiles, pair_clusters,
                     lib_of,  inst_of, pair_libs, pair_insts, nb};
  bin_emit_kernel<<<nb, kThreads, smem, st>>>(mode, n_oct, C, pc_max, cap,
                                              rects, cfull, bounds, cnt,
                                              offs, emit);
  return static_cast<int>(cudaGetLastError());
}
