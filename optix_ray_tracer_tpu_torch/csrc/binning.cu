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
// - S writes the projection basis and each window's margined rect (6, C)
//   and its full-plane flag, in one launch.  The basis: the centroid of
//   the geometry seen from the shared point (vertices, or TLAS pair
//   centers) as a fixed halving tree over the rows padded to a power of
//   two (centroid_share: CTAs c < G each sum their share, a warp's loads
//   32 consecutive rows; the last CTA to arrive folds the partials and
//   publishes the basis, which every CTA waits for; the same bits at every
//   call and on every band of a wave), or the wave's shared direction
//   (ortho); then the rects from triangles (a CTA a cluster staged by
//   cp.async in 16-byte copies while the basis is made, a thread a
//   triangle, 8 lanes a group reduced by shuffles and margined, the window
//   over the warp's groups and then the CTA's warps), from a TLAS pair's 8
//   box corners (a lane a corner) or, for bundles, from a window's sub
//   boxes (a lane a sub box).
// - T runs one CTA per W-ray block: it stages the block's rays in shared
//   memory (cp.async copies of the contiguous rows, a broadcast row read
//   once; 1,024 rays at a time), so each ray is read from device memory
//   once, writes the block's columns of the transposed ray pack A and D
//   read from there (the trailing dead block by one more CTA), and reduces
//   the block's bounds: projective, the rect, depth range and live flag in
//   one pass and one CTA reduction; bundle, per direction octant the
//   origin, direction and t ranges of the live lanes, warp q reducing
//   octant q (8 warps, 8 octants) with no CTA barrier.  Then each warp
//   tests 32 windows at a time, a bundle window against the block's live
//   octants only (a compacted list), each axis and side one IEEE divide on
//   the branch its octant's guard takes, the axis loop left early once the
//   interval can no longer be non-empty (proven at octant_admits), the
//   octant loop at the first that admits it.  It writes the block's hit
//   mask (bit c of the row where window c passes) and the pair count, the
//   mask's popcounts; the last CTA to finish scans the counts into row
//   offsets (offs[nb] is the pair total).
// - U reads T's mask: a row's kept windows are its first set bits, up to
//   the capacity pc_max, found from the words' popcount prefixes.  Only a
//   kept bundle pair runs the octant test again, for its key.  A warp
//   takes a row of up to 128 kept pairs (eight rows a CTA) and sorts it by
//   (key, window) with a shuffle bitonic network, no barrier; a CTA of its
//   own takes a longer row and sorts it in shared memory (up to 8,192 pairs)
//   or, longer still, in place in its output segment (the key bits in b_i,
//   the window in c_i), each 8,192-pair chunk in shared memory, then the
//   bitonic merges across chunks in device memory.  It writes the schedule
//   at the row's offset; the slots past the total get the plain version's
//   padding (nb - 1, C - 1, invalid), cut in one slice per CTA.  The key
//   is a window's near depth (projective) or the bundle's smallest
//   admitted entry t, as a float: -0.0 ties +0.0, equal keys keep
//   ascending window ids, as the plain version's stable argsorts keep
//   them.
//
// What bounds them on the H100: S reads the geometry twice, the second
// time from L2 (the bench scene's 3.6 MB of vertices), and its CTAs meet
// once (tools/s_phases.py times the phases); T reads 32 B and writes 32 B
// a ray, and tests every (block, window) pair (a dozen operations
// projective, up to some 60 per live octant with two divides an axis for
// bundles); each CTA reads the window table from L2.  U reads the mask,
// computes the kept pairs' keys and sorts them.  They are latency-scale
// at the waves' sizes (tens of microseconds).
//
// Exactness: every float step is the plain version's in its order, with
// IEEE divides (no fast math) and the library built with -fmad=false.
// nanmin / nanmax reduce with fminf / fmaxf (NaN skipped, NaN only when
// every element is NaN); torch's amin / amax, minimum / maximum with
// min_nan / max_nan (a NaN operand gives NaN).  Min and max do not depend
// on the order of their operands, so T's and S's reductions equal the
// plain version's (a zero may differ in sign, which compares equal).
// Sums do depend on it: S's centroid adds in the twin's halving tree, its
// padding -0.0 (x + -0.0 is x, so padding past the twin's power of two
// changes no bit).  The
// bundle test takes torch's minimum / maximum as min.NaN / max.NaN, which
// may give another NaN or signed zero: no bool or kept key depends on it.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "shading.cuh"

namespace {

using namespace ort;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupTris = 8;   // triangles of a window group (GROUP_TRIS)
// S's window sources (ops/kernels/binning.RECTS_*)
constexpr int kSrcCluster = 0, kSrcPair = 1, kSrcBox = 2;
// T's and U's modes (binning.MODE_IDS)
constexpr int kOrigin = 0, kOrtho = 2, kBundle = 3;
// floats of a block's bounds: projective (bx0, bx1, by0, by1, bz0, bz1,
// live, 0); bundle, per octant (olo, ohi, dlo, dhi (3 each), t_lo, t_hi)
constexpr int kRectVals = 8;
constexpr int kBoxVals = 14;
constexpr int kMaxOctants = 8;
// rays T stages in shared memory at a time (32 KB)
constexpr int kStage = 1024;
// U: the most kept pairs a warp sorts alone (32, 64 and 128 were
// measured; 128 was the fastest), a longer row takes a CTA
constexpr int kWarpRow = 128;
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

// the sum of x over the CTA (every thread gets it)
__device__ __forceinline__ int block_sum(int x, int* scratch) {
  x = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// The projection basis of a (3, 3) rows u, v, w with w along wvec
// (binning.bin_basis_plain's _frame): each step rounded on its own, the
// norms sqrt((x x + y y) + z z), clamps that pass NaN.
__device__ __forceinline__ void frame_from(V3 wv, float* __restrict__ out) {
  const float n = max_nan(sqrtf((wv.x * wv.x + wv.y * wv.y) + wv.z * wv.z),
                          1e-12f);
  const V3 w = {wv.x / n, wv.y / n, wv.z / n};
  const bool side = fabsf(w.x) < 0.9f;
  const float ax = side ? 1.0f : 0.0f, ay = side ? 0.0f : 1.0f, az = 0.0f;
  // u = w x a, normalised; v = w x u
  V3 u = {w.y * az - w.z * ay, w.z * ax - w.x * az, w.x * ay - w.y * ax};
  const float un = max_nan(sqrtf((u.x * u.x + u.y * u.y) + u.z * u.z),
                           1e-12f);
  u = {u.x / un, u.y / un, u.z / un};
  const V3 v = {w.y * u.z - w.z * u.y, w.z * u.x - w.x * u.z,
                w.x * u.y - w.y * u.x};
  const float f[9] = {u.x, u.y, u.z, v.x, v.y, v.z, w.x, w.y, w.z};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = f[k];
}

// S's centroid: the most sum roles (a power of two, a multiple of 32: the
// fold's lanes hold kBasisCtas / 32 slots of each of 12 columns), the rows
// a thread sums in one static tree, the most levels of a thread's counter
// over those trees, the rows a role's thread should read (sizing the
// grid).
constexpr int kBasisCtas = 128;
constexpr int kBasisBlock = 8;
constexpr int kBasisLevels = 12;
constexpr int kBasisRowsPerThread = 4;
// floats of S's work buffer before the partials: the basis, padded
constexpr int kWorkHead = 16;

// S_PHASE(k): with ORT_S_PHASES defined (tools/s_phases.py builds so),
// thread 0 of each CTA writes the device's global timer to slot k of its
// row of s_phases; compiled out otherwise.
#ifdef ORT_S_PHASES
constexpr int kPhaseCtas = 8192, kPhaseSlots = 10;
__device__ unsigned long long s_phases[kPhaseCtas][kPhaseSlots];
__device__ __forceinline__ void s_phase(int k, unsigned long long v) {
  if (threadIdx.x == 0 && blockIdx.x < kPhaseCtas) s_phases[blockIdx.x][k] = v;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define S_PHASE(k) s_phase((k), global_ns())
#define S_PHASE_VALUE(k, v) s_phase((k), (v))
#else
#define S_PHASE(k)
#define S_PHASE_VALUE(k, v)
#endif

// The rows whose centroid gives S's axis: vertices less the shared point
// (kSrcCluster), or TLAS pair centers (lo + hi) 0.5 less it (kSrcPair);
// a row whose x is NaN counts as -0.0, the sum's identity.
struct CentroidRows {
  const float* a;
  const float* b;
  long long n;
  bool pair;
  V3 p;

  __device__ __forceinline__ V3 row(long long i, int& kept) const {
    if (i >= n) return {-0.0f, -0.0f, -0.0f};
    V3 q;
    if (pair) {
      const V3 lo = load3(a, i), hi = load3(b, i);
      q = {(lo.x + hi.x) * 0.5f - p.x, (lo.y + hi.y) * 0.5f - p.y,
           (lo.z + hi.z) * 0.5f - p.z};
    } else {
      q = sub3(load3(a, i), p);
    }
    if (isnan(q.x)) return {-0.0f, -0.0f, -0.0f};
    ++kept;
    return q;
  }
};

__device__ __forceinline__ V3 add3(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// The k-th subtree of a thread's rows, in bit-reversed order, into a
// binary counter of partial sums (level l holds 2^l subtrees), merged
// while k's low bits are set.
__device__ __forceinline__ void tree_push(float (&st)[kBasisLevels + 1][3],
                                          V3 v, int k) {
  int l = 0;
  for (; (k >> l) & 1; ++l)
    v = {st[l][0] + v.x, st[l][1] + v.y, st[l][2] + v.z};
  st[l][0] = v.x;
  st[l][1] = v.y;
  st[l][2] = v.z;
}

// The work buffer of S's centroid (floats after kWorkHead): partials
// (96 columns (component, lane) x G roles) and the roles' kept-row counts
// (G ints).
struct CentroidWork {
  float* partials;
  int* counts;

  __device__ CentroidWork(float* work, int G)
      : partials(work + kWorkHead),
        counts(reinterpret_cast<int*>(work + kWorkHead + 96 * G)) {}
};

// Where an S launch's CTAs meet: the CTAs arrived (the last one sets it
// back to 0) and the bases published so far.  They live on the device
// from the library's load on, so a launch needs no memset; S's launches
// on one device must not overlap (the port runs one stream a device).
__device__ __align__(128) unsigned s_arrived;
__device__ __align__(128) unsigned s_epoch;

// GPU-scope orderings of the meeting words: an acquiring load; an
// addition that releases what this CTA wrote before it (the CTA's writes
// reach thread 0 through its barrier) and acquires what the CTAs before
// released; an addition that releases.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned x) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(x) : "memory");
  return old;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned x) {
  unsigned old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(x) : "memory");
}

// Step 1 of S's centroid (perspective waves), sum role c < G, the CTA of
// that index.  The centroid's sum is the halving tree of bin_basis_plain
// over the rows padded with -0.0 to Q = 256 G 8 B rows (a power of two;
// more padding adds nothing), and the tree pairs the highest bits of a
// row's index first.  Role c takes the rows i = lane + 32 (c + G (warp +
// 8 m)): a warp's loads are 32 consecutive rows.  Each thread sums its 8 B
// rows m = r + B t in a static tree over t for each r (8 rows in flight),
// those B sums in a binary counter (r in bit-reversed order); then the
// CTA its warps (w with w + h, h = 4, 2, 1).  The lanes' 32 partials and
// the kept-row count go to work: the lowest bits, the lanes, add last.
__device__ __forceinline__ void centroid_share(CentroidRows rows, int c,
                                               int G, int outer,
                                               const CentroidWork& cw,
                                               float (&fold)[3][kThreads],
                                               int* s_int) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = 1 << outer;
  const long long base = lane + 32LL * (c + static_cast<long long>(G) * warp);
  const long long step = 32LL * G * kWarps;
  float st[kBasisLevels + 1][3];
  int kept = 0;
  for (int k = 0; k < B; ++k) {
    const long long r =
        outer ? __brev(static_cast<unsigned>(k)) >> (32 - outer) : 0;
    V3 y[kBasisBlock];
#pragma unroll
    for (int t = 0; t < kBasisBlock; ++t)
      y[t] = rows.row(base + step * (r + static_cast<long long>(B) * t),
                      kept);
    // t with t + h, h = 4, 2, 1
#pragma unroll
    for (int h = kBasisBlock / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int t = 0; t < h; ++t) y[t] = add3(y[t], y[t + h]);
    }
    tree_push(st, y[0], k);
  }
  S_PHASE(2);
#pragma unroll
  for (int k = 0; k < 3; ++k) fold[k][tid] = st[outer][k];
  __syncthreads();
  for (int h = kWarps / 2; h >= 1; h >>= 1) {
    if (warp < h) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        fold[k][tid] = fold[k][tid] + fold[k][tid + 32 * h];
    }
    __syncthreads();
  }
  if (tid < 96) cw.partials[tid * G + c] = fold[tid >> 5][lane];
  kept = block_sum(kept, s_int);
  if (tid == 0) cw.counts[c] = kept;
}

// Step 2, by the last CTA to arrive: warp w sums columns j = w + 8 i (i
// < 12) of the partials over the roles (c = e 32 + l for its lane l, e <
// kBasisCtas / 32, padded with -0.0: e with e + h, then the lanes by
// shuffles), every load in flight at once; then warp 0 the columns' lanes
// (l with l + h, h = 16 .. 1), the count, the centroid, its fallback and
// the frame, into out.
__device__ __forceinline__ void centroid_fold(int G, const CentroidWork& cw,
                                              float (&fold)[3][kThreads],
                                              int* s_int, float* out) {
  constexpr int kCols = 96 / kWarps, kSlots = kBasisCtas / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* columns = &fold[0][0];
  const int kept = tid < G ? __ldcg(cw.counts + tid) : 0;
  float v[kCols][kSlots];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      const int c = e * 32 + lane;
      v[i][e] = c < G ? __ldcg(cw.partials + (warp + kWarps * i) * G + c)
                      : -0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int h = kSlots / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int e = 0; e < h; ++e) v[i][e] = v[i][e] + v[i][e + h];
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
      v[i][0] = v[i][0] + __shfl_down_sync(0xffffffffu, v[i][0], h);
    if (lane == 0) columns[warp + kWarps * i] = v[i][0];
  }
  S_PHASE(8);
  const int total = block_sum(kept, s_int);
  if (warp != 0) return;
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = columns[k * 32 + lane];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
      w[k] = w[k] + __shfl_down_sync(0xffffffffu, w[k], h);
  }
  if (lane != 0) return;
  const float cnt = static_cast<float>(max(total, 1));
  V3 wv = {w[0] / cnt, w[1] / cnt, w[2] / cnt};
  if (!(sqrtf((wv.x * wv.x + wv.y * wv.y) + wv.z * wv.z) > 1e-12f))
    wv = {0.0f, 0.0f, 1.0f};
  frame_from(wv, out);
}

// two rects' union over shuffle distance s (every lane of the warp takes
// part)
__device__ __forceinline__ void rect_shfl(Rect& r, int s) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float o = __shfl_xor_sync(0xffffffffu, r.v[k], s);
    r.v[k] = (k & 1) ? fmaxf(r.v[k], o) : fminf(r.v[k], o);
  }
  r.full = __shfl_xor_sync(0xffffffffu, static_cast<int>(r.full), s) ||
           r.full;
}

// S, one launch.  kSrcCluster: a = the sorted vertices, a CTA a cluster
// at a time (ORT_CHUNK triangles, a thread a triangle, staged in shared
// memory by 16-byte cp.async copies, the first while the basis is made),
// per_window groups a window (a multiple of 4: whole warps), n_items
// groups; kSrcPair: a, b = the pairs' world boxes, 8 lanes a pair, a lane
// a corner, n_items pairs; kSrcBox: a, b = the sub boxes, a lane a sub
// box, per_window a window, n_items windows (no basis, an ordinary
// launch).  The others launch cooperatively (every CTA resident, so a CTA
// may wait for another) and write the basis to work[0, 9): perspective
// (persp; the point in device memory at point, else pv), CTAs c < G sum
// the centroid's shares, the last CTA to arrive folds them and publishes
// the basis (s_epoch), the others wait for it; orthographic, from the row
// wdir in every CTA, CTA 0 writing it.
template <int SRC>
__global__ void __launch_bounds__(kThreads) bin_rects_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ point, V3 pv, int persp,
    const float* __restrict__ wdir, float* __restrict__ work, int G,
    int outer, int per_window, int n_items, int C, float* __restrict__ rects,
    bool* __restrict__ cfull) {
  __shared__ __align__(16) float sv[SRC == kSrcCluster ? ORT_CHUNK * 9 : 4];
  __shared__ float fold[3][kThreads];
  __shared__ float s_basis[9];
  __shared__ Rect s_warp[kWarps];
  __shared__ int s_int[kWarps];
  __shared__ int s_role;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (SRC == kSrcBox) {
    const long long gid = static_cast<long long>(blockIdx.x) * kThreads + tid;
    const long long rows = static_cast<long long>(n_items) * per_window;
    Rect r;
    rect_init(r);
    if (gid < rows) {
      const V3 lo = load3(a, gid), hi = load3(b, gid);
      r.v[0] = lo.x;
      r.v[1] = hi.x;
      r.v[2] = lo.y;
      r.v[3] = hi.y;
      r.v[4] = lo.z;
      r.v[5] = hi.z;
    }
    for (int s = 1; s < per_window; s <<= 1) rect_shfl(r, s);
    rect_margin(r);
    if (gid < rows && gid % per_window == 0)
      rect_store(r, static_cast<int>(gid / per_window), C, rects, nullptr);
    return;
  }
  S_PHASE(0);
#ifdef ORT_S_PHASES
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  S_PHASE_VALUE(9, smid);
#endif
  const bool pp = persp != 0;
  const V3 p = point ? load3(point, 0) : pv;
  const int clusters = n_items / (ORT_CHUNK / kGroupTris);
  // the CTA's first cluster's triangles, in flight while the basis is made
  auto stage = [&](int cl) {
    const float* src = a + static_cast<long long>(cl) * ORT_CHUNK * 9;
    if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
      for (int t = tid; t < ORT_CHUNK * 9 / 4; t += kThreads)
        ort_copy16(sv + 4 * t, src + 4 * t);
    } else {
      for (int t = tid; t < ORT_CHUNK * 9; t += kThreads)
        ort_copy4(sv + t, src + t);
    }
  };
  if (SRC == kSrcCluster && blockIdx.x < clusters) stage(blockIdx.x);
  if (pp) {
    // every CTA arrives once its role (if any) is posted; the last to
    // arrive folds, writes and publishes the basis, the others wait for
    // the epoch read before they arrived to move on
    const unsigned epoch = tid == 0 ? *reinterpret_cast<volatile unsigned*>(
                                          &s_epoch)
                                    : 0u;
    const CentroidWork cw(work, G);
    if (blockIdx.x < G) {
      const CentroidRows rows = {
          a, b,
          SRC == kSrcPair ? n_items
                          : static_cast<long long>(n_items) * kGroupTris * 3,
          SRC == kSrcPair, p};
      centroid_share(rows, blockIdx.x, G, outer, cw, fold, s_int);
    }
    S_PHASE(3);
    if (tid == 0) s_role = add_acq_rel(&s_arrived, 1u) == gridDim.x - 1;
    __syncthreads();
    S_PHASE(1);
    if (s_role) {
      centroid_fold(G, cw, fold, s_int, s_basis);
      __syncthreads();
      S_PHASE(4);
      if (tid < 9) work[tid] = s_basis[tid];
      __syncthreads();
      if (tid == 0) {
        s_arrived = 0;
        add_release(&s_epoch, 1u);
      }
    } else {
      if (tid == 0) {
        while (load_acquire(&s_epoch) == epoch) __nanosleep(32);
      }
      __syncthreads();
      if (tid < 9) s_basis[tid] = __ldcg(work + tid);
    }
    S_PHASE(5);
  } else if (tid == 0) {
    frame_from(load3(wdir, 0), s_basis);
  }
  __syncthreads();
  if (!pp && blockIdx.x == 0 && tid < 9) work[tid] = s_basis[tid];
  const Basis Bs = {{s_basis[0], s_basis[1], s_basis[2]},
                    {s_basis[3], s_basis[4], s_basis[5]},
                    {s_basis[6], s_basis[7], s_basis[8]}};
  if (SRC == kSrcPair) {
    for (long long gid = static_cast<long long>(blockIdx.x) * kThreads + tid;
         (gid - tid) < 8LL * n_items;
         gid += static_cast<long long>(gridDim.x) * kThreads) {
      const bool mine = (gid >> 3) < n_items;
      Rect r;
      rect_init(r);
      if (mine) {
        // corner k = lane % 8: bit a of k picks the max on axis a, as min
        // (1 - s) + max s
        const V3 lo = load3(a, gid >> 3), hi = load3(b, gid >> 3);
        const int k = static_cast<int>(gid & 7);
        const float sx = static_cast<float>(k & 1);
        const float sy = static_cast<float>((k >> 1) & 1);
        const float sz = static_cast<float>((k >> 2) & 1);
        V3 q = {lo.x * (1.0f - sx) + hi.x * sx,
                lo.y * (1.0f - sy) + hi.y * sy,
                lo.z * (1.0f - sz) + hi.z * sz};
        if (pp) q = sub3(q, p);
        rect_add(r, q, Bs, pp);
      }
      for (int s = 1; s < 8; s <<= 1) rect_shfl(r, s);
      rect_margin(r);
      if (mine && (gid & 7) == 0)
        rect_store(r, static_cast<int>(gid >> 3), C, rects, cfull);
    }
    S_PHASE(7);
    return;
  }
  for (int cl = blockIdx.x; cl < clusters; cl += gridDim.x) {
    if (cl != blockIdx.x) {
      __syncthreads();                     // sv and s_warp are read
      stage(cl);
    }
    ort_copy_wait();
    __syncthreads();
    S_PHASE(6);
    Rect r;
    rect_init(r);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      V3 q = {sv[9 * tid + 3 * k], sv[9 * tid + 3 * k + 1],
              sv[9 * tid + 3 * k + 2]};
      if (pp) q = sub3(q, p);
      rect_add(r, q, Bs, pp);
    }
    // the 8-triangle group (8 lanes), its margin, then the window: the
    // warp's groups, then its warps
    for (int s = 1; s < kGroupTris; s <<= 1) rect_shfl(r, s);
    rect_margin(r);
    for (int s = kGroupTris; s < 32; s <<= 1) rect_shfl(r, s);
    if (lane == 0) s_warp[warp] = r;
    __syncthreads();
    const int wpw = per_window / 4;            // warps a window
    if (tid < kWarps / wpw) {
      Rect u = s_warp[tid * wpw];
      for (int w = 1; w < wpw; ++w) {
        const Rect& o = s_warp[tid * wpw + w];
#pragma unroll
        for (int k = 0; k < 6; ++k)
          u.v[k] = (k & 1) ? fmaxf(u.v[k], o.v[k]) : fminf(u.v[k], o.v[k]);
        u.full = u.full || o.full;
      }
      rect_store(u, cl * (kWarps / wpw) + tid, C, rects, cfull);
    }
  }
  S_PHASE(7);
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

// v[0..N) reduced over the warp with op (every lane gets the result)
template <int N, class Op>
__device__ __forceinline__ void warp_reduce(float (&v)[N], Op op) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = op(k, v[k], __shfl_xor_sync(0xffffffffu, v[k], s));
  }
}

// v[0..N) reduced over the CTA with op; every thread gets the result.
// scratch: kWarps * N floats.
template <int N, class Op>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* scratch,
                                             Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(v, op);
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

// The early exit of the bundle test.  After an axis the interval [lo_t,
// hi_t] only narrows: lo_t only grows through fmax_nan, hi_t only shrinks
// through fmin_nan, and a NaN stays NaN (and fails the final compare).  The
// final test margins them, f(x) = x - (|x| 1e-6 + 1e-8) and g(x) = x +
// (|x| 1e-6 + 1e-8) in float, then compares max(f(lo_t), t_lo) <=
// min(g(hi_t), t_hi).  f and g are not monotone in float (f(x) falls by
// an ulp as x passes 4.44e-10, tests/test_torch_binning.py), but the
// margin m(y) = fl(fl(|y| c) + e) (c, e the float 1e-6, 1e-8) is at most
// |y| kSlackRel + kSlackAbs (each rounding adds at most 2^-24 relative,
// 2^-150 absolute below the normal range; kSlackRel and kSlackAbs are 1e-5
// relative above c and e), so for any later y >= x (x the lo_t so far):
// y - m(y) >= y - kSlackRel |y| - kSlackAbs >= x - kSlackRel |x| -
// kSlackAbs (the right side grows with y, slope 1 +- kSlackRel) >=
// exit_floor(x), computed with rounding toward -inf; f(y), the
// nearest-rounded y - m(y), is then >= exit_floor(x) too, a float below
// it.  Likewise g(y) <= exit_ceil(x) for y <= x.  So once
// max(exit_floor(lo_t), t_lo) <= min(exit_ceil(hi_t), t_hi)
// fails (NaN included: a NaN bound makes the final compare fail too, and
// exit_floor(+inf) and exit_ceil(-inf) are NaN where f(+inf) and
// g(-inf) are), the final test fails: the exit gives the full test's bool,
// and a passing octant runs every axis, so its entry t is the full test's.
constexpr float kSlackRel = 1.00001e-6f, kSlackAbs = 1.00001e-8f;

// max_nan and min_nan in one instruction (max.NaN / min.NaN: a NaN
// operand gives the canonical NaN).  The bundle test's bool and an
// admitted entry t are the same whichever NaN or signed zero comes out: a
// NaN fails every compare, and the sort key takes -0.0 as +0.0.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float exit_floor(float x) {
  return __fsub_rd(x, __fadd_ru(__fmul_ru(fabsf(x), kSlackRel), kSlackAbs));
}

__device__ __forceinline__ float exit_ceil(float x) {
  return __fadd_ru(x, __fadd_ru(__fmul_ru(fabsf(x), kSlackRel), kSlackAbs));
}

// One direction octant's bounds s (BOX_VALS floats: olo, ohi, dlo, dhi,
// t_lo, t_hi) against a window's margined box r (lo x, hi x, lo y, hi y,
// lo z, hi z): whether interval arithmetic admits some t, and then its
// smallest admitted entry t (lo_eff).  One IEEE divide per axis and side,
// on the branch whose guard holds (the guards are the octant's, uniform
// over a warp); the axis loop exits early as proven above.
__device__ __forceinline__ bool octant_admits(const float* s,
                                              const float (&r)[6],
                                              float& lo_eff) {
  const float t_lo = s[12], t_hi = s[13];
  float lo_t = 0.0f, hi_t = ORT_INF;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float u = r[2 * ax + 1] - s[ax];      // want t dlo <= u
    const float v = r[2 * ax] - s[3 + ax];      // want t dhi >= v
    const float dl = s[6 + ax], dh = s[9 + ax];
    float lo1 = 0.0f, hi1 = ORT_INF, lo2 = 0.0f, hi2 = ORT_INF;
    if (dl > kEps) {
      hi1 = u / dl;
    } else if (dl < -kEps) {
      lo1 = u / dl;
    }
    if (dh < -kEps) {
      hi2 = v / dh;
    } else if (dh > kEps) {
      lo2 = v / dh;
    }
    lo_t = fmax_nan(lo_t, fmax_nan(lo1, lo2));
    hi_t = fmin_nan(hi_t, fmin_nan(hi1, hi2));
    if (ax < 2 && !(fmax_nan(exit_floor(lo_t), t_lo) <=
                    fmin_nan(exit_ceil(hi_t), t_hi)))
      return false;
  }
  lo_t = lo_t - (fabsf(lo_t) * 1e-6f + 1e-8f);
  hi_t = hi_t + (fabsf(hi_t) * 1e-6f + 1e-8f);
  lo_eff = fmax_nan(lo_t, t_lo);
  const float hi_eff = fmin_nan(hi_t, t_hi);
  return lo_eff <= hi_eff;          // NaN anywhere compares False
}

__device__ __forceinline__ void load_rect(const float* __restrict__ rects,
                                          int C, int c, float (&r)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    r[k] = __ldg(rects + static_cast<long long>(k) * C + c);
}

// The projective rect, depth and full-plane test of a window (rect r,
// flag full) against a block's bounds sb.
__device__ __forceinline__ bool rect_admits(const float* sb,
                                            const float (&r)[6], bool full) {
  const bool plane = (sb[0] <= r[1] && sb[1] >= r[0] && sb[2] <= r[3] &&
                      sb[3] >= r[2]) || full;
  return plane && sb[4] <= r[5] && sb[5] >= r[4];
}

// count contiguous floats from src to dst (shared, 16-byte aligned), in
// 16-byte copies where src is aligned as well
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int count) {
  int j0 = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const int n4 = count >> 2;
    for (int j = threadIdx.x; j < n4; j += kThreads)
      ort_copy16(dst + 4 * j, src + 4 * j);
    j0 = 4 * n4;
  }
  for (int j = j0 + threadIdx.x; j < count; j += kThreads)
    ort_copy4(dst + j, src + j);
}

// rows of 3 (o or d) of rays [i0, i0 + m) into dst (3 m floats): the
// contiguous rows of the wave's first mv rays copied (stage_floats), a
// broadcast row written, the rays past the wave's end given `dead`
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long step, long long i0,
                                           int mv, int m, V3 dead) {
  if (step != 0) stage_floats(dst, src + i0 * 3, 3 * mv);
  const V3 row = step == 0 ? V3{__ldg(src), __ldg(src + 1), __ldg(src + 2)}
                           : dead;
  for (int l = (step != 0 ? mv : 0) + threadIdx.x; l < m; l += kThreads) {
    const V3 x = l < mv ? row : dead;
    dst[3 * l] = x.x;
    dst[3 * l + 1] = x.y;
    dst[3 * l + 2] = x.z;
  }
}

// a per-ray bound (t_min or t_max) of rays [i0, i0 + m), as stage_rows
__device__ __forceinline__ void stage_bound(float* dst, const float* src,
                                            long long step, long long i0,
                                            int mv, int m, float dead) {
  if (step != 0) stage_floats(dst, src + i0, mv);
  const float one = step == 0 ? __ldg(src) : dead;
  for (int l = (step != 0 ? mv : 0) + threadIdx.x; l < m; l += kThreads)
    dst[l] = l < mv ? one : dead;
}

// T.  One CTA per block b < nb, one more for the trailing dead block's
// pack.  rays (8, (nb + 1) W); bounds (nb, 8) or (nb, n_oct, 14); cnt
// (nb,); offs (nb + 2,): the row offsets, offs[nb] the total, offs[nb + 1]
// the count of finished CTAs (zeroed before the launch); mask (nb, ceil(C
// / 32)): bit c % 32 of word c / 32 set where window c passes.  Dynamic
// shared memory: the staged rays, 8 sw floats (o, d, t_min, t_max) and
// sw class bytes, sw = min(W, kStage) rounded up to 4.
__global__ void __launch_bounds__(kThreads, 4) bin_count_kernel(
    int mode, int n_oct, Wave wave, int W, int nb,
    const float* __restrict__ basis, const float* __restrict__ point,
    const float* __restrict__ rects, const bool* __restrict__ cfull, int C,
    float* __restrict__ rays, float* __restrict__ bounds,
    int* __restrict__ cnt, int* __restrict__ offs, int* __restrict__ mask) {
  extern __shared__ __align__(16) float stage[];
  __shared__ float scratch[kWarps * kBoxVals];
  __shared__ float sb[kMaxOctants * kBoxVals];
  __shared__ int s_int[kWarps];
  __shared__ int s_live[kMaxOctants];
  __shared__ int s_n_live;
  __shared__ bool s_last;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int sw = (min(W, kStage) + 3) & ~3;
  float* so = stage;
  float* sd = stage + 3 * sw;
  float* st0 = stage + 6 * sw;
  float* st1 = stage + 7 * sw;
  unsigned char* cls = reinterpret_cast<unsigned char*>(stage + 8 * sw);
  const long long np = static_cast<long long>(nb + 1) * W;
  const long long first = static_cast<long long>(b) * W;
  const bool bundle = mode == kBundle;
  const bool live_block = b < nb;
  // each warp's octant in the bundle bounds: warp q reduces octant q over
  // the block; with one octant every warp reduces its share of it
  const int my_oct = n_oct == kMaxOctants ? warp : 0;
  const int l_from = n_oct == kMaxOctants ? lane : tid;
  const int l_step = n_oct == kMaxOctants ? 32 : kThreads;
  const bool persp = mode != kOrtho;
  const V3 p = point ? load3(point, 0) : V3{0.0f, 0.0f, 0.0f};
  const Basis B = bundle ? Basis{} : load_basis(basis);
  float box[kBoxVals];
#pragma unroll
  for (int k = 0; k < kBoxVals; ++k)
    box[k] = box_low(k) ? ORT_INF : -ORT_INF;       // no live lane
  float rv[kRectVals] = {nan_f(), nan_f(), nan_f(), nan_f(),
                         ORT_INF, -ORT_INF, 0.0f, 0.0f};
  for (int cs = 0; cs < W; cs += sw) {
    // stage rays [i0, i0 + m): each read from device memory once; past
    // the wave's end, _pad_wave's dead ray
    const int m = min(sw, W - cs);
    const long long i0 = first + cs;
    const int mv = static_cast<int>(
        max(0LL, min(static_cast<long long>(m), wave.n - i0)));
    if (cs > 0) __syncthreads();            // the last chunk is read
    stage_rows(so, wave.o, wave.o_step, i0, mv, m, V3{0.0f, 0.0f, 0.0f});
    stage_rows(sd, wave.d, wave.d_step, i0, mv, m, V3{0.0f, 0.0f, 1.0f});
    stage_bound(st0, wave.t_min, wave.tmin_step, i0, mv, m, 1.0f);
    stage_bound(st1, wave.t_max, wave.tmax_step, i0, mv, m, 0.0f);
    ort_copy_wait();
    __syncthreads();
    // the transposed pack (coalesced stores), each ray's class (its
    // octant if live, else kMaxOctants), the projective bounds
    for (int l = tid; l < m; l += kThreads) {
      const long long i = i0 + l;
      const V3 o = {so[3 * l], so[3 * l + 1], so[3 * l + 2]};
      const V3 d = {sd[3 * l], sd[3 * l + 1], sd[3 * l + 2]};
      const float t0 = st0[l];
      const float t1 = clamp_max(st1[l], ORT_INF);
      st1[l] = t1;
      rays[i] = o.x;
      rays[np + i] = o.y;
      rays[2 * np + i] = o.z;
      rays[3 * np + i] = d.x;
      rays[4 * np + i] = d.y;
      rays[5 * np + i] = d.z;
      rays[6 * np + i] = t0;
      rays[7 * np + i] = t1;
      const bool live = t1 > t0;
      cls[l] = !live ? kMaxOctants
                     : n_oct == kMaxOctants ? octant(d) : 0;
      if (!live_block || bundle || !live) continue;
      const V3 q = mode == kOrigin ? d : mode == kOrtho ? o : sub3(o, p);
      float x, y, qw;
      bool good;
      project(q, B, persp, x, y, qw, good);
      if (good) {
        rv[0] = fminf(rv[0], x);
        rv[1] = fmaxf(rv[1], x);
        rv[2] = fminf(rv[2], y);
        rv[3] = fmaxf(rv[3], y);
      }
      // depth along the ray: w0 + t (d . w)
      const float wd = mode == kOrigin ? qw : dot3(d, B.w);
      const float w0 = mode == kOrigin ? 0.0f : qw;
      const float a0 = t0 * wd, a1 = t1 * wd;
      rv[4] = min_nan(rv[4], w0 + min_nan(a0, a1));
      rv[5] = max_nan(rv[5], w0 + max_nan(a0, a1));
      rv[6] = 1.0f;
    }
    if (!live_block || !bundle) continue;
    __syncthreads();
    // the bundle bounds: warp q over octant q's live rays
    for (int l = l_from; l < m; l += l_step) {
      if (cls[l] != my_oct) continue;
      const float x[kBoxVals] = {so[3 * l], so[3 * l + 1], so[3 * l + 2],
                                 so[3 * l], so[3 * l + 1], so[3 * l + 2],
                                 sd[3 * l], sd[3 * l + 1], sd[3 * l + 2],
                                 sd[3 * l], sd[3 * l + 1], sd[3 * l + 2],
                                 st0[l], st1[l]};
#pragma unroll
      for (int k = 0; k < kBoxVals; ++k) box[k] = BoxOp()(k, box[k], x[k]);
    }
  }
  if (live_block) {
    if (bundle) {
      warp_reduce(box, BoxOp());
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kBoxVals; ++k)
          scratch[warp * kBoxVals + k] = box[k];
      }
      __syncthreads();
      if (tid < n_oct * kBoxVals) {
        // one warp per octant, or all warps' shares of the one octant
        const int k = tid % kBoxVals;
        float r = scratch[tid];
        if (n_oct == 1) {
          for (int w = 1; w < kWarps; ++w)
            r = BoxOp()(k, r, scratch[w * kBoxVals + k]);
        }
        sb[tid] = r;
        bounds[static_cast<long long>(b) * n_oct * kBoxVals + tid] = r;
      }
      __syncthreads();
      if (warp == 0) {
        // the octants with a live lane (t_lo < INF), in ascending order
        const bool live = lane < n_oct && sb[lane * kBoxVals + 12] < ORT_INF;
        const unsigned ballot = __ballot_sync(0xffffffffu, live);
        if (live) s_live[__popc(ballot & ((1u << lane) - 1u))] = lane;
        if (lane == 0) s_n_live = __popc(ballot);
      }
    } else {
      block_reduce(rv, scratch, RectOp());
      if (tid < kRectVals) {
        sb[tid] = rv[tid];
        bounds[static_cast<long long>(b) * kRectVals + tid] = rv[tid];
      }
    }
    __syncthreads();
    // each warp a 32-window word of the mask at a time, two words in
    // flight; the count from the words' popcounts
    const int n_live = bundle ? s_n_live : (sb[6] != 0.0f ? 1 : 0);
    const int words = (C + 31) >> 5;
    int* mrow = mask + static_cast<long long>(b) * words;
    int count = 0;
    for (int base = warp * 32; base < C; base += 2 * kThreads) {
      const int c0 = base + lane, c1 = c0 + kThreads;
      float r0[6], r1[6];
      const bool in0 = n_live > 0 && c0 < C, in1 = n_live > 0 && c1 < C;
      if (in0) load_rect(rects, C, c0, r0);
      if (in1) load_rect(rects, C, c1, r1);
      bool hit0 = false, hit1 = false;
      if (bundle) {
        float key;
        for (int j = 0; j < n_live && in0 && !hit0; ++j)
          hit0 = octant_admits(sb + s_live[j] * kBoxVals, r0, key);
        for (int j = 0; j < n_live && in1 && !hit1; ++j)
          hit1 = octant_admits(sb + s_live[j] * kBoxVals, r1, key);
      } else {
        hit0 = in0 && rect_admits(sb, r0, cfull[c0]);
        hit1 = in1 && rect_admits(sb, r1, cfull[c1]);
      }
      const unsigned w0 = __ballot_sync(0xffffffffu, hit0);
      const unsigned w1 = __ballot_sync(0xffffffffu, hit1);
      if (lane == 0) {
        mrow[base >> 5] = static_cast<int>(w0);
        count += __popc(w0);
        if (base + kThreads < C) {
          mrow[(base + kThreads) >> 5] = static_cast<int>(w1);
          count += __popc(w1);
        }
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

// A kept pair's sort key: the window's near depth (projective), or the
// smallest entry t that the live octants of block b admit (bundle; the
// pair passed T's test, so some octant admits it).
__device__ __forceinline__ unsigned long long pair_key(
    int mode, int n_oct, int b, int c, const float* __restrict__ rects,
    const float* __restrict__ bounds, int C) {
  if (mode != kBundle)
    return sort_key(__ldg(rects + 4LL * C + c), c);
  float r[6];
  load_rect(rects, C, c, r);
  float key = ORT_INF;
  const float* sb = bounds + static_cast<long long>(b) * n_oct * kBoxVals;
  for (int q = 0; q < n_oct; ++q) {
    const float* s = sb + q * kBoxVals;
    float lo_eff;
    if (s[12] < ORT_INF && octant_admits(s, r, lo_eff))
      key = fmin_nan(key, lo_eff);
  }
  return sort_key(key, c);
}

// Bitonic sort of a warp's 32 K keys, key e = lane K + k in v[k] of its
// lane, ascending: shuffles across lanes, swaps within one; no barrier.
template <int K>
__device__ __forceinline__ void warp_sort(unsigned long long (&v)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * K; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride >= 1; stride >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane * K + k;
        const bool up = (e & size) == 0;
        if (stride >= K) {
          const unsigned long long o =
              __shfl_xor_sync(0xffffffffu, v[k], stride / K);
          const bool low = (e & stride) == 0;
          v[k] = (low == up) ? (o < v[k] ? o : v[k]) : (o > v[k] ? o : v[k]);
        } else if ((k & stride) == 0) {
          const unsigned long long a = v[k], c = v[k + stride];
          if ((c < a) == up) {
            v[k] = c;
            v[k + stride] = a;
          }
        }
      }
    }
  }
}

// The first `keep` set bits of a mask row (words 32-bit), in ascending
// order, to ids[0, keep): a warp reads 32 words at a time, positions from
// the popcounts' prefix sums.
__device__ __forceinline__ void warp_ids(const int* __restrict__ mrow,
                                         int words, int keep, int* ids) {
  const int lane = threadIdx.x & 31;
  int found = 0;
  for (int base = 0; base < words && found < keep; base += 32) {
    unsigned w = base + lane < words
                     ? static_cast<unsigned>(__ldg(mrow + base + lane))
                     : 0u;
    const int pc = __popc(w);
    int incl = pc;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    for (int pos = found + incl - pc; w && pos < keep; ++pos) {
      ids[pos] = (base + lane) * 32 + __ffs(w) - 1;
      w &= w - 1;
    }
    found += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
}

// A row of keep <= 32 K pairs by one warp: its windows, their keys, the
// shuffle sort, the schedule at the row's offset.
template <int K>
__device__ __forceinline__ void warp_row(int mode, int n_oct, int C, int b,
                                         int keep, int off, int words,
                                         const float* __restrict__ rects,
                                         const float* __restrict__ bounds,
                                         const int* __restrict__ mask,
                                         int* ids, const Emit& emit) {
  const int lane = threadIdx.x & 31;
  warp_ids(mask + static_cast<long long>(b) * words, words, keep, ids);
  unsigned long long v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = lane * K + k;
    v[k] = e < keep ? pair_key(mode, n_oct, b, ids[e], rects, bounds, C)
                    : ~0ULL;
  }
  __syncwarp();
  warp_sort<K>(v);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = lane * K + k;
    if (e < keep)
      emit(static_cast<long long>(off) + e, b, static_cast<int>(v[k]), true);
  }
}

// The first `keep` set bits of a mask row by the whole CTA, 256 words at
// a time: window c at its position p in ids[p] (a long row: c_i's
// segment) or s_keys[p] (the low half).
__device__ void cta_ids(const int* __restrict__ mrow, int words, int keep,
                        bool long_row, int* ids, unsigned long long* s_keys,
                        int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int found = 0;
  for (int base = 0; base < words && found < keep; base += kThreads) {
    unsigned w = base + tid < words
                     ? static_cast<unsigned>(__ldg(mrow + base + tid))
                     : 0u;
    const int pc = __popc(w);
    int incl = pc;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, all = 0;
    for (int k = 0; k < kWarps; ++k) {
      before += k < warp ? s_warp[k] : 0;
      all += s_warp[k];
    }
    for (int pos = found + before + incl - pc; w && pos < keep; ++pos) {
      const int c = (base + tid) * 32 + __ffs(w) - 1;
      if (long_row)
        ids[pos] = c;
      else
        s_keys[pos] = static_cast<unsigned>(c);
      w &= w - 1;
    }
    found += all;
    __syncthreads();
  }
}

// U.  The first `groups` CTAs take the rows in groups of kWarps, warp w
// of CTA g row g kWarps + w when its kept pairs fit a warp (at most
// kWarpRow); CTA groups + r takes row r when it is longer,
// sorted in shared memory (cap 64-bit keys of dynamic shared memory, a
// power of two) or, past cap, in place in its output segment, and exits
// at once otherwise.  The kept windows come from T's mask; only a bundle
// pair's key runs the octant test.
__global__ void __launch_bounds__(kThreads) bin_emit_kernel(
    int mode, int n_oct, int C, int pc_max, int cap,
    const float* __restrict__ rects, const float* __restrict__ bounds,
    const int* __restrict__ cnt, const int* __restrict__ offs,
    const int* __restrict__ mask, Emit emit) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_ids[kWarps][kWarpRow];
  __shared__ int s_warp[kWarps];
  const int nb = emit.nb, tid = threadIdx.x;
  const int warp = tid >> 5;
  const int total = __ldg(offs + nb);
  const int words = (C + 31) >> 5;
  if (total < pc_max) {
    // the slots past the total, cut in gridDim.x slices
    const long long tail = pc_max - total;
    const long long per = (tail + gridDim.x - 1) / gridDim.x;
    const long long t0 = total + blockIdx.x * per;
    const long long t1 = t0 + per < pc_max ? t0 + per : pc_max;
    for (long long i = t0 + tid; i < t1; i += kThreads)
      emit(i, nb - 1, C - 1, false);
  }
  const int groups = (nb + kWarps - 1) / kWarps;
  if (blockIdx.x < groups) {
    const int b = blockIdx.x * kWarps + warp;
    if (b >= nb) return;
    const int off = __ldg(offs + b);
    const int keep = min(__ldg(cnt + b), max(pc_max - off, 0));
    int* ids = s_ids[warp];
    if (keep <= 0 || keep > kWarpRow) return;
    if (keep <= 32) {
      warp_row<1>(mode, n_oct, C, b, keep, off, words, rects, bounds, mask,
                  ids, emit);
    } else if (keep <= 64) {
      warp_row<2>(mode, n_oct, C, b, keep, off, words, rects, bounds, mask,
                  ids, emit);
    } else {
      warp_row<4>(mode, n_oct, C, b, keep, off, words, rects, bounds, mask,
                  ids, emit);
    }
    return;
  }
  const int rb = blockIdx.x - groups;
  const int off = __ldg(offs + rb);
  const int keep = min(__ldg(cnt + rb), max(pc_max - off, 0));
  if (keep <= kWarpRow) return;
  const bool long_row = keep > cap;
  int* kb = emit.b_i + off;
  int* ids = emit.c_i + off;
  cta_ids(mask + static_cast<long long>(rb) * words, words, keep, long_row,
          ids, s_keys, s_warp);
  for (int r = tid; r < keep; r += kThreads) {
    const int c = long_row ? ids[r] : static_cast<int>(s_keys[r]);
    const unsigned long long k64 =
        pair_key(mode, n_oct, rb, c, rects, bounds, C);
    if (long_row)
      row_store(kb, ids, r, k64);
    else
      s_keys[r] = k64;
  }
  __syncthreads();
  if (long_row)
    sort_long(kb, ids, keep, s_keys, cap);
  else
    sort_shared(s_keys, keep);
  for (int r = tid; r < keep; r += kThreads) {
    const int c = long_row ? ids[r]
                           : static_cast<int>(s_keys[r] & 0xffffffffu);
    emit(static_cast<long long>(off) + r, rb, c, true);
  }
}

int grid_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// The CTAs of one S launch the card holds at once (a cooperative launch
// needs them all resident), per device and source, found once.
template <int SRC>
int resident_ctas() {
  static int known[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (known[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, bin_rects_kernel<SRC>, kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    known[dev] = per_sm * sms;
  }
  return known[dev];
}

// S.  source 0 (clusters): a = the sorted vertices (n_items groups of
// 8 triangles), per_window groups a window (a multiple of 4 dividing 32);
// source 1 (TLAS pairs): a, b = pair_min, pair_max (n_items, 3); source 2
// (bundle boxes): a, b = sub_min, sub_max (n_items * per_window, 3).
// Sources 0 and 1 also write their basis (3, 3) rows u, v, w to work[0, 9):
// with persp, seen from the shared point (point in device memory, else
// (px, py, pz)), its axis the rows' centroid; else (orthographic) its axis
// the row wdir.  work: kWorkHead + 97 kBasisCtas floats.  Writes rects
// (6, C) and, but for boxes, cfull (C,).  One launch.
extern "C" int ort_bin_rects(int source, const float* a, const float* b,
                             const float* point, float px, float py,
                             float pz, int persp, const float* wdir,
                             int per_window, int n_items, int C, float* rects,
                             bool* cfull, float* work, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  V3 pv = {px, py, pz};
  if (source == kSrcBox) {
    const int grid = grid_for(static_cast<long long>(n_items) * per_window);
    if (grid > 0)
      bin_rects_kernel<kSrcBox><<<grid, kThreads, 0, st>>>(
          a, b, nullptr, pv, 0, nullptr, nullptr, 1, 0, per_window, n_items,
          C, rects, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  if (source == kSrcCluster &&
      (per_window % 4 != 0 || kWarps % (per_window / 4) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pair = source == kSrcPair;
  const int cap = pair ? resident_ctas<kSrcPair>()
                       : resident_ctas<kSrcCluster>();
  if (cap <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // CTAs: one a cluster (or 32 pairs), and enough for the centroid's rows,
  // kBasisRowsPerThread a thread; G sum roles, a power of two up to the
  // grid and kBasisCtas; 8 B rows a thread
  const long long n =
      pair ? n_items : static_cast<long long>(n_items) * kGroupTris * 3;
  long long want = pair ? (8LL * n_items + kThreads - 1) / kThreads
                        : n_items / (ORT_CHUNK / kGroupTris);
  if (persp) {
    const long long per = static_cast<long long>(kThreads) *
                          kBasisRowsPerThread;
    const long long sum_ctas = (n + per - 1) / per;
    if (sum_ctas > want) want = sum_ctas < kBasisCtas ? sum_ctas : kBasisCtas;
  }
  int grid = static_cast<int>(want < cap ? want : cap);
  if (grid < 1) grid = 1;
  int G = 1;
  while (2 * G <= grid && 2 * G <= kBasisCtas) G *= 2;
  int outer = 0;
  while ((static_cast<long long>(kThreads) * kBasisBlock * G << outer) < n)
    ++outer;
  if (outer > kBasisLevels) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a,    &b,     &point,      &pv,      &persp,
                  &wdir, &work,  &G,          &outer,   &per_window,
                  &n_items, &C,  &rects,      &cfull};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      pair ? reinterpret_cast<const void*>(bin_rects_kernel<kSrcPair>)
           : reinterpret_cast<const void*>(bin_rects_kernel<kSrcCluster>),
      grid, kThreads, args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// T.  mode 0-2 projective ("origin", "target", "ortho": basis (3, 3),
// point (3,) for "target"), 3 bundle (n_oct direction octants, 8 or 1);
// the wave (Wave above) in W-ray blocks, nb of them; rects (6, C), cfull
// (C,) (projective).  Writes rays (8, (nb + 1) W), bounds, cnt (nb,), offs
// (nb + 2,) and mask (nb, ceil(C / 32)).
extern "C" int ort_bin_count(int mode, int n_oct, const float* o,
                             long long o_step, const float* d,
                             long long d_step, const float* t_min,
                             long long tmin_step, const float* t_max,
                             long long tmax_step, long long n, int W, int nb,
                             const float* basis, const float* point,
                             const float* rects, const bool* cfull, int C,
                             float* rays, float* bounds, int* cnt, int* offs,
                             int* mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(offs + nb + 1, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Wave wave = {o, o_step, d, d_step, t_min, tmin_step, t_max,
                     tmax_step, n};
  const int sw = (min(W, kStage) + 3) & ~3;
  const size_t smem = static_cast<size_t>(sw) * (8 * sizeof(float) + 1);
  bin_count_kernel<<<nb + 1, kThreads, smem, st>>>(
      mode, n_oct, wave, W, nb, basis, point, rects, cfull, C, rays, bounds,
      cnt, offs, mask);
  return static_cast<int>(cudaGetLastError());
}

// U.  T's bounds, cnt, offs and mask, the rects of S; pc_max slots; cap a
// power of two, the longest row sorted in shared memory.  lib_of, inst_of
// (C,) int32 or null: the TLAS pairs' library shape and instance.  Writes
// b_i, c_i, pair_tiles, pair_clusters (pc_max,) int32, validc (pc_max,)
// bool, and with the tables pair_libs, pair_insts (pc_max,) int32.
extern "C" int ort_bin_emit(int mode, int n_oct, int nb, int C, int pc_max,
                            int cap, const float* rects, const float* bounds,
                            const int* cnt, const int* offs, const int* mask,
                            const int* lib_of, const int* inst_of, int* b_i,
                            int* c_i, bool* validc, int* pair_tiles,
                            int* pair_clusters, int* pair_libs,
                            int* pair_insts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(cap) * sizeof(unsigned long long);
  if (smem > 48 * 1024 - sizeof(int) * kWarps * (kWarpRow + 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Emit emit = {b_i,     c_i,     validc,    pair_tiles, pair_clusters,
                     lib_of,  inst_of, pair_libs, pair_insts, nb};
  const int groups = (nb + kWarps - 1) / kWarps;
  bin_emit_kernel<<<groups + nb, kThreads, smem, st>>>(
      mode, n_oct, C, pc_max, cap, rects, bounds, cnt, offs, mask, emit);
  return static_cast<int>(cudaGetLastError());
}

#ifdef ORT_S_PHASES
// S's phase stamps (kPhaseCtas x kPhaseSlots unsigned long long) to dst,
// then zeroed
extern "C" int ort_s_phases(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, s_phases, sizeof(s_phases));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* at = nullptr;
  err = cudaGetSymbolAddress(&at, s_phases);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(at, 0, sizeof(s_phases)));
}
#endif
