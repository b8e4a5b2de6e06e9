// Tile-raster kernels: Woop tests over a binned (ray tile, cluster window)
// pair schedule, for waves whose rays share one point (camera waves,
// point-light shadow waves) or one direction (ortho, sun shadow waves), and
// for the 3-D bundle schedules of arbitrary waves (area-light shadow
// segments; ops/raster.bundle_query).
//
// ort_tile_raster (kernel A) replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/tile_raster.py:70 _make_cluster_kernel
//   (instanced=False; via raster_cluster_call, tile_raster.py:303), all
//   three of its `common` variants: None, "origin" and "dir".
// ort_tile_raster_instanced (kernel D) replaces the same kernel with
//   instanced=True (tile_raster.py:91-98, 150-178; via
//   raster_instanced_call, tile_raster.py:376): the schedule's entries are
//   (ray tile, TLAS pair) and the rays are moved into the pair's instance
//   space in-kernel.
//
// What bounds it on the H100: FP32 CUDA-core work, 47 operations per (ray,
// triangle) Woop test (29 when the tile shares its origin: the three
// o-projections of a row are then the tile's, not the ray's) and 26 per
// (ray, sub box) slab test, on the tests that the answers need (chip_smoke
// counts them, ops/kernels/tile_raster.needed_raster_work).  The TPU grid
// walks a tile's pairs one per step and keeps the tile's accumulators
// resident across them.  A CTA-wide copy of that walk (one thread per ray
// in 1024-thread CTAs, a __syncthreads_or gate per pair and per part, 12
// KB of rows staged between barriers) held the TLAS camera wave's kernel
// D at one CTA per SM, ran 3x the Woop tests of a per-ray gate (the gate
// fires for a part if any of 1,024 rays enters it) and took 5.787 ms
// against a 0.4786 ms bound (NVIDIA H100 80GB HBM3, 700 W).  Design here:
// the WARP walks the tile.
//
// - Each warp owns 32 rays of one tile and walks the tile's range of the
//   tile-sorted schedule on its own: every ray sees the same pairs in the
//   same near-to-far order, so both tie rules carry over (the lowest row
//   wins within a pair, the first scheduled pair across pairs: strict
//   t < best t).  No barrier spans the CTA; a warp whose tile has few
//   pairs leaves early.  CTAs are 4 warps.
// - Gates per warp: each lane computes its ray's entries into the pair's
//   sub boxes once; an __any_sync over entry < best t skips the pair, then
//   each part (re-voted on the current best t).
// - A warp's rays are 32 consecutive rays of the tile.  The camera path
//   orders each tile as 8-wide, 4-tall pixel blocks (ops/raster.to_tiles),
//   so there a warp is one block, whose rays enter the fewest parts
//   together: tools/kernel_bench.py times D's TLAS camera wave at 2.17-2.19
//   ms in that order and 2.61-2.64 ms with each tile's rays row-major
//   (a warp per 32-pixel row; NVIDIA H100 80GB HBM3, 700 W).
//   The plain version gates on the same runs and counts the same
//   Woop-tested rows per warp, so the two agree bit for bit, counts
//   included.
// - Rows reach the warp as in the marchers (ort_warp_rows, common.cuh):
//   32-row slices staged in the warp's own 1.5 KB of shared memory, read
//   back as 16-byte broadcasts, the next slice's loads in flight.  With a
//   common origin the loading lane stages each row's o-projections of the
//   tile's first ray (moved into the pair's instance space for D), as the
//   plain version computes them.  With a common direction (COMMON =
//   ORT_COMMON_DIR, the JAX kernel's common="dir" for ortho waves,
//   tile_raster.py:148-149, :219-223) it stages each row's three
//   d-projections of the tile's first ray's direction (instance space for
//   D) in 0.5 KB more per warp; each lane then spends 15 operations fewer
//   per test.  The tile's first ray is always a real ray: a block's first
//   index is below the wave's length (ops/raster._pad_wave).
// - D moves each lane's ray into the pair's instance space once per live
//   pair (ort_to_instance); t is the same parameter in both spaces, so
//   best t carries across entries of different instances.
// Shared memory: 1.5 KB per warp, fixed (2 KB with a common direction).
// out_visits counts, per warp, the Woop rows it tested (each one test on
// each of its 32 lanes).
//
// The walk is bound by issued instructions (~48 per Woop test and lane
// under -fmad=false, the IEEE divide included), not by the gate's loads:
// staging each batch of 8 pairs' sub boxes per warp in shared memory, a
// batch ahead, and 8 CTAs per SM (64 registers, spilling) were tried and
// neither made D's camera wave faster.
//
// A with no common origin or direction (bundle schedules: area-light NEE
// segments, any-hit) walks otherwise: bundle_raster_kernel, design notes
// there.  On the path pile's first NEE wave (1,875 tiles of 512 rays, 34%
// live, rows of 78 pairs on average and up to 1,196) the warp walk above
// took 1.92 ms: half its warps held no live ray and walked their rows all
// the same, every warp paid a dependent chain of loads a pair (pair id,
// sub boxes, vote), the longest rows started last, and a third of its
// Woop tests ran on rays that had already hit (tools/a_phases.py).  The
// bundle walk takes 0.46-0.48 ms there (tools/kernel_bench.py; both on an
// NVIDIA H100 80GB HBM3, 700 W).

#include "common.cuh"

namespace {

constexpr int kRasterWarps = 4;   // warps per CTA
constexpr int kMaxSubs = 4;       // sub boxes per window (ops/sweep)
constexpr int kBundleWarps = 4;   // warps per CTA of the bundle walk
// a part that at least kDenseLanes of a warp's rays enter is tested row by
// row on every lane (ort_warp_rows), one that fewer enter ray by ray
// (lane_rows); ops/kernels/tile_raster.BUNDLE_DENSE_LANES
constexpr int kDenseLanes = 24;
constexpr int kChunk = 64;        // pairs of a row a bundle CTA stages at once
constexpr int kMaxTileRays = 1024;
constexpr int kBoxFloats = 8 * kMaxSubs;   // a pair's staged sub boxes
constexpr unsigned kFull = 0xffffffffu;

// A_STAMP(unit, k, v): with ORT_A_PHASES defined (tools/a_phases.py builds
// so), slot k of row ``unit`` of a_phases takes v; compiled out otherwise.
// A row is one CTA of the bundle walk.  Slots: 0 start, 1 end (global
// timer ns), 2 tile, 3 group of packed warps, 4 pairs, 5 live lanes, 6
// Woop tests, 7 SM; its tested parts, counted per lane: 8 where the lane's
// own entry passed the gate, 9 where the lane's search was still open
// (any-hit: no hit yet).
#ifdef ORT_A_PHASES
constexpr int kPhaseUnits = 65536, kPhaseSlots = 10;
__device__ unsigned long long a_phases[kPhaseUnits][kPhaseSlots];
__device__ __forceinline__ unsigned long long a_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long a_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define A_STAMP(unit, k, v) \
  do { if ((unit) < kPhaseUnits) a_phases[unit][k] = (v); } while (0)
#else
#define A_STAMP(unit, k, v) do { } while (0)
#endif

// INST (kernel D): schedule entry p names a library cluster lib_ids[p]
// (its rows, one 256-triangle window, granularity 1), a TLAS pair
// pair_ids[p] (world sub boxes, slot = pair * 256 + row) and an instance
// inst_ids[p] (the affine row the tile's rays are moved by before the Woop
// test).  Otherwise entry p is the window pair_ids[p] = cluster * g + sub.
// COMMON: ORT_COMMON_NONE, _ORIGIN (every ray of a tile starts at the
// tile's first ray's origin) or _DIR (every ray of a tile runs along the
// tile's first ray's direction).
template <bool ANY_HIT, int COMMON, bool INST>
__global__ void __launch_bounds__(32 * kRasterWarps, 6) warp_raster_kernel(
    const int* __restrict__ lib_ids, const int* __restrict__ pair_ids,
    const int* __restrict__ inst_ids, const int* __restrict__ tile_start,
    const float* __restrict__ rays, int ray_stride,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ inst_rows,
    const float* __restrict__ woop_t, int granularity, int w, int n_warps,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_visits) {
  constexpr bool kOrigin = COMMON == ORT_COMMON_ORIGIN;
  constexpr bool kDir = COMMON == ORT_COMMON_DIR;
  __shared__ __align__(16)
      float stage[kRasterWarps][ort_stage_row<COMMON>() * ORT_SLICE];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kRasterWarps + warp;
  if (gw >= n_warps) return;   // whole warps: no barrier spans the CTA
  const int ray = 32 * gw + lane;
  const int b = ray / w;
  const int first = b * w;
  const float ox = rays[0 * ray_stride + ray], oy = rays[1 * ray_stride + ray],
              oz = rays[2 * ray_stride + ray];
  const float dx = rays[3 * ray_stride + ray], dy = rays[4 * ray_stride + ray],
              dz = rays[5 * ray_stride + ray];
  const float tmin = rays[6 * ray_stride + ray];
  float bt = rays[7 * ray_stride + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;
  float u = 0.0f, v = 0.0f;
  // a common origin or direction is the tile's first ray's (padding lanes
  // and dead rays included, as the plain version takes it)
  float c0x = 0.0f, c0y = 0.0f, c0z = 0.0f;
  if (kOrigin || kDir) {
    const int k = kOrigin ? 0 : 3;
    c0x = rays[(k + 0) * ray_stride + first];
    c0y = rays[(k + 1) * ray_stride + first];
    c0z = rays[(k + 2) * ray_stride + first];
  }
  const int ct = ORT_CHUNK / granularity;   // triangles per window
  const int step = ct / n_subs;             // triangles per part
  int tested = 0;

  const int p_end = tile_start[b + 1];
  for (int p = tile_start[b]; p < p_end; ++p) {
    const int pid = pair_ids[p];
    const float* sb = sub_boxes + 8 * static_cast<size_t>(pid) * n_subs;
    float se[kMaxSubs];
    bool live = false;
#pragma unroll
    for (int part = 0; part < kMaxSubs; ++part) {
      se[part] = part < n_subs ? ort_row_entry(sb + 8 * part, ox, oy, oz, ix,
                                               iy, iz, tmin)
                               : ORT_INF;
      live |= se[part] < bt;
    }
    if (!__any_sync(kFull, live)) continue;

    const int win = INST ? lib_ids[p] : pid;
    const float* src = woop_t
        + static_cast<size_t>(win / granularity) * ORT_WOOP_ROWS * ORT_CHUNK
        + (win % granularity) * ct;
    // the test-space ray (its origin or direction the tile's shared one):
    // world, or moved into the entry's instance space
    float tox = ox, toy = oy, toz = oz, tdx = dx, tdy = dy, tdz = dz;
    if (INST) {
      const float* m = inst_rows + 128 * static_cast<size_t>(inst_ids[p]);
      ort_to_instance(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                      tdz);
      float e0, e1, e2;
      if (kOrigin)
        ort_to_instance(m, c0x, c0y, c0z, 0.0f, 0.0f, 0.0f, tox, toy, toz,
                        e0, e1, e2);
      if (kDir)
        ort_to_instance(m, 0.0f, 0.0f, 0.0f, c0x, c0y, c0z, e0, e1, e2, tdx,
                        tdy, tdz);
    } else if (kOrigin) {
      tox = c0x; toy = c0y; toz = c0z;
    } else if (kDir) {
      tdx = c0x; tdy = c0y; tdz = c0z;
    }
    for (int part = 0; part < n_subs; ++part) {
      float e = se[0];
#pragma unroll
      for (int k = 1; k < kMaxSubs; ++k) e = part == k ? se[k] : e;
      if (!__any_sync(kFull, e < bt)) continue;
      ort_warp_rows<ANY_HIT, COMMON, true>(
          stage[warp], lane, src, part * step, step, pid * ct, tox, toy, toz,
          tdx, tdy, tdz, tmin, bt, slot, u, v);
      tested += step;
    }
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  out_u[ray] = u;
  out_v[ray] = v;
  if (out_visits && lane == 0) out_visits[gw] = tested;
}

// One row's Woop test (its 12 values q) against a ray with full-width
// dots, in ort_woop_hit's operations: whether it hits in (tmin, bt), its t
// and barycentrics.
__device__ __forceinline__ bool woop_try(const float (&q)[12], float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float tmin,
                                         float bt, float& t, float& uu,
                                         float& vv) {
  const float opx = ort_woop_proj(q[0], q[1], q[2], q[3], ox, oy, oz);
  const float opy = ort_woop_proj(q[4], q[5], q[6], q[7], ox, oy, oz);
  const float opz = ort_woop_proj(q[8], q[9], q[10], q[11], ox, oy, oz);
  const float dpx = ort_woop_dir(q[0], q[1], q[2], dx, dy, dz);
  const float dpy = ort_woop_dir(q[4], q[5], q[6], dx, dy, dz);
  const float dpz = ort_woop_dir(q[8], q[9], q[10], dx, dy, dz);
  const bool dz_ok = fabsf(dpz) > 1e-12f;
  t = (-opz) / (dz_ok ? dpz : 1e-12f);
  uu = opx + t * dpx;
  vv = opy + t * dpy;
  return dz_ok && uu >= 0.0f && vv >= 0.0f && (uu + vv) <= 1.0f &&
         t > tmin && t < bt;
}

// Woop-test rows [r0, r0 + n) of a cluster's rows w (n a multiple of 32)
// against the rays of the lanes in `need` only, ray by ray: in each block
// of 64 rows lane j holds rows j and 32 + j, every lane tests its rows
// against the ray (broadcast from its lane), and a ballot (any-hit: the
// first row that hits) or an argmin (nearest: the least t, the lower row
// at equal t) gives the ray's answer, which its lane keeps.  Each ray gets
// what ort_warp_rows gives it: among the block's hits in (tmin, its best
// t), the earliest of the least t.
template <bool ANY_HIT>
__device__ __forceinline__ void lane_rows(
    int lane, const float* __restrict__ w, int r0, int n, int slot_base,
    unsigned need, float ox, float oy, float oz, float dx, float dy,
    float dz, float tmin, float& bt, int& slot, float& u, float& v) {
  for (int s = r0; s < r0 + n; s += 64) {
    const bool two = s + 32 < r0 + n;
    float qa[12], qb[12];
    ort_load_row(qa, w, s + lane);
    if (two) ort_load_row(qb, w, s + 32 + lane);
    for (unsigned m = need; m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      const float rox = __shfl_sync(kFull, ox, r);
      const float roy = __shfl_sync(kFull, oy, r);
      const float roz = __shfl_sync(kFull, oz, r);
      const float rdx = __shfl_sync(kFull, dx, r);
      const float rdy = __shfl_sync(kFull, dy, r);
      const float rdz = __shfl_sync(kFull, dz, r);
      const float rtmin = __shfl_sync(kFull, tmin, r);
      const float rbt = __shfl_sync(kFull, bt, r);
      float ta, ua, va, tb = 0.0f, ub = 0.0f, vb = 0.0f;
      const bool ha = woop_try(qa, rox, roy, roz, rdx, rdy, rdz, rtmin, rbt,
                               ta, ua, va);
      const bool hb = two && woop_try(qb, rox, roy, roz, rdx, rdy, rdz,
                                      rtmin, rbt, tb, ub, vb);
      if (ANY_HIT) {
        const unsigned a = __ballot_sync(kFull, ha);
        const unsigned b = __ballot_sync(kFull, hb);
        if ((a | b) && lane == r) {
          slot = slot_base + s + (a ? __ffs(a) - 1 : 32 + __ffs(b) - 1);
          bt = -ORT_INF;
        }
        continue;
      }
      float tl = INFINITY, ul = 0.0f, vl = 0.0f;
      int il = 64;
      if (ha) { tl = ta; il = lane; ul = ua; vl = va; }
      if (hb && tb < tl) { tl = tb; il = 32 + lane; ul = ub; vl = vb; }
      float tm = tl;
      int im = il;
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, tm, off);
        const int oi = __shfl_xor_sync(kFull, im, off);
        if (ot < tm || (ot == tm && oi < im)) { tm = ot; im = oi; }
      }
      if (im < 64) {
        const float uw = __shfl_sync(kFull, ul, im & 31);
        const float vw = __shfl_sync(kFull, vl, im & 31);
        if (lane == r) { bt = tm; slot = slot_base + s + im; u = uw; v = vw; }
      }
    }
  }
}

// Kernel A's bundle walk (COMMON = ORT_COMMON_NONE, not INST: the 3-D
// bundle schedules of area-light NEE segments, and "target" waves).  A CTA
// of kBundleWarps warps takes one group of a tile's packed warps: the
// tile's live rays (t_max > t_min), in ray order, packed into warps of 32,
// CTA g of the tile taking packed warps [g kBundleWarps, (g + 1)
// kBundleWarps).  A CTA:
// - counts and packs its tile's live rays by ballots (each CTA of the tile
//   the same way); the tile's first CTA writes each dead ray as the plain
//   twin defines it (t = t_max, slot -1, u = v = 0); a CTA with no packed
//   warp of its own writes its Woop counts and leaves;
// - walks the tile's whole row in order, each warp for its 32 packed rays,
//   every ray seeing the pairs in the schedule's order (both tie rules of
//   the warp walk hold);
// - reads the pairs' ids and sub boxes from shared memory: the row staged
//   by cp.async in chunks of kChunk pairs, once per CTA, the next chunk's
//   copy in flight while the current one is walked; each pair first gates
//   on the union of its sub boxes (one slab test), then on each sub box;
// - gates each ray on its own: a ray takes a part's hits only if it enters
//   the part before its best t (the plain twin's per-ray gate).  A part
//   that kDenseLanes or more of the warp's rays enter is tested row by row
//   on every lane (ort_warp_rows, the other lanes' best t held at -inf for
//   it), one that fewer enter ray by ray (lane_rows: lanes hold the rows);
// - on an any-hit wave stops a warp once each of its rays has hit (no gate
//   of the row could fire again) and the CTA once all its warps have.
// Splitting long rows into chunks of other CTAs, with an exact merge of
// their partial answers, was tried first: on the any-hit wave a chunk
// cannot know that an earlier chunk occluded its rays, and it ran 5.4-13.3x
// the needed Woop tests (2.36-3.71 ms on the wave above, NVIDIA H100 80GB
// HBM3, 700 W); a row walked in order stops at the hits.  Starting the tiles longest row first (a sort of the row lengths)
// shortened the walk by ~50 us and cost more than that around it.
// out_visits: the Woop tests of the tile's packed warp k at [b * w / 32 +
// k] (0 past its packed warps): 32 a row of a part tested row by row, one
// a row for each ray that enters a part tested ray by ray.
template <bool ANY_HIT>
__global__ void __launch_bounds__(32 * kBundleWarps, 6)
    bundle_raster_kernel(const int* __restrict__ pair_ids,
                         const int* __restrict__ tile_start,
                         const float* __restrict__ rays, int ray_stride,
                         const float* __restrict__ sub_boxes, int n_subs,
                         const float* __restrict__ woop_t, int granularity,
                         int w, float* __restrict__ out_t,
                         int* __restrict__ out_slot,
                         float* __restrict__ out_u, float* __restrict__ out_v,
                         int* __restrict__ out_visits) {
  constexpr int kThreads = 32 * kBundleWarps;
  constexpr int kRounds = kMaxTileRays / kThreads;
  __shared__ __align__(16) float s_box[2][kChunk * kBoxFloats];
  __shared__ float4 s_union[2 * kChunk];
  __shared__ int s_pid[2][kChunk];
  __shared__ short s_live[kMaxTileRays];
  __shared__ int s_off[kMaxTileRays / 32 + 1];
  __shared__ __align__(16) float stage[kBundleWarps][12 * ORT_SLICE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x;
  const int groups = (w + kThreads - 1) / kThreads;   // CTAs a tile
  const int b = x / groups, g = x % groups;
  const int k = g * kBundleWarps + warp;              // the packed warp
  const int first = tile_start[b], np = tile_start[b + 1] - first;
  const int base = b * w;
#ifdef ORT_A_PHASES
  __shared__ int s_rows;
  __shared__ unsigned long long s_own, s_open;
  if (tid == 0) { A_STAMP(x, 0, a_now()); s_rows = 0; s_own = s_open = 0; }
#define A_END()                                                             \
  do {                                                                      \
    if (tid == 0) {                                                         \
      A_STAMP(x, 1, a_now()); A_STAMP(x, 2, b); A_STAMP(x, 3, g);           \
      A_STAMP(x, 4, np); A_STAMP(x, 5, s_off[kMaxTileRays / 32]);           \
      A_STAMP(x, 6, s_rows); A_STAMP(x, 7, a_smid());                       \
      A_STAMP(x, 8, s_own); A_STAMP(x, 9, s_open);                          \
    }                                                                       \
  } while (0)
#else
#define A_END() do { } while (0)
#endif

  // pairs [j0, j0 + kChunk) of the row into buffer buf: ids, and each
  // pair's n_subs rows [min3, max3, 0, 0] in 16-byte copies
  const int pieces = 2 * n_subs;
  auto stage_chunk = [&](int j0, int buf) {
    const int n = min(kChunk, np - j0);
    for (int q = tid; q < n * pieces; q += kThreads) {
      const int j = q / pieces, c = q - j * pieces;
      const int pid = __ldg(pair_ids + first + j0 + j);
      if (c == 0) s_pid[buf][j] = pid;
      ort_copy16(s_box[buf] + j * kBoxFloats + 4 * c,
                 sub_boxes + static_cast<size_t>(pid) * n_subs * 8 + 4 * c);
    }
    ort_copy_commit();
  };
  stage_chunk(0, 0);

  // the tile's live rays: a count per 32-ray group, then their offsets
  unsigned ball[kRounds];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int r = i * kThreads + tid;
    ball[i] = 0u;
    if (i * kThreads < w) {
      bool live = false;
      if (r < w) {
        const float tmin = rays[6 * ray_stride + base + r];
        const float tmax = rays[7 * ray_stride + base + r];
        live = tmax > tmin;
        if (!live && g == 0) {
          out_t[base + r] = tmax;
          out_slot[base + r] = -1;
          out_u[base + r] = 0.0f;
          out_v[base + r] = 0.0f;
        }
      }
      ball[i] = __ballot_sync(kFull, live);
      if (lane == 0 && r < w) s_off[i * kBundleWarps + warp] = __popc(ball[i]);
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int n = lane < w / 32 ? s_off[lane] : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    __syncwarp();
    if (lane < w / 32) s_off[lane] = incl - n;
    if (lane == 31) s_off[kMaxTileRays / 32] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int r = i * kThreads + tid;
    if (i * kThreads < w && r < w && ((ball[i] >> lane) & 1u))
      s_live[s_off[i * kBundleWarps + warp]
             + __popc(ball[i] & ((1u << lane) - 1u))] = static_cast<short>(r);
  }
  __syncthreads();
  const int n_live = s_off[kMaxTileRays / 32];
  if (32 * g * kBundleWarps >= n_live) {   // no packed warp of this CTA
    if (out_visits && lane == 0 && k < w / 32) out_visits[base / 32 + k] = 0;
    ort_copy_wait();
    A_END();
    return;
  }

  const int pos = 32 * k + lane;
  const bool active = pos < n_live;
  const int ray = base + (active ? s_live[pos] : 0);
  // a lane past the tile's live rays holds a ray that never passes a gate
  // nor a Woop test (best t below any entry and any t > t_min)
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float tmin = 0.0f, bt = -ORT_INF;
  if (active) {
    ox = rays[0 * ray_stride + ray]; oy = rays[1 * ray_stride + ray];
    oz = rays[2 * ray_stride + ray]; dx = rays[3 * ray_stride + ray];
    dy = rays[4 * ray_stride + ray]; dz = rays[5 * ray_stride + ray];
    tmin = rays[6 * ray_stride + ray];
    bt = rays[7 * ray_stride + ray];
  }
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy),
              iz = ort_inv_dir(dz);
  int slot = -1;
  float u = 0.0f, v = 0.0f;
  int tested = 0;
  const int ct = ORT_CHUNK / granularity;   // triangles per window
  const int step = ct / n_subs;             // triangles per part
  bool done = !__any_sync(kFull, active);
  for (int j0 = 0, buf = 0; j0 < np; j0 += kChunk, buf ^= 1) {
    if (j0 + kChunk < np) {
      stage_chunk(j0 + kChunk, buf ^ 1);
      ort_copy_wait_group<1>();
    } else {
      ort_copy_wait_group<0>();
    }
    __syncthreads();
    const int j1 = min(np, j0 + kChunk) - j0;
    // each pair's union box: a ray that does not enter it before its best
    // t enters none of the pair's sub boxes (the slab bounds are monotone
    // in the box, whichever way round its corners are; a box with a NaN
    // never fires, and fminf / fmaxf leave its NaNs out)
    for (int j = tid; j < j1; j += kThreads) {
      const float* b = s_box[buf] + j * kBoxFloats;
      float lo[3], hi[3];
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(b[a], b[3 + a]);
        hi[a] = fmaxf(b[a], b[3 + a]);
      }
      for (int part = 1; part < n_subs; ++part)
        for (int a = 0; a < 3; ++a) {
          const float l = b[8 * part + a], h = b[8 * part + 3 + a];
          lo[a] = fminf(lo[a], fminf(l, h));
          hi[a] = fmaxf(hi[a], fmaxf(l, h));
        }
      s_union[j] = make_float4(lo[0], lo[1], lo[2], hi[0]);
      s_union[kChunk + j] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < j1 && !done; ++j) {
      const float4 ulo = s_union[j], uhi = s_union[kChunk + j];
      if (!__any_sync(kFull, ort_slab_entry6(ulo.x, ulo.y, ulo.z, ulo.w,
                                             uhi.x, uhi.y, ox, oy, oz, ix, iy,
                                             iz, tmin) < bt))
        continue;
      const float4* sb = reinterpret_cast<const float4*>(s_box[buf]
                                                         + j * kBoxFloats);
      float se[kMaxSubs];
      bool live = false;
#pragma unroll
      for (int part = 0; part < kMaxSubs; ++part) {
        if (part < n_subs) {
          const float4 lo = sb[2 * part], hi = sb[2 * part + 1];
          se[part] = ort_slab_entry6(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, ox,
                                     oy, oz, ix, iy, iz, tmin);
        } else {
          se[part] = ORT_INF;
        }
        live |= se[part] < bt;
      }
      if (!__any_sync(kFull, live)) continue;
      const int pid = s_pid[buf][j];
      const float* src = woop_t
          + static_cast<size_t>(pid / granularity) * ORT_WOOP_ROWS * ORT_CHUNK
          + (pid % granularity) * ct;
      for (int part = 0; part < n_subs; ++part) {
        float e = se[0];
#pragma unroll
        for (int q = 1; q < kMaxSubs; ++q) e = part == q ? se[q] : e;
        const bool need = e < bt;
        const unsigned m = __ballot_sync(kFull, need);
        if (!m) continue;
        const int n_need = __popc(m);
#ifdef ORT_A_PHASES
        {
          const unsigned open = __popc(__ballot_sync(
              kFull, active && (!ANY_HIT || slot < 0)));
          if (lane == 0) {
            atomicAdd(&s_own, static_cast<unsigned long long>(n_need) * step);
            atomicAdd(&s_open, static_cast<unsigned long long>(open) * step);
          }
        }
#endif
        if (n_need >= kDenseLanes) {
          // every lane tests the rows; a lane whose ray does not enter the
          // part takes no hit there
          float bp = need ? bt : -ORT_INF;
          ort_warp_rows<ANY_HIT, ORT_COMMON_NONE, true>(
              stage[warp], lane, src, part * step, step, pid * ct, ox, oy,
              oz, dx, dy, dz, tmin, bp, slot, u, v);
          if (need) bt = bp;
          tested += 32 * step;
        } else {
          lane_rows<ANY_HIT>(lane, src, part * step, step, pid * ct, m, ox,
                             oy, oz, dx, dy, dz, tmin, bt, slot, u, v);
          tested += n_need * step;
        }
      }
      if (ANY_HIT) done = __all_sync(kFull, !active || slot >= 0);
    }
    if (__syncthreads_and(done)) break;   // every warp's rays have hit
  }
  ort_copy_wait();
  if (out_visits && lane == 0 && k < w / 32)
    out_visits[base / 32 + k] = tested;
#ifdef ORT_A_PHASES
  if (lane == 0) atomicAdd(&s_rows, tested);
  __syncthreads();
#endif
  if (active) {
    out_t[ray] = bt;
    out_slot[ray] = slot;
    out_u[ray] = u;
    out_v[ray] = v;
  }
  A_END();
#undef A_END
}

template <bool ANY_HIT, bool INST>
const void* raster_fn_common(int common) {
  switch (common) {
    case ORT_COMMON_ORIGIN:
      return reinterpret_cast<const void*>(
          warp_raster_kernel<ANY_HIT, ORT_COMMON_ORIGIN, INST>);
    case ORT_COMMON_DIR:
      return reinterpret_cast<const void*>(
          warp_raster_kernel<ANY_HIT, ORT_COMMON_DIR, INST>);
    default:
      if constexpr (INST)
        return reinterpret_cast<const void*>(
            warp_raster_kernel<ANY_HIT, ORT_COMMON_NONE, INST>);
      else
        return reinterpret_cast<const void*>(bundle_raster_kernel<ANY_HIT>);
  }
}

const void* raster_fn(bool instanced, bool any_hit, int common) {
  if (instanced) return any_hit ? raster_fn_common<true, true>(common)
                                : raster_fn_common<false, true>(common);
  return any_hit ? raster_fn_common<true, false>(common)
                 : raster_fn_common<false, false>(common);
}

// The warp walk of D in every variant and of A with a common origin or
// direction.
template <bool INST>
int launch(int n_blocks, int w, cudaStream_t s, int any_hit, int common,
           const int* lib_ids, const int* pair_ids, const int* inst_ids,
           const int* tile_start, const float* rays, int ray_stride,
           const float* sub_boxes, int n_subs, const float* inst_rows,
           const float* woop_t, int granularity, float* out_t, int* out_slot,
           float* out_u, float* out_v, int* out_visits) {
  if (common < ORT_COMMON_NONE || common > ORT_COMMON_DIR
      || (!INST && common == ORT_COMMON_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_warps = n_blocks * (w / 32);
  const int grid = (n_warps + kRasterWarps - 1) / kRasterWarps;
#define ORT_LAUNCH(A, C)                                                     \
  warp_raster_kernel<A, C, INST><<<grid, 32 * kRasterWarps, 0, s>>>(        \
      lib_ids, pair_ids, inst_ids, tile_start, rays, ray_stride, sub_boxes, \
      n_subs, inst_rows, woop_t, granularity, w, n_warps, out_t, out_slot,  \
      out_u, out_v, out_visits)
#define ORT_LAUNCH_COMMON(A)                                                 \
  switch (common) {                                                         \
    case ORT_COMMON_ORIGIN: ORT_LAUNCH(A, ORT_COMMON_ORIGIN); break;        \
    case ORT_COMMON_DIR: ORT_LAUNCH(A, ORT_COMMON_DIR); break;              \
    default:                                                                \
      if constexpr (INST) ORT_LAUNCH(A, ORT_COMMON_NONE);                   \
      break;                                                                \
  }
  if (any_hit) {
    ORT_LAUNCH_COMMON(true);
  } else {
    ORT_LAUNCH_COMMON(false);
  }
#undef ORT_LAUNCH_COMMON
#undef ORT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// A's bundle walk: one launch, CTAs a tile's packed warps in groups.
int launch_bundle(int n_blocks, int w, cudaStream_t s, int any_hit,
                  const int* pair_ids, const int* tile_start,
                  const float* rays, int ray_stride,
                  const float* sub_boxes, int n_subs, const float* woop_t,
                  int granularity, float* out_t, int* out_slot, float* out_u,
                  float* out_v, int* out_visits) {
  if (w > kMaxTileRays || w % 32 || n_subs > kMaxSubs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n_blocks * ((w + 32 * kBundleWarps - 1)
                               / (32 * kBundleWarps));
#define ORT_LAUNCH(A)                                                        \
  bundle_raster_kernel<A><<<grid, 32 * kBundleWarps, 0, s>>>(               \
      pair_ids, tile_start, rays, ray_stride, sub_boxes, n_subs, woop_t,    \
      granularity, w, out_t, out_slot, out_u, out_v, out_visits)
  if (any_hit) {
    ORT_LAUNCH(true);
  } else {
    ORT_LAUNCH(false);
  }
#undef ORT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pair_ids: (>= tile_start[n_blocks],) window ids cluster * granularity +
//   sub, grouped by tile in schedule order; tile_start: (n_blocks + 1,)
//   offsets of each tile's pairs; rays: (8, ray_stride) rows
//   [o, d, t_min, t_max], tile b owns columns [b * w, (b + 1) * w) (w a
//   multiple of 32, at most 1024; with a common origin or direction, warp
//   k of the tile takes its rays [32 k, 32 k + 32)); sub_boxes: (C *
//   granularity, n_subs, 8) rows [min3, max3, 0, 0], n_subs <= 4 and (256
//   / granularity / n_subs) a multiple of 32; woop_t: (C, 16, 256).
// common: 0 none (the bundle walk), 1 origin, 2 direction (ORT_COMMON_*).
// Outputs (n_blocks * w,): best t, slot (-1 miss), u, v; out_visits (NULL,
// or (n_blocks * w / 32,)): each warp's Woop-tested rows (common none: each
// packed warp's).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ort_tile_raster(const int* pair_ids, const int* tile_start,
                               const float* rays,
                               int ray_stride, const float* sub_boxes,
                               int n_subs, const float* woop_t,
                               int granularity, int n_blocks, int w,
                               int any_hit, int common,
                               float* out_t, int* out_slot, float* out_u,
                               float* out_v, int* out_visits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (common == ORT_COMMON_NONE)
    return launch_bundle(n_blocks, w, s, any_hit, pair_ids, tile_start,
                         rays, ray_stride, sub_boxes, n_subs, woop_t,
                         granularity, out_t, out_slot, out_u, out_v,
                         out_visits);
  return launch<false>(n_blocks, w, s, any_hit, common, nullptr, pair_ids,
                       nullptr, tile_start, rays, ray_stride, sub_boxes,
                       n_subs, nullptr, woop_t, granularity, out_t, out_slot,
                       out_u, out_v, out_visits);
}

// Kernel D, the TLAS raster: entry p of the tile-sorted schedule tests
// library cluster lib_ids[p] (woop_t: (SC, 16, 256) object-space rows) for
// TLAS pair pair_ids[p] (sub_boxes: (Cp, n_subs, 8) world boxes) with the
// rays moved by inst_rows[inst_ids[p]] ((P, 128) rows [A(9), b(3), 0...]).
// Slots are pair * 256 + row; the rest as ort_tile_raster at granularity 1.
extern "C" int ort_tile_raster_instanced(
    const int* lib_ids, const int* pair_ids, const int* inst_ids,
    const int* tile_start, const float* rays, int ray_stride,
    const float* sub_boxes, int n_subs, const float* inst_rows,
    const float* woop_t, int n_blocks, int w, int any_hit,
    int common, float* out_t, int* out_slot, float* out_u,
    float* out_v, int* out_visits, void* stream) {
  return launch<true>(n_blocks, w, static_cast<cudaStream_t>(stream),
                      any_hit, common, lib_ids, pair_ids, inst_ids,
                      tile_start, rays, ray_stride, sub_boxes, n_subs,
                      inst_rows, woop_t, 1, out_t, out_slot, out_u, out_v,
                      out_visits);
}

#ifdef ORT_A_PHASES
// A's stamps (kPhaseUnits x kPhaseSlots unsigned long long) to dst, then
// zeroed
extern "C" int ort_a_phases(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, a_phases, sizeof(a_phases));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* at = nullptr;
  err = cudaGetSymbolAddress(&at, a_phases);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(at, 0, sizeof(a_phases)));
}
#endif

// Resident warps per SM of kernel A (instanced = 0) or D (1) in the given
// variant, by cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
// device.  Returns the CUDA error code.
extern "C" int ort_tile_raster_occupancy(int instanced, int any_hit,
                                         int common,
                                         int* warps_per_sm) {
  int blocks = 0;
  const int err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, raster_fn(instanced, any_hit, common),
      32 * kRasterWarps, 0));
  *warps_per_sm = blocks * kRasterWarps;
  return err;
}
