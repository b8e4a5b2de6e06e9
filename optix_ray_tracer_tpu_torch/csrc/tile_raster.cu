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

#include "common.cuh"

namespace {

constexpr int kRasterWarps = 4;   // warps per CTA
constexpr int kMaxSubs = 4;       // sub boxes per window (ops/sweep)
constexpr unsigned kFull = 0xffffffffu;

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
      return reinterpret_cast<const void*>(
          warp_raster_kernel<ANY_HIT, ORT_COMMON_NONE, INST>);
  }
}

const void* raster_fn(bool instanced, bool any_hit, int common) {
  if (instanced) return any_hit ? raster_fn_common<true, true>(common)
                                : raster_fn_common<false, true>(common);
  return any_hit ? raster_fn_common<true, false>(common)
                 : raster_fn_common<false, false>(common);
}

template <bool INST>
int launch(int n_blocks, int w, cudaStream_t s, int any_hit, int common,
           const int* lib_ids, const int* pair_ids, const int* inst_ids,
           const int* tile_start, const float* rays, int ray_stride,
           const float* sub_boxes, int n_subs, const float* inst_rows,
           const float* woop_t, int granularity, float* out_t, int* out_slot,
           float* out_u, float* out_v, int* out_visits) {
  if (common < ORT_COMMON_NONE || common > ORT_COMMON_DIR)
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
    default: ORT_LAUNCH(A, ORT_COMMON_NONE); break;                         \
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

}  // namespace

// pair_ids: (>= tile_start[n_blocks],) window ids cluster * granularity +
//   sub, grouped by tile in schedule order; tile_start: (n_blocks + 1,)
//   offsets of each tile's pairs; rays: (8, ray_stride) rows
//   [o, d, t_min, t_max], tile b owns columns [b * w, (b + 1) * w) (w a
//   multiple of 32; warp k of the tile takes its rays [32 k, 32 k + 32));
// sub_boxes: (C * granularity, n_subs, 8) rows [min3, max3, 0, 0], n_subs
//   <= 4 and (256 / granularity / n_subs) a multiple of 32; woop_t:
//   (C, 16, 256).
// Outputs (n_blocks * w,): best t, slot (-1 miss), u, v; out_visits (NULL,
// or (n_blocks * w / 32,)): each warp's Woop-tested rows.
// common: 0 none, 1 origin, 2 direction (ORT_COMMON_*).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ort_tile_raster(const int* pair_ids, const int* tile_start,
                               const float* rays, int ray_stride,
                               const float* sub_boxes, int n_subs,
                               const float* woop_t, int granularity,
                               int n_blocks, int w, int any_hit,
                               int common, float* out_t,
                               int* out_slot, float* out_u, float* out_v,
                               int* out_visits, void* stream) {
  return launch<false>(n_blocks, w, static_cast<cudaStream_t>(stream),
                       any_hit, common, nullptr, pair_ids, nullptr,
                       tile_start, rays, ray_stride, sub_boxes, n_subs,
                       nullptr, woop_t, granularity, out_t, out_slot, out_u,
                       out_v, out_visits);
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
