// Tile-raster kernel: dense Woop tests over a binned (ray tile, cluster
// window) pair schedule, for waves whose rays share one point (camera
// waves, point-light shadow waves).
//
// ort_tile_raster (kernel A) replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/tile_raster.py:70 _make_cluster_kernel
//   (instanced=False; via raster_cluster_call, tile_raster.py:303).
// ort_tile_raster_instanced (kernel D) replaces the same kernel with
//   instanced=True (tile_raster.py:91-98, 150-178; via
//   raster_instanced_call, tile_raster.py:376): the schedule's entries are
//   (ray tile, TLAS pair) and the rays are moved into the pair's instance
//   space in-kernel.
//
// What bounds it on the H100: the Woop tests of the scheduled pairs, ~25
// float ops per (ray, triangle); the window rows are small (64 or 128
// triangles, 3-6 KB) and read once per pair per tile.  The TPU grid walks
// the pairs one per step and keeps a tile's accumulators resident across
// its consecutive pairs.  Here one CTA owns one tile (one thread per ray,
// best t / slot / u / v in registers) and walks the tile's contiguous
// range of the tile-sorted schedule in order, so the near-to-far pair
// order and both tie rules (lowest row, then first scheduled pair) carry
// over.  Per pair the CTA slab-gates the window's sub boxes block-wide
// (__syncthreads_or(entry < best t)), as the TPU does, and stages the
// window's 12 Woop rows in shared memory only if some part is live.  With a
// common origin ("origin" waves) the three o-projections of each triangle
// are computed once per pair from the tile's first ray, the analog of the
// TPU's one-column o-dots.
//
// Kernel D is the same walk over TLAS pairs: the world sub boxes (refit
// per frame) gate on the world rays; a live entry stages its LIBRARY
// cluster's rows and loads its instance's 12 affine floats, and each
// thread moves its ray (and the tile's shared origin) into instance space
// before the Woop test (ort_to_instance).  t is the same parameter in both
// spaces, so best t carries across entries of different instances.

#include "common.cuh"

namespace {

// INST (kernel D): schedule entry p names a library cluster lib_ids[p]
// (the staged rows, one 256-triangle window, granularity 1), a TLAS pair
// pair_ids[p] (world sub boxes, slot = pair * 256 + row) and an instance
// inst_ids[p] (the affine row the tile's rays are moved by before the Woop
// test).  Otherwise entry p is the window pair_ids[p] = cluster * g + sub.
template <bool ANY_HIT, bool COMMON_ORIGIN, bool INST>
__global__ void __launch_bounds__(1024) tile_raster_kernel(
    const int* __restrict__ lib_ids, const int* __restrict__ pair_ids,
    const int* __restrict__ inst_ids, const int* __restrict__ tile_start,
    const float* __restrict__ rays, int ray_stride,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ inst_rows,
    const float* __restrict__ woop_t, int granularity,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ __align__(16) float smem[];
  const int ct = ORT_CHUNK / granularity;      // triangles per window
  const int step = ct / n_subs;                // triangles per part
  float* ws = smem;                            // 12 x ct Woop rows
  float* op = smem + 12 * ct;                  // 3 x ct o-projections
  __shared__ float o0[3];

  const int W = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int ray = b * W + tid;
  const float ox = rays[0 * ray_stride + ray], oy = rays[1 * ray_stride + ray],
              oz = rays[2 * ray_stride + ray];
  const float dx = rays[3 * ray_stride + ray], dy = rays[4 * ray_stride + ray],
              dz = rays[5 * ray_stride + ray];
  const float tmin = rays[6 * ray_stride + ray];
  float bt = rays[7 * ray_stride + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;
  float u = 0.0f, v = 0.0f;
  if (COMMON_ORIGIN && tid == 0) { o0[0] = ox; o0[1] = oy; o0[2] = oz; }

  const int p_end = tile_start[b + 1];
  for (int p = tile_start[b]; p < p_end; ++p) {
    const int pid = pair_ids[p];
    const float* sb = sub_boxes + 8 * static_cast<size_t>(pid) * n_subs;
    bool live = false;
    for (int part = 0; part < n_subs; ++part)
      live |= ort_slab_entry(sb + 8 * part, ox, oy, oz, ix, iy, iz, tmin) < bt;
    if (!__syncthreads_or(live)) continue;

    const int win = INST ? lib_ids[p] : pid;
    const float* src = woop_t
        + static_cast<size_t>(win / granularity) * ORT_WOOP_ROWS * ORT_CHUNK
        + (win % granularity) * ct;
    for (int i = tid; i < 12 * ct; i += W)
      ws[i] = src[(i / ct) * ORT_CHUNK + i % ct];
    // the test-space ray (and the tile's shared origin): world rays, or
    // moved into the entry's instance space
    float tox = ox, toy = oy, toz = oz, tdx = dx, tdy = dy, tdz = dz;
    float c0x = 0.0f, c0y = 0.0f, c0z = 0.0f;
    __syncthreads();
    if (COMMON_ORIGIN) { c0x = o0[0]; c0y = o0[1]; c0z = o0[2]; }
    if (INST) {
      const float* m = inst_rows + 128 * static_cast<size_t>(inst_ids[p]);
      ort_to_instance(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                      tdz);
      if (COMMON_ORIGIN) {
        float e0, e1, e2;
        ort_to_instance(m, c0x, c0y, c0z, 0.0f, 0.0f, 0.0f, c0x, c0y, c0z,
                        e0, e1, e2);
      }
    }
    if (COMMON_ORIGIN) {
      for (int i = tid; i < ct; i += W) {
        op[i] = ((ws[0 * ct + i] * c0x + ws[1 * ct + i] * c0y)
                 + ws[2 * ct + i] * c0z) - ws[3 * ct + i];
        op[ct + i] = ((ws[4 * ct + i] * c0x + ws[5 * ct + i] * c0y)
                      + ws[6 * ct + i] * c0z) - ws[7 * ct + i];
        op[2 * ct + i] = ((ws[8 * ct + i] * c0x + ws[9 * ct + i] * c0y)
                          + ws[10 * ct + i] * c0z) - ws[11 * ct + i];
      }
      __syncthreads();
    }

    const int slot_base = pid * ct;
    for (int part = 0; part < n_subs; ++part) {
      const float se = ort_slab_entry(sb + 8 * part, ox, oy, oz, ix, iy, iz,
                                      tmin);
      if (!__syncthreads_or(se < bt)) continue;
      for (int i = part * step; i < (part + 1) * step; ++i) {
        const float w0 = ws[0 * ct + i], w1 = ws[1 * ct + i],
                    w2 = ws[2 * ct + i];
        const float w4 = ws[4 * ct + i], w5 = ws[5 * ct + i],
                    w6 = ws[6 * ct + i];
        const float w8 = ws[8 * ct + i], w9 = ws[9 * ct + i],
                    w10 = ws[10 * ct + i];
        float opx, opy, opz;
        if (COMMON_ORIGIN) {
          opx = op[i]; opy = op[ct + i]; opz = op[2 * ct + i];
        } else {
          opx = ((w0 * tox + w1 * toy) + w2 * toz) - ws[3 * ct + i];
          opy = ((w4 * tox + w5 * toy) + w6 * toz) - ws[7 * ct + i];
          opz = ((w8 * tox + w9 * toy) + w10 * toz) - ws[11 * ct + i];
        }
        const float dpx = (w0 * tdx + w1 * tdy) + w2 * tdz;
        const float dpy = (w4 * tdx + w5 * tdy) + w6 * tdz;
        const float dpz = (w8 * tdx + w9 * tdy) + w10 * tdz;
        const bool dz_ok = fabsf(dpz) > 1e-12f;
        const float t = (-opz) / (dz_ok ? dpz : 1e-12f);
        const float uu = opx + t * dpx;
        const float vv = opy + t * dpy;
        if (dz_ok && uu >= 0.0f && vv >= 0.0f && 1.0f - (uu + vv) >= 0.0f &&
            t > tmin && t < bt) {
          slot = slot_base + i;
          if (ANY_HIT) {
            bt = -ORT_INF;
          } else {
            bt = t; u = uu; v = vv;
          }
        }
      }
    }
    __syncthreads();   // the next pair overwrites ws / op
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  out_u[ray] = u;
  out_v[ray] = v;
}

template <bool INST>
int launch(int n_blocks, int w, size_t smem, cudaStream_t s, int any_hit,
           int common_origin, const int* lib_ids, const int* pair_ids,
           const int* inst_ids, const int* tile_start, const float* rays,
           int ray_stride, const float* sub_boxes, int n_subs,
           const float* inst_rows, const float* woop_t, int granularity,
           float* out_t, int* out_slot, float* out_u, float* out_v) {
#define ORT_LAUNCH(A, O)                                                   \
  tile_raster_kernel<A, O, INST><<<n_blocks, w, smem, s>>>(                \
      lib_ids, pair_ids, inst_ids, tile_start, rays, ray_stride, sub_boxes, \
      n_subs, inst_rows, woop_t, granularity, out_t, out_slot, out_u, out_v)
  if (any_hit) {
    if (common_origin) ORT_LAUNCH(true, true); else ORT_LAUNCH(true, false);
  } else {
    if (common_origin) ORT_LAUNCH(false, true); else ORT_LAUNCH(false, false);
  }
#undef ORT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pair_ids: (>= tile_start[n_blocks],) window ids cluster * granularity +
//   sub, grouped by tile in schedule order; tile_start: (n_blocks + 1,)
//   offsets of each tile's pairs; rays: (8, ray_stride) rows
//   [o, d, t_min, t_max], tile b owns columns [b * w, (b + 1) * w);
// sub_boxes: (C * granularity, n_subs, 8); woop_t: (C, 16, 256).
// Outputs (n_blocks * w,): best t, slot (-1 miss), u, v.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ort_tile_raster(const int* pair_ids, const int* tile_start,
                               const float* rays, int ray_stride,
                               const float* sub_boxes, int n_subs,
                               const float* woop_t, int granularity,
                               int n_blocks, int w, int any_hit,
                               int common_origin, float* out_t,
                               int* out_slot, float* out_u, float* out_v,
                               void* stream) {
  const int ct = ORT_CHUNK / granularity;
  const size_t smem = 15 * static_cast<size_t>(ct) * sizeof(float);
  return launch<false>(n_blocks, w, smem, static_cast<cudaStream_t>(stream),
                       any_hit, common_origin, nullptr, pair_ids, nullptr,
                       tile_start, rays, ray_stride, sub_boxes, n_subs,
                       nullptr, woop_t, granularity, out_t, out_slot, out_u,
                       out_v);
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
    int common_origin, float* out_t, int* out_slot, float* out_u,
    float* out_v, void* stream) {
  const size_t smem = 15 * static_cast<size_t>(ORT_CHUNK) * sizeof(float);
  return launch<true>(n_blocks, w, smem, static_cast<cudaStream_t>(stream),
                      any_hit, common_origin, lib_ids, pair_ids, inst_ids,
                      tile_start, rays, ray_stride, sub_boxes, n_subs,
                      inst_rows, woop_t, 1, out_t, out_slot, out_u, out_v);
}
