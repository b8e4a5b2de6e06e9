// Tile-raster kernel: dense Woop tests over a binned (ray tile, cluster
// window) pair schedule, for waves whose rays share one point (camera
// waves, point-light shadow waves).
//
// Replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/tile_raster.py:70 _make_cluster_kernel
//   (instanced=False; via raster_cluster_call, tile_raster.py:303).
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

#include "common.cuh"

namespace {

template <bool ANY_HIT, bool COMMON_ORIGIN>
__global__ void __launch_bounds__(1024) tile_raster_kernel(
    const int* __restrict__ pair_ids, const int* __restrict__ tile_start,
    const float* __restrict__ rays, int ray_stride,
    const float* __restrict__ sub_boxes, int n_subs,
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

    const float* src = woop_t
        + static_cast<size_t>(pid / granularity) * ORT_WOOP_ROWS * ORT_CHUNK
        + (pid % granularity) * ct;
    for (int i = tid; i < 12 * ct; i += W)
      ws[i] = src[(i / ct) * ORT_CHUNK + i % ct];
    __syncthreads();
    if (COMMON_ORIGIN) {
      for (int i = tid; i < ct; i += W) {
        op[i] = ((ws[0 * ct + i] * o0[0] + ws[1 * ct + i] * o0[1])
                 + ws[2 * ct + i] * o0[2]) - ws[3 * ct + i];
        op[ct + i] = ((ws[4 * ct + i] * o0[0] + ws[5 * ct + i] * o0[1])
                      + ws[6 * ct + i] * o0[2]) - ws[7 * ct + i];
        op[2 * ct + i] = ((ws[8 * ct + i] * o0[0] + ws[9 * ct + i] * o0[1])
                          + ws[10 * ct + i] * o0[2]) - ws[11 * ct + i];
      }
      __syncthreads();
    }

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
          opx = ((w0 * ox + w1 * oy) + w2 * oz) - ws[3 * ct + i];
          opy = ((w4 * ox + w5 * oy) + w6 * oz) - ws[7 * ct + i];
          opz = ((w8 * ox + w9 * oy) + w10 * oz) - ws[11 * ct + i];
        }
        const float dpx = (w0 * dx + w1 * dy) + w2 * dz;
        const float dpy = (w4 * dx + w5 * dy) + w6 * dz;
        const float dpz = (w8 * dx + w9 * dy) + w10 * dz;
        const bool dz_ok = fabsf(dpz) > 1e-12f;
        const float t = (-opz) / (dz_ok ? dpz : 1e-12f);
        const float uu = opx + t * dpx;
        const float vv = opy + t * dpy;
        if (dz_ok && uu >= 0.0f && vv >= 0.0f && 1.0f - (uu + vv) >= 0.0f &&
            t > tmin && t < bt) {
          slot = pid * ct + i;
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

template <bool A, bool O>
void launch(int n_blocks, int w, size_t smem, cudaStream_t s,
            const int* pair_ids, const int* tile_start, const float* rays,
            int ray_stride, const float* sub_boxes, int n_subs,
            const float* woop_t, int granularity, float* out_t,
            int* out_slot, float* out_u, float* out_v) {
  tile_raster_kernel<A, O><<<n_blocks, w, smem, s>>>(
      pair_ids, tile_start, rays, ray_stride, sub_boxes, n_subs, woop_t,
      granularity, out_t, out_slot, out_u, out_v);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ORT_LAUNCH(A, O)                                                  \
  launch<A, O>(n_blocks, w, smem, s, pair_ids, tile_start, rays,          \
               ray_stride, sub_boxes, n_subs, woop_t, granularity, out_t, \
               out_slot, out_u, out_v)
  if (any_hit) {
    if (common_origin) ORT_LAUNCH(true, true); else ORT_LAUNCH(true, false);
  } else {
    if (common_origin) ORT_LAUNCH(false, true); else ORT_LAUNCH(false, false);
  }
#undef ORT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
