// Block marchers and cluster probe: the nearest-hit / occlusion query of
// incoherent and sorted waves, and the sort keys of those waves.
//
// ort_block_march replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:173 _make_kernel
//   (instanced=False; via _march_call / block_march).
// ort_block_march_instanced replaces the same kernel with instanced=True
//   (block_march.py:177-183, 237-240, 270-295; via block_march_instanced,
//   block_march.py:916): cull rows are (instance, library cluster) TLAS
//   pairs.
// ort_block_march_hier replaces
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:463 _make_hier_kernel
//   (via _hier_call / block_march_hier, block_march.py:603, 635).
// ort_probe_first_cluster replaces
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:694 _make_probe_kernel
//   (via probe_first_cluster).
//
// What bounds the march on the H100: the Woop tests, about 30 float ops per
// (ray, triangle) pair, so the count of cluster visits per block is the
// cost.  The TPU kernel picks the nearest cluster any ray of the block
// still needs, one visit at a time, with a (C, W) entry matrix in VMEM; a
// 128-ray block's matrix for the 100k-triangle scene is ~200 KB, too much
// shared memory to keep beside a cluster's rows.  Design here: one thread
// per ray, one CTA per block of rays.  The CTA reduces each cluster's entry
// over its rays once (a warp min, then a shared atomicMin), bitonic-sorts
// the (block-min entry, cluster id) keys in shared memory, and visits the
// clusters in that order: the TPU's nearest-first order, frozen at the
// block's start.  Each visit re-tests the cluster's slab per ray and
// stages its 12 x 256 Woop rows (12 KB) in shared memory only when some
// ray of the block has entry < its best t; each 64- or 128-triangle part
// is gated the same way on its sub box.  The walk stops when no ray's best
// t exceeds the next key.  All gates and the termination are the TPU
// kernel's, so the nearest t is exact; equal-t ties go to the first
// visited (the same rule, another visit order).
//
// The instanced march (TLAS) is the same walk over pairs (<= 8192, so the
// sort keys take <= 64 KB of shared memory).  Pair and sub boxes are world
// boxes, refit per frame, gated on the world rays; a visit stages the
// pair's LIBRARY cluster (geometry stored once per shape) and each thread
// moves its ray into the pair's instance space (ort_to_instance) for the
// Woop test, so only the per-frame affine rows, not the geometry, scale
// with the instance count.
//
// The hierarchical march sorts 8-cluster superclusters instead of
// clusters (a NaN-aware union box each), so the cull and the sort shrink
// eightfold; a visited supercluster gates each of its clusters on the
// cluster's own entry, computed then.  Exact because a supercluster's
// entry is <= the entry of every cluster inside it (block_march.py:471).
//
// The probe is one thread per ray over the cluster boxes, staged in shared
// memory; it is bound by the C slab tests per ray.

#include "common.cuh"

namespace {

constexpr int kGroup = 8;   // clusters per supercluster (block_march.GROUP)

// Woop-test rows [r0, r1) of a staged 12 x ORT_CHUNK block against one ray
// (in the block's test space); slot = slot_base + row.
template <bool ANY_HIT>
__device__ __forceinline__ void woop_rows(
    const float* ws, int r0, int r1, int slot_base, float ox, float oy,
    float oz, float dx, float dy, float dz, float tmin, float& bt,
    int& slot) {
  for (int r = r0; r < r1; ++r) {
    const float* w = ws + r;
    const float w0 = w[0 * ORT_CHUNK], w1 = w[1 * ORT_CHUNK],
                w2 = w[2 * ORT_CHUNK], w3 = w[3 * ORT_CHUNK];
    const float w4 = w[4 * ORT_CHUNK], w5 = w[5 * ORT_CHUNK],
                w6 = w[6 * ORT_CHUNK], w7 = w[7 * ORT_CHUNK];
    const float w8 = w[8 * ORT_CHUNK], w9 = w[9 * ORT_CHUNK],
                w10 = w[10 * ORT_CHUNK], w11 = w[11 * ORT_CHUNK];
    const float opx = ((w0 * ox + w1 * oy) + w2 * oz) - w3;
    const float opy = ((w4 * ox + w5 * oy) + w6 * oz) - w7;
    const float opz = ((w8 * ox + w9 * oy) + w10 * oz) - w11;
    const float dpx = (w0 * dx + w1 * dy) + w2 * dz;
    const float dpy = (w4 * dx + w5 * dy) + w6 * dz;
    const float dpz = (w8 * dx + w9 * dy) + w10 * dz;
    const bool dz_ok = fabsf(dpz) > 1e-12f;
    const float t = (-opz) / (dz_ok ? dpz : 1e-12f);
    const float uu = opx + t * dpx;
    const float vv = opy + t * dpy;
    if (dz_ok && uu >= 0.0f && vv >= 0.0f && (uu + vv) <= 1.0f &&
        t > tmin && t < bt) {
      slot = slot_base + r;
      bt = ANY_HIT ? -ORT_INF : t;
    }
  }
}

// Steps 1-2 of every march: the block-min entry of each of n_boxes boxes
// over the rays that enter it before their t_max, as (ordered entry << 32
// | id) keys, sorted ascending in shared memory (n_keys a power of two).
__device__ __forceinline__ void sorted_box_keys(
    unsigned long long* keys, int n_keys, const float* __restrict__ boxes,
    int n_boxes, float ox, float oy, float oz, float ix, float iy, float iz,
    float tmin, float bt) {
  const int W = blockDim.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < n_keys; i += W) keys[i] = ~0ull;
  __syncthreads();
  const int lane = tid & 31;
  for (int c = 0; c < n_boxes; ++c) {
    float e = ort_slab_entry(boxes + 8 * c, ox, oy, oz, ix, iy, iz, tmin);
    e = e < bt ? e : ORT_INF;
    unsigned m = __reduce_min_sync(0xffffffffu, ort_ordered(e));
    if (lane == 0)
      atomicMin(&keys[c], (static_cast<unsigned long long>(m) << 32) | c);
  }
  __syncthreads();
  for (int k = 2; k <= n_keys; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_keys; i += W) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[p] = a; }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float key_entry(unsigned long long key) {
  return ort_unordered(static_cast<unsigned>(key >> 32));
}

// Copy one cluster's 12 Woop rows into shared memory (the caller syncs).
__device__ __forceinline__ void stage_rows(float* ws,
                                           const float* __restrict__ woop_t,
                                           int c) {
  const float4* src = reinterpret_cast<const float4*>(
      woop_t + static_cast<size_t>(c) * ORT_WOOP_ROWS * ORT_CHUNK);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int i = threadIdx.x; i < 12 * ORT_CHUNK / 4; i += blockDim.x)
    dst[i] = src[i];
}

// One visit's parts: each part gated block-wide on its (world) sub box,
// then Woop-tested in the test space (t*: the ray the rows expect).
template <bool ANY_HIT>
__device__ __forceinline__ void test_parts(
    const float* ws, const float* __restrict__ sub_boxes, int c, int n_subs,
    float ox, float oy, float oz, float ix, float iy, float iz, float tox,
    float toy, float toz, float tdx, float tdy, float tdz, float tmin,
    float& bt, int& slot) {
  const int step = ORT_CHUNK / n_subs;
  for (int part = 0; part < n_subs; ++part) {
    const float se = ort_slab_entry(
        sub_boxes + 8 * (static_cast<size_t>(c) * n_subs + part), ox, oy,
        oz, ix, iy, iz, tmin);
    if (!__syncthreads_or(se < bt)) continue;
    woop_rows<ANY_HIT>(ws, part * step, (part + 1) * step, c * ORT_CHUNK,
                       tox, toy, toz, tdx, tdy, tdz, tmin, bt, slot);
  }
}

// INST: rows of boxes / sub_boxes are TLAS pairs; pair c tests library
// cluster pair_shape[c] with the rays moved by inst_rows[pair_inst[c]].
template <bool ANY_HIT, bool INST>
__global__ void block_march_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_clusters, int n_keys,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ woop_t, const int* __restrict__ pair_shape,
    const int* __restrict__ pair_inst, const float* __restrict__ inst_rows,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    int* __restrict__ out_visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* ws = reinterpret_cast<float*>(keys + n_keys);   // 12 x ORT_CHUNK

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = rays[0 * n_rays + ray], oy = rays[1 * n_rays + ray],
              oz = rays[2 * n_rays + ray];
  const float dx = rays[3 * n_rays + ray], dy = rays[4 * n_rays + ray],
              dz = rays[5 * n_rays + ray];
  const float tmin = rays[6 * n_rays + ray];
  float bt = rays[7 * n_rays + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;

  sorted_box_keys(keys, n_keys, boxes, n_clusters, ox, oy, oz, ix, iy, iz,
                  tmin, bt);

  int visits = 0;
  for (int k = 0; k < n_clusters; ++k) {
    const unsigned long long key = keys[k];
    // every ray's entry into this and all later clusters is >= key_e
    if (!__syncthreads_or(key_entry(key) < bt)) break;
    const int c = static_cast<int>(key & 0xffffffffu);
    const float e =
        ort_slab_entry(boxes + 8 * c, ox, oy, oz, ix, iy, iz, tmin);
    if (!__syncthreads_or(e < bt)) continue;
    ++visits;
    float tox = ox, toy = oy, toz = oz, tdx = dx, tdy = dy, tdz = dz;
    if (INST) {
      stage_rows(ws, woop_t, pair_shape[c]);
      ort_to_instance(inst_rows + 128 * static_cast<size_t>(pair_inst[c]),
                      ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy, tdz);
    } else {
      stage_rows(ws, woop_t, c);
    }
    __syncthreads();
    test_parts<ANY_HIT>(ws, sub_boxes, c, n_subs, ox, oy, oz, ix, iy, iz,
                        tox, toy, toz, tdx, tdy, tdz, tmin, bt, slot);
    __syncthreads();   // the next visit overwrites ws
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  if (threadIdx.x == 0) out_visits[blockIdx.x] = visits;
}

template <bool ANY_HIT>
__global__ void block_march_hier_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ sup_boxes, int n_sup, int n_keys,
    const float* __restrict__ boxes, int n_clusters,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ woop_t, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ out_visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* ws = reinterpret_cast<float*>(keys + n_keys);

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = rays[0 * n_rays + ray], oy = rays[1 * n_rays + ray],
              oz = rays[2 * n_rays + ray];
  const float dx = rays[3 * n_rays + ray], dy = rays[4 * n_rays + ray],
              dz = rays[5 * n_rays + ray];
  const float tmin = rays[6 * n_rays + ray];
  float bt = rays[7 * n_rays + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;

  sorted_box_keys(keys, n_keys, sup_boxes, n_sup, ox, oy, oz, ix, iy, iz,
                  tmin, bt);

  int visits = 0;
  for (int k = 0; k < n_sup; ++k) {
    const unsigned long long key = keys[k];
    if (!__syncthreads_or(key_entry(key) < bt)) break;
    const int s = static_cast<int>(key & 0xffffffffu);
    const float es =
        ort_slab_entry(sup_boxes + 8 * s, ox, oy, oz, ix, iy, iz, tmin);
    if (!__syncthreads_or(es < bt)) continue;
    const int c_end = min(s * kGroup + kGroup, n_clusters);
    for (int c = s * kGroup; c < c_end; ++c) {
      const float e =
          ort_slab_entry(boxes + 8 * c, ox, oy, oz, ix, iy, iz, tmin);
      if (!__syncthreads_or(e < bt)) continue;
      ++visits;
      stage_rows(ws, woop_t, c);
      __syncthreads();
      test_parts<ANY_HIT>(ws, sub_boxes, c, n_subs, ox, oy, oz, ix, iy, iz,
                          ox, oy, oz, dx, dy, dz, tmin, bt, slot);
      __syncthreads();
    }
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  if (threadIdx.x == 0) out_visits[blockIdx.x] = visits;
}

__global__ void probe_kernel(const float* __restrict__ rays, int n_rays,
                             const float* __restrict__ boxes, int n_clusters,
                             int c_pad, int* __restrict__ out) {
  extern __shared__ __align__(16) float sb[];   // n_clusters x [min3 max3]
  for (int i = threadIdx.x; i < 6 * n_clusters; i += blockDim.x)
    sb[i] = boxes[8 * (i / 6) + i % 6];
  __syncthreads();
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const float ox = rays[0 * n_rays + ray], oy = rays[1 * n_rays + ray],
              oz = rays[2 * n_rays + ray];
  const float ix = ort_inv_dir(rays[3 * n_rays + ray]),
              iy = ort_inv_dir(rays[4 * n_rays + ray]),
              iz = ort_inv_dir(rays[5 * n_rays + ray]);
  const float tmin = rays[6 * n_rays + ray], tmax = rays[7 * n_rays + ray];
  float emin = ORT_INF;
  int first = c_pad;
  for (int c = 0; c < n_clusters; ++c) {
    const float e = ort_slab_entry(sb + 6 * c, ox, oy, oz, ix, iy, iz, tmin);
    if (e < tmax && e < emin) { emin = e; first = c; }
  }
  out[ray] = first;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <bool A, bool I>
int launch_march(int n_keys, int block_rays, cudaStream_t s,
                 const float* rays, int n_rays, const float* boxes,
                 int n_clusters, const float* sub_boxes, int n_subs,
                 const float* woop_t, const int* pair_shape,
                 const int* pair_inst, const float* inst_rows, float* out_t,
                 int* out_slot, int* out_visits) {
  const size_t smem = n_keys * sizeof(unsigned long long) +
                      12 * ORT_CHUNK * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(block_march_kernel<A, I>),
                     smem);
  if (err) return err;
  block_march_kernel<A, I><<<n_rays / block_rays, block_rays, smem, s>>>(
      rays, n_rays, boxes, n_clusters, n_keys, sub_boxes, n_subs, woop_t,
      pair_shape, pair_inst, inst_rows, out_t, out_slot, out_visits);
  return static_cast<int>(cudaGetLastError());
}

template <bool A>
int launch_hier(int n_keys, int block_rays, cudaStream_t s,
                const float* rays, int n_rays, const float* sup_boxes,
                int n_sup, const float* boxes, int n_clusters,
                const float* sub_boxes, int n_subs, const float* woop_t,
                float* out_t, int* out_slot, int* out_visits) {
  const size_t smem = n_keys * sizeof(unsigned long long) +
                      12 * ORT_CHUNK * sizeof(float);
  int err = set_smem(
      reinterpret_cast<const void*>(block_march_hier_kernel<A>), smem);
  if (err) return err;
  block_march_hier_kernel<A><<<n_rays / block_rays, block_rays, smem, s>>>(
      rays, n_rays, sup_boxes, n_sup, n_keys, boxes, n_clusters, sub_boxes,
      n_subs, woop_t, out_t, out_slot, out_visits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays: (8, n_rays) rows [o, d, t_min, t_max], n_rays % block_rays == 0;
// boxes: (>= n_clusters, 8) rows [min3, max3, 0, 0];
// sub_boxes: (>= n_clusters, n_subs, 8); woop_t: (C, 16, 256).
// Outputs: out_t, out_slot (n_rays,), out_visits (n_rays / block_rays,).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ort_block_march(const float* rays, int n_rays,
                               const float* boxes, int n_clusters,
                               const float* sub_boxes, int n_subs,
                               const float* woop_t, int any_hit,
                               int block_rays, float* out_t, int* out_slot,
                               int* out_visits, void* stream) {
  const int n_keys = pow2_at_least(n_clusters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = any_hit ? &launch_march<true, false>
                        : &launch_march<false, false>;
  return launch(n_keys, block_rays, s, rays, n_rays, boxes, n_clusters,
                sub_boxes, n_subs, woop_t, nullptr, nullptr, nullptr, out_t,
                out_slot, out_visits);
}

// The TLAS march: boxes / sub_boxes are (>= n_pairs, 8) / (>= n_pairs,
// n_subs, 8) WORLD pair boxes; pair_shape, pair_inst: (n_pairs,) library
// cluster and instance of each pair; inst_rows: (P, 128) rows [A(9), b(3),
// 0...] of the world->object affine; woop_t: (SC, 16, 256) library rows.
// Slots are pair * 256 + row.
extern "C" int ort_block_march_instanced(
    const float* rays, int n_rays, const float* boxes, int n_pairs,
    const float* sub_boxes, int n_subs, const int* pair_shape,
    const int* pair_inst, const float* inst_rows, const float* woop_t,
    int any_hit, int block_rays, float* out_t, int* out_slot,
    int* out_visits, void* stream) {
  const int n_keys = pow2_at_least(n_pairs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = any_hit ? &launch_march<true, true>
                        : &launch_march<false, true>;
  return launch(n_keys, block_rays, s, rays, n_rays, boxes, n_pairs,
                sub_boxes, n_subs, woop_t, pair_shape, pair_inst, inst_rows,
                out_t, out_slot, out_visits);
}

// The hierarchical march: sup_boxes (>= n_sup, 8) union boxes of clusters
// [8 s, 8 s + 8); the rest as ort_block_march.
extern "C" int ort_block_march_hier(
    const float* rays, int n_rays, const float* sup_boxes, int n_sup,
    const float* boxes, int n_clusters, const float* sub_boxes, int n_subs,
    const float* woop_t, int any_hit, int block_rays, float* out_t,
    int* out_slot, int* out_visits, void* stream) {
  const int n_keys = pow2_at_least(n_sup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = any_hit ? &launch_hier<true> : &launch_hier<false>;
  return launch(n_keys, block_rays, s, rays, n_rays, sup_boxes, n_sup,
                boxes, n_clusters, sub_boxes, n_subs, woop_t, out_t,
                out_slot, out_visits);
}

// rays: (8, n_rays); boxes: (>= n_clusters, 8).  out: (n_rays,) the id of
// the nearest cluster entered before t_max (lowest id on ties), else c_pad.
extern "C" int ort_probe_first_cluster(const float* rays, int n_rays,
                                       const float* boxes, int n_clusters,
                                       int c_pad, int* out, void* stream) {
  const size_t smem = 6 * static_cast<size_t>(n_clusters) * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(probe_kernel), smem);
  if (err) return err;
  const int block = 128;
  probe_kernel<<<(n_rays + block - 1) / block, block, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, boxes, n_clusters, c_pad, out);
  return static_cast<int>(cudaGetLastError());
}
