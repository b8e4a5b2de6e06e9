// Block marcher and cluster probe: the nearest-hit / occlusion query of
// incoherent and sorted waves, and the sort keys of those waves.
//
// ort_block_march replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:173 _make_kernel
//   (instanced=False; via _march_call / block_march).
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
// The probe is one thread per ray over the cluster boxes, staged in shared
// memory; it is bound by the C slab tests per ray.

#include "common.cuh"

namespace {

template <bool ANY_HIT>
__global__ void block_march_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_clusters, int n_keys,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ woop_t,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    int* __restrict__ out_visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* ws = reinterpret_cast<float*>(keys + n_keys);   // 12 x ORT_CHUNK

  const int W = blockDim.x;
  const int tid = threadIdx.x;
  const int ray = blockIdx.x * W + tid;
  const float ox = rays[0 * n_rays + ray], oy = rays[1 * n_rays + ray],
              oz = rays[2 * n_rays + ray];
  const float dx = rays[3 * n_rays + ray], dy = rays[4 * n_rays + ray],
              dz = rays[5 * n_rays + ray];
  const float tmin = rays[6 * n_rays + ray];
  float bt = rays[7 * n_rays + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;

  // 1. block-min entry per cluster over the rays that enter it before t_max
  for (int i = tid; i < n_keys; i += W) keys[i] = ~0ull;
  __syncthreads();
  const int lane = tid & 31;
  for (int c = 0; c < n_clusters; ++c) {
    float e = ort_slab_entry(boxes + 8 * c, ox, oy, oz, ix, iy, iz, tmin);
    e = e < bt ? e : ORT_INF;
    unsigned m = __reduce_min_sync(0xffffffffu, ort_ordered(e));
    if (lane == 0)
      atomicMin(&keys[c], (static_cast<unsigned long long>(m) << 32) | c);
  }
  __syncthreads();

  // 2. ascending bitonic sort of the (entry, id) keys
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

  // 3. nearest-first march
  const int step = ORT_CHUNK / n_subs;
  int visits = 0;
  for (int k = 0; k < n_clusters; ++k) {
    const unsigned long long key = keys[k];
    // every ray's entry into this and all later clusters is >= key_e
    const float key_e = ort_unordered(static_cast<unsigned>(key >> 32));
    if (!__syncthreads_or(key_e < bt)) break;
    const int c = static_cast<int>(key & 0xffffffffu);
    const float e =
        ort_slab_entry(boxes + 8 * c, ox, oy, oz, ix, iy, iz, tmin);
    if (!__syncthreads_or(e < bt)) continue;
    ++visits;
    const float4* src = reinterpret_cast<const float4*>(
        woop_t + static_cast<size_t>(c) * ORT_WOOP_ROWS * ORT_CHUNK);
    float4* dst = reinterpret_cast<float4*>(ws);
    for (int i = tid; i < 12 * ORT_CHUNK / 4; i += W) dst[i] = src[i];
    __syncthreads();
    for (int part = 0; part < n_subs; ++part) {
      const float se = ort_slab_entry(
          sub_boxes + 8 * (static_cast<size_t>(c) * n_subs + part),
          ox, oy, oz, ix, iy, iz, tmin);
      if (!__syncthreads_or(se < bt)) continue;
      for (int r = part * step; r < (part + 1) * step; ++r) {
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
          slot = c * ORT_CHUNK + r;
          bt = ANY_HIT ? -ORT_INF : t;
        }
      }
    }
    __syncthreads();   // the next visit overwrites ws
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  if (tid == 0) out_visits[blockIdx.x] = visits;
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
  int n_keys = 1;
  while (n_keys < n_clusters) n_keys <<= 1;
  const size_t smem = n_keys * sizeof(unsigned long long) +
                      12 * ORT_CHUNK * sizeof(float);
  const dim3 grid(n_rays / block_rays), block(block_rays);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (any_hit) {
    if ((err = set_smem(reinterpret_cast<const void*>(
             block_march_kernel<true>), smem))) return err;
    block_march_kernel<true><<<grid, block, smem, s>>>(
        rays, n_rays, boxes, n_clusters, n_keys, sub_boxes, n_subs, woop_t,
        out_t, out_slot, out_visits);
  } else {
    if ((err = set_smem(reinterpret_cast<const void*>(
             block_march_kernel<false>), smem))) return err;
    block_march_kernel<false><<<grid, block, smem, s>>>(
        rays, n_rays, boxes, n_clusters, n_keys, sub_boxes, n_subs, woop_t,
        out_t, out_slot, out_visits);
  }
  return static_cast<int>(cudaGetLastError());
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
