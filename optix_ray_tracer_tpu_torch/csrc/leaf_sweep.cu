// Leaf sweep: the dense inner stage of the cluster-sweep intersector
// (ops/sweep.py, SweepIntersector).
//
// ort_leaf_sweep replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/leaf_sweep.py:30 _kernel
//   (via _sweep_call and window_sweep_pallas, leaf_sweep.py:77, 97).
//
// Each 128-ray block tests all of its rays against one window of 256
// consecutive rows of the sorted Woop table, woop[start : start + 256],
// and keeps per ray the nearest accepted row with t_min < t < best t (the
// first row on equal t).  The TPU kernel DMAs the window by a scalar-
// prefetched id and spends six (128 x 3) @ (3 x 256) MXU matmuls on the
// projections.  What bounds it on the H100: FP32 CUDA-core arithmetic,
// about 40 operations per (ray, row) test and 12 bytes of rays and rows
// per test at most, so operations, not bytes (a camera wave's pass is
// ~8 GFLOP against ~60 MB).  Design: one CTA of 128 threads per block,
// one thread per ray.  The CTA stages the window's 256 x 12 floats (12 KB)
// in shared memory with coalesced 16-byte loads; each thread walks the
// rows in order, every row read as a broadcast.  The projections are
// summed left to right, op_i = ((M_i0 o_x + M_i1 o_y) + M_i2 o_z) - c_i,
// the order of the plain version (ops/kernels/leaf_sweep.py), and with
// -fmad=false the two agree bit for bit.  A strict < keeps the first
// row of equal t, which is argmin's rule.  Padding rows are zero, so
// dz = 0 rejects them; filler rays have best t = 0 and never hit.
#include "common.cuh"

namespace {

constexpr int kBlockRays = 128;
constexpr int kWindow = ORT_CHUNK;   // WINDOW_TRIS = CHUNK * WINDOW_CHUNKS

__global__ void __launch_bounds__(kBlockRays) leaf_sweep_kernel(
    const float* __restrict__ woop, int n_rows,
    const int* __restrict__ starts, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_min,
    const float* __restrict__ bt_in, const int* __restrict__ slot_in,
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ __align__(16) float ws[kWindow * 12];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // dynamic_slice's clamp: the window always lies inside the table
  const int start = min(max(starts[b], 0), n_rows - kWindow);
  const float4* src = reinterpret_cast<const float4*>(
      woop + static_cast<size_t>(start) * 12);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int i = tid; i < kWindow * 12 / 4; i += kBlockRays) dst[i] = src[i];

  const size_t ray = static_cast<size_t>(b) * kBlockRays + tid;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float tmin = t_min[ray];
  const float bt = bt_in[ray];
  __syncthreads();

  // argmin over the masked t (INF where rejected): row 0 seeds the pick,
  // later rows replace it only when strictly nearer
  float cur = ORT_INF, cu = 0.0f, cv = 0.0f;
  int li = 0;
  for (int r = 0; r < kWindow; ++r) {
    const float* w = ws + 12 * r;
    const float opx = ((w[0] * ox + w[1] * oy) + w[2] * oz) - w[9];
    const float opy = ((w[3] * ox + w[4] * oy) + w[5] * oz) - w[10];
    const float opz = ((w[6] * ox + w[7] * oy) + w[8] * oz) - w[11];
    const float dpx = (w[0] * dx + w[1] * dy) + w[2] * dz;
    const float dpy = (w[3] * dx + w[4] * dy) + w[5] * dz;
    const float dpz = (w[6] * dx + w[7] * dy) + w[8] * dz;
    const bool dz_ok = fabsf(dpz) > 1e-12f;
    const float t = (-opz) / (dz_ok ? dpz : 1e-12f);
    const float uu = opx + t * dpx;
    const float vv = opy + t * dpy;
    const bool ok = dz_ok && uu >= 0.0f && vv >= 0.0f && (uu + vv) <= 1.0f &&
                    t > tmin && t < bt;
    const float tm = ok ? t : ORT_INF;
    if (r == 0 || tm < cur) {
      cur = tm;
      li = r;
      cu = uu;
      cv = vv;
    }
  }
  const bool closer = cur < bt;
  out_t[ray] = closer ? cur : bt;
  out_slot[ray] = closer ? start + li : slot_in[ray];
  out_u[ray] = closer ? cu : u_in[ray];
  out_v[ray] = closer ? cv : v_in[ray];
}

}  // namespace

// woop: (n_rows, 12) rows [M row-major (9), c (3)], n_rows a multiple of
// 256; starts: (n_blocks,) window start rows; o, d: (n_blocks * 128, 3);
// t_min, bt_in, slot_in, u_in, v_in and the outputs: (n_blocks * 128,).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ort_leaf_sweep(const float* woop, int n_rows,
                              const int* starts, int n_blocks,
                              const float* o, const float* d,
                              const float* t_min, const float* bt_in,
                              const int* slot_in, const float* u_in,
                              const float* v_in, float* out_t, int* out_slot,
                              float* out_u, float* out_v, void* stream) {
  leaf_sweep_kernel<<<n_blocks, kBlockRays, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      woop, n_rows, starts, o, d, t_min, bt_in, slot_in, u_in, v_in, out_t,
      out_slot, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
