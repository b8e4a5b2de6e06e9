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
// about 47 operations per (ray, row) test and 12 bytes of rays and rows
// per test at most, so operations, not bytes (a camera wave's pass is
// ~13 GFLOP against ~60 MB).  The projections are summed left to right,
// op_i = ((M_i0 o_x + M_i1 o_y) + M_i2 o_z) - c_i, the order of the plain
// version (ops/kernels/leaf_sweep.py), and with -fmad=false the two agree
// bit for bit.  Padding rows are zero, so dz = 0 rejects them.
//
// A first design (one thread per ray in 128-thread CTAs, each row re-read
// as 12 scalar shared loads and u, v carried through every row) issued
// ~80 instructions per test: 0.762 ms for the camera wave's first pass
// (8,578 blocks; NVIDIA H100 80GB HBM3, 700 W).  Design here:
//
// - Register blocking.  A CTA of 64 threads takes a block; each thread
//   holds kRaysPerThread consecutive rays, so each staged row (three
//   16-byte shared loads) serves that many tests.
// - Only (t, row) in the loop.  Row 0 seeds the argmin and a later row
//   replaces it only on a strictly smaller masked t (argmin's first
//   minimum); the winner's u and v are recomputed once after the loop
//   from its staged row by the same expressions, so they are bit-equal to
//   the ones the loop would have kept.
// - Dead lanes skipped.  A ray with !(t_min < best t) accepts no row (an
//   accepted t lies in (t_min, best t); a NaN bound accepts none) and
//   keeps its inputs unless best t > INF (then the plain version's
//   all-INF argmin still takes row 0), so a warp of such rays writes its
//   inputs back untested and a CTA of them stages nothing: the filler
//   lanes of each window group (ops/sweep.py: t_min 1, best t 0) and
//   dead bounce rays.
// Its loop issues ~65 instructions per test (the IEEE divide and its
// slow-path check 13): the camera wave's first pass, 2.81e8 tests in
// 0.63-0.65 ms, issues 2.8-2.9e13 lane instructions per second, 4 warp
// instructions per clock on every SM at ~1.7 GHz (NVIDIA H100 80GB HBM3,
// 700 W).  Four rays per thread were slower (0.66 ms).
#include "common.cuh"

namespace {

constexpr int kBlockRays = 128;
constexpr int kRaysPerThread = 2;
constexpr int kThreads = kBlockRays / kRaysPerThread;
constexpr int kWindow = ORT_CHUNK;   // WINDOW_TRIS = CHUNK * WINDOW_CHUNKS
constexpr unsigned kFull = 0xffffffffu;

struct SweepRay {
  float ox, oy, oz, dx, dy, dz, tmin, bt;
};

// The Woop test of one staged row p (three float4: M row-major, then c)
// against one ray: (t, uu, vv) and whether the row is accepted.
__device__ __forceinline__ bool sweep_test(const float4* p, const SweepRay& q,
                                           float& t, float& uu, float& vv) {
  const float4 a = p[0], b = p[1], c = p[2];
  const float opx = ((a.x * q.ox + a.y * q.oy) + a.z * q.oz) - c.y;
  const float opy = ((a.w * q.ox + b.x * q.oy) + b.y * q.oz) - c.z;
  const float opz = ((b.z * q.ox + b.w * q.oy) + c.x * q.oz) - c.w;
  const float dpx = (a.x * q.dx + a.y * q.dy) + a.z * q.dz;
  const float dpy = (a.w * q.dx + b.x * q.dy) + b.y * q.dz;
  const float dpz = (b.z * q.dx + b.w * q.dy) + c.x * q.dz;
  const bool dz_ok = fabsf(dpz) > 1e-12f;
  t = (-opz) / (dz_ok ? dpz : 1e-12f);
  uu = opx + t * dpx;
  vv = opy + t * dpy;
  return dz_ok && uu >= 0.0f && vv >= 0.0f && (uu + vv) <= 1.0f &&
         t > q.tmin && t < q.bt;
}

__device__ __forceinline__ float masked_t(const float4* p, const SweepRay& q) {
  float t, uu, vv;
  return sweep_test(p, q, t, uu, vv) ? t : ORT_INF;
}

__global__ void __launch_bounds__(kThreads) leaf_sweep_kernel(
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
  const size_t ray0 = static_cast<size_t>(b) * kBlockRays +
                      kRaysPerThread * tid;
  SweepRay q[kRaysPerThread];
  bool live = false;
#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j) {
    const size_t ray = ray0 + j;
    q[j] = SweepRay{o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                    d[3 * ray], d[3 * ray + 1], d[3 * ray + 2],
                    t_min[ray], bt_in[ray]};
    live |= q[j].tmin < q[j].bt || q[j].bt > ORT_INF;
  }
  const bool warp_live = __any_sync(kFull, live);
  float cur[kRaysPerThread];
  int li[kRaysPerThread];
#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j) { cur[j] = ORT_INF; li[j] = 0; }
  // dynamic_slice's clamp: the window always lies inside the table
  const int start = min(max(starts[b], 0), n_rows - kWindow);

  if (__syncthreads_or(live)) {
    const float4* src = reinterpret_cast<const float4*>(
        woop + static_cast<size_t>(start) * 12);
    float4* dst = reinterpret_cast<float4*>(ws);
    for (int i = tid; i < kWindow * 12 / 4; i += kThreads) dst[i] = src[i];
    __syncthreads();
    if (warp_live) {
      // argmin over the masked t (INF where rejected): row 0 seeds the
      // pick, later rows replace it only when strictly nearer
      const float4* p0 = reinterpret_cast<const float4*>(ws);
#pragma unroll
      for (int j = 0; j < kRaysPerThread; ++j) cur[j] = masked_t(p0, q[j]);
#pragma unroll 2
      for (int r = 1; r < kWindow; ++r) {
        const float4* p = reinterpret_cast<const float4*>(ws + 12 * r);
#pragma unroll
        for (int j = 0; j < kRaysPerThread; ++j) {
          const float tm = masked_t(p, q[j]);
          if (tm < cur[j]) { cur[j] = tm; li[j] = r; }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j) {
    const size_t ray = ray0 + j;
    // cur stays INF where nothing ran: closer only if best t > INF, and
    // such a lane is live, so its warp ran
    const bool closer = cur[j] < q[j].bt;
    float t = cur[j], uu = 0.0f, vv = 0.0f;
    if (closer)
      sweep_test(reinterpret_cast<const float4*>(ws + 12 * li[j]), q[j], t,
                 uu, vv);
    out_t[ray] = closer ? cur[j] : q[j].bt;
    out_slot[ray] = closer ? start + li[j] : slot_in[ray];
    out_u[ray] = closer ? uu : u_in[ray];
    out_v[ray] = closer ? vv : v_in[ray];
  }
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
  leaf_sweep_kernel<<<n_blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      woop, n_rows, starts, o, d, t_min, bt_in, slot_in, u_in, v_in, out_t,
      out_slot, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
