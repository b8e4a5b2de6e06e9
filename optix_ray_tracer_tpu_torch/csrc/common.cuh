// Shared device helpers of the hit-path kernels (block_march.cu,
// tile_raster.cu).
//
// Every arithmetic step here mirrors the plain PyTorch versions in
// ops/kernels/*.py operation for operation, and the library is built with
// -fmad=false, so a kernel and its plain version round identically:
// chip_smoke.py compares them with no exceptions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define ORT_INF 1e16f        // the miss sentinel (utils/vecmath.INF), not inf
#define ORT_CHUNK 256        // triangles per cluster (ops/sweep.CHUNK)
#define ORT_WOOP_ROWS 16     // woop_t rows per cluster (12 used)

// 1/d where |d| > 1e-12, else +1e12 whatever the sign of d.
__device__ __forceinline__ float ort_inv_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// Slab entry of one box [min xyz, max xyz] (stride given by the caller's
// row layout), or ORT_INF when the ray misses it within [tmin, box exit].
// Padding boxes are NaN: the flag below keeps them from ever firing, which
// is what NaN-propagating min/max give on the JAX side (fminf/fmaxf would
// drop the NaN and let the box hit).  CHECK_NAN = false drops the flag for
// callers that know no NaN can arise: a box without NaN and a ray with a
// finite origin and direction (then 1/d is finite and nonzero, and every
// product is finite or infinite, never NaN).
template <bool CHECK_NAN = true>
__device__ __forceinline__ float ort_slab_entry6(
    float lx, float ly, float lz, float hx, float hy, float hz, float ox,
    float oy, float oz, float ix, float iy, float iz, float tmin) {
  float ent = -ORT_INF, ext = ORT_INF;
  bool nan = false;
  float t0 = (lx - ox) * ix, t1 = (hx - ox) * ix;
  if (CHECK_NAN) nan |= isnan(t0) | isnan(t1);
  ent = fmaxf(ent, fminf(t0, t1));
  ext = fminf(ext, fmaxf(t0, t1));
  t0 = (ly - oy) * iy; t1 = (hy - oy) * iy;
  if (CHECK_NAN) nan |= isnan(t0) | isnan(t1);
  ent = fmaxf(ent, fminf(t0, t1));
  ext = fminf(ext, fmaxf(t0, t1));
  t0 = (lz - oz) * iz; t1 = (hz - oz) * iz;
  if (CHECK_NAN) nan |= isnan(t0) | isnan(t1);
  ent = fmaxf(ent, fminf(t0, t1));
  ext = fminf(ext, fmaxf(t0, t1));
  ent = fmaxf(ent, tmin);
  return (!nan && ent <= ext) ? ent : ORT_INF;
}

__device__ __forceinline__ float ort_slab_entry(
    const float* box, float ox, float oy, float oz,
    float ix, float iy, float iz, float tmin) {
  return ort_slab_entry6(box[0], box[1], box[2], box[3], box[4], box[5],
                         ox, oy, oz, ix, iy, iz, tmin);
}

// The same for a 16-byte aligned [min3, max3, pad2] row, in two 16-byte
// loads (every lane of a warp reads the same row: one broadcast each).
template <bool CHECK_NAN = true>
__device__ __forceinline__ float ort_row_entry(
    const float* __restrict__ row, float ox, float oy, float oz, float ix,
    float iy, float iz, float tmin) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  return ort_slab_entry6<CHECK_NAN>(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy, oz,
                                    ix, iy, iz, tmin);
}

// World ray -> instance space for the TLAS kernels: o' = A (o - b),
// d' = A d with the affine row m = [A (3x3 row-major), b].  A = R^T / s
// for a rigid + uniform-scale pose, so d' is left unnormalised and t is
// the same parameter in both spaces.  Sums run left to right, as
// ops/kernels/block_march.instance_points / instance_dirs compute them.
__device__ __forceinline__ void ort_to_instance(
    const float* __restrict__ m, float ox, float oy, float oz, float dx,
    float dy, float dz, float& tox, float& toy, float& toz, float& tdx,
    float& tdy, float& tdz) {
  const float wx = ox - m[9], wy = oy - m[10], wz = oz - m[11];
  tox = (m[0] * wx + m[1] * wy) + m[2] * wz;
  toy = (m[3] * wx + m[4] * wy) + m[5] * wz;
  toz = (m[6] * wx + m[7] * wy) + m[8] * wz;
  tdx = (m[0] * dx + m[1] * dy) + m[2] * dz;
  tdy = (m[3] * dx + m[4] * dy) + m[5] * dz;
  tdz = (m[6] * dx + m[7] * dy) + m[8] * dz;
}

// Order-preserving map of a non-NaN float onto uint32.
__device__ __forceinline__ unsigned ort_ordered(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ort_unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
