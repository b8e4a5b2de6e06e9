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
#define ORT_SLICE 32         // Woop rows a warp stages at a time

// One row's o-projection of a point: ((w0 ox + w1 oy) + w2 oz) - w3.
__device__ __forceinline__ float ort_woop_proj(float w0, float w1, float w2,
                                               float w3, float ox, float oy,
                                               float oz) {
  return ((w0 * ox + w1 * oy) + w2 * oz) - w3;
}

// Which side of the Woop dots a tile-raster wave shares across a tile
// (tile_raster.cu): none, the origin (camera and flipped shadow waves) or
// the direction (ortho waves).
#define ORT_COMMON_NONE 0
#define ORT_COMMON_ORIGIN 1
#define ORT_COMMON_DIR 2

// One Woop test of a row against a ray, given the row's o-projections and
// d-projections of the ray: a hit in (tmin, bt) takes slot = id and, with
// UV, its barycentrics; any-hit pins bt to -ORT_INF.
template <bool ANY_HIT, bool UV>
__device__ __forceinline__ void ort_woop_accept(
    float opx, float opy, float opz, float dpx, float dpy, float dpz, int id,
    float tmin, float& bt, int& slot, float& u, float& v) {
  const bool dz_ok = fabsf(dpz) > 1e-12f;
  const float t = (-opz) / (dz_ok ? dpz : 1e-12f);
  const float uu = opx + t * dpx;
  const float vv = opy + t * dpy;
  if (dz_ok && uu >= 0.0f && vv >= 0.0f && (uu + vv) <= 1.0f && t > tmin &&
      t < bt) {
    slot = id;
    bt = ANY_HIT ? -ORT_INF : t;
    if (UV && !ANY_HIT) { u = uu; v = vv; }
  }
}

// One row's d-projection of a direction: (w0 dx + w1 dy) + w2 dz.
__device__ __forceinline__ float ort_woop_dir(float w0, float w1, float w2,
                                              float dx, float dy, float dz) {
  return (w0 * dx + w1 * dy) + w2 * dz;
}

// ort_woop_accept with the d-projections computed from the direction rows
// (w0..w2, w4..w6, w8..w10) and the ray's direction.
template <bool ANY_HIT, bool UV>
__device__ __forceinline__ void ort_woop_hit(
    float opx, float opy, float opz, float w0, float w1, float w2, float w4,
    float w5, float w6, float w8, float w9, float w10, int id, float dx,
    float dy, float dz, float tmin, float& bt, int& slot, float& u,
    float& v) {
  ort_woop_accept<ANY_HIT, UV>(opx, opy, opz, ort_woop_dir(w0, w1, w2, dx, dy, dz),
                               ort_woop_dir(w4, w5, w6, dx, dy, dz),
                               ort_woop_dir(w8, w9, w10, dx, dy, dz), id, tmin,
                               bt, slot, u, v);
}

// Row r's 12 Woop values of a cluster's rows w (value k at w[k * ORT_CHUNK]).
__device__ __forceinline__ void ort_load_row(float (&q)[12],
                                             const float* __restrict__ w,
                                             int r) {
#pragma unroll
  for (int k = 0; k < 12; ++k) q[k] = __ldg(w + k * ORT_CHUNK + r);
}

// Floats a warp stages per Woop row in ort_warp_rows: the 12 values, and
// with a common direction the row's three d-projections of it.
template <int COMMON>
__host__ __device__ constexpr int ort_stage_row() {
  return COMMON == ORT_COMMON_DIR ? 16 : 12;
}

// Woop-test rows [r0, r0 + n) of a cluster's rows w (n a multiple of
// ORT_SLICE) against every lane's ray, slice by slice, with no barrier
// beyond the warp: lane j loads row j of a slice with 12 coalesced loads
// and stores it to the warp's own ort_stage_row<COMMON>() x ORT_SLICE
// floats of shared memory (stage, 16-byte aligned); every lane then reads
// each row back as 16-byte broadcasts.  The next slice's loads are in
// flight while the current slice is tested.  With ORT_COMMON_ORIGIN the
// origin (ox, oy, oz) is the same on every lane (a tile's shared origin):
// the loading lane computes its row's three o-projections once and stages
// them in place of w3, w7 and w11.  With ORT_COMMON_DIR the direction
// (dx, dy, dz) is the same on every lane (an ortho wave's): the loading
// lane stages its row's three d-projections as a fourth float4.
// slot = slot_base + row; u, v are tracked with UV.
template <bool ANY_HIT, int COMMON, bool UV>
__device__ __forceinline__ void ort_warp_rows(
    float* stage, int lane, const float* __restrict__ w, int r0, int n,
    int slot_base, float ox, float oy, float oz, float dx, float dy,
    float dz, float tmin, float& bt, int& slot, float& u, float& v) {
  constexpr int kRow = ort_stage_row<COMMON>();
  float q[12];
  ort_load_row(q, w, r0 + lane);
  for (int s = r0; s < r0 + n; s += ORT_SLICE) {
    float4 dp = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (COMMON == ORT_COMMON_ORIGIN) {
      q[3] = ort_woop_proj(q[0], q[1], q[2], q[3], ox, oy, oz);
      q[7] = ort_woop_proj(q[4], q[5], q[6], q[7], ox, oy, oz);
      q[11] = ort_woop_proj(q[8], q[9], q[10], q[11], ox, oy, oz);
    } else if (COMMON == ORT_COMMON_DIR) {
      dp = make_float4(ort_woop_dir(q[0], q[1], q[2], dx, dy, dz),
                       ort_woop_dir(q[4], q[5], q[6], dx, dy, dz),
                       ort_woop_dir(q[8], q[9], q[10], dx, dy, dz), 0.0f);
    }
    __syncwarp();   // every lane is done with the previous slice
    float4* dst = reinterpret_cast<float4*>(stage + kRow * lane);
    dst[0] = make_float4(q[0], q[1], q[2], q[3]);
    dst[1] = make_float4(q[4], q[5], q[6], q[7]);
    dst[2] = make_float4(q[8], q[9], q[10], q[11]);
    if (COMMON == ORT_COMMON_DIR) dst[3] = dp;
    __syncwarp();
    if (s + ORT_SLICE < r0 + n) ort_load_row(q, w, s + ORT_SLICE + lane);
#pragma unroll 4
    for (int j = 0; j < ORT_SLICE; ++j) {
      const float4* p = reinterpret_cast<const float4*>(stage + kRow * j);
      const float4 a = p[0], b = p[1], c = p[2];
      if (COMMON == ORT_COMMON_DIR) {
        const float4 e = p[3];
        ort_woop_accept<ANY_HIT, UV>(
            ort_woop_proj(a.x, a.y, a.z, a.w, ox, oy, oz),
            ort_woop_proj(b.x, b.y, b.z, b.w, ox, oy, oz),
            ort_woop_proj(c.x, c.y, c.z, c.w, ox, oy, oz), e.x, e.y, e.z,
            slot_base + s + j, tmin, bt, slot, u, v);
        continue;
      }
      const bool co = COMMON == ORT_COMMON_ORIGIN;
      const float opx = co ? a.w : ort_woop_proj(a.x, a.y, a.z, a.w, ox, oy, oz);
      const float opy = co ? b.w : ort_woop_proj(b.x, b.y, b.z, b.w, ox, oy, oz);
      const float opz = co ? c.w : ort_woop_proj(c.x, c.y, c.z, c.w, ox, oy, oz);
      ort_woop_hit<ANY_HIT, UV>(opx, opy, opz, a.x, a.y, a.z, b.x, b.y, b.z,
                                c.x, c.y, c.z, slot_base + s + j, dx, dy, dz,
                                tmin, bt, slot, u, v);
    }
  }
}

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

// The slab entry of a 16-byte aligned [min3, max3, pad2] row, in two
// 16-byte loads (every lane of a warp reads the same row: one broadcast
// each).
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

// cp.async: a copy from device to shared memory through no register,
// completed by ort_copy_wait
__device__ __forceinline__ void ort_copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ort_copy4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ort_copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the thread's copies issued since the last commit into a group;
// ort_copy_wait_group<N> waits until at most N groups are in flight.
__device__ __forceinline__ void ort_copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ort_copy_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order-preserving map of a non-NaN float onto uint32.
__device__ __forceinline__ unsigned ort_ordered(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ort_unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
