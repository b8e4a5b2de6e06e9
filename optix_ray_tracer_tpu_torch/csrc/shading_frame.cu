// The hit shading frame: kernel R, the work of ops/intersect.shading_frame
// (hit point, two-sided shading normal, front flag and material id) for
// one wave of hits, which every integrator runs after every query.
//
// No TPU kernel is replaced: the JAX package's shading_frame
// (optix_ray_tracer_tpu/ops/intersect.py:222) is plain jnp that XLA fuses
// into the bounce step.  The plain version (intersect.shading_frame_plain)
// takes some twenty eager launches a wave, among them an (R, 3, 3) normal
// gather and the material-id gathers of both primitive tables, and builds
// both the sphere and the triangle frame of every ray before it selects
// one.  Here one thread takes one ray: the point, then only the frame its
// primitive type selects (a triangle's interpolated vertex normals, or
// (p - c) / r of the sphere, which misses take too, as the plain version's
// select gives them), the flip against d and the outputs.  A frame the
// select discards cannot change a selected value, so skipping it keeps
// every output bit-equal.
//
// Exactness: every float step is the plain version's in its order (the
// point as o + t d, w = (1 - u) - v, (w n1 + u n2) + v n3, a true IEEE
// divide by max(r, 1e-30), dot products left to right), ids clamped to
// [0, max(count - 1, 0)] as the plain version clamps them, and the library
// is built with -fmad=false.
//
// What bounds it on the H100: bytes.  A ray reads o, d, t and its
// primitive type (32 B), a hit its id, u, v and its primitive's normal
// rows and material (up to 52 B), and writes the point, the normal, the
// front flag and the material id (29 B); its arithmetic is some thirty
// float operations.
#include <cuda_runtime.h>
#include <math.h>

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrimTriangle = 2;   // ops/intersect.PRIM_TRIANGLE

using namespace ort;

__device__ __forceinline__ int clamp_id(int id, int count) {
  const int hi = count - 1 > 0 ? count - 1 : 0;
  return id < 0 ? 0 : (id > hi ? hi : id);
}

__global__ void __launch_bounds__(kThreads) shading_frame_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t, const int* __restrict__ prim_type,
    const int* __restrict__ prim_id, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ centers,
    const float* __restrict__ radii, const int* __restrict__ sphere_mat,
    int n_spheres, const float* __restrict__ normals,
    const int* __restrict__ tri_mat, int n_tris, long long n,
    float* __restrict__ point, float* __restrict__ normal,
    bool* __restrict__ front_face, int* __restrict__ material_id) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const V3 ov = load3(o, i), dv = load3(d, i);
    const float tt = __ldg(t + i);
    const V3 p = {ov.x + tt * dv.x, ov.y + tt * dv.y, ov.z + tt * dv.z};
    V3 nn = {0.0f, 0.0f, 0.0f};
    int m = 0;
    if (__ldg(prim_type + i) == kPrimTriangle) {
      if (n_tris > 0) {
        const int id = clamp_id(__ldg(prim_id + i), n_tris);
        const V3 n1 = load3(normals, 3LL * id),
                 n2 = load3(normals, 3LL * id + 1),
                 n3 = load3(normals, 3LL * id + 2);
        const float uu = __ldg(u + i), vv = __ldg(v + i);
        const float w = (1.0f - uu) - vv;
        nn = {(w * n1.x + uu * n2.x) + vv * n3.x,
              (w * n1.y + uu * n2.y) + vv * n3.y,
              (w * n1.z + uu * n2.z) + vv * n3.z};
        m = __ldg(tri_mat + id);
      }
    } else if (n_spheres > 0) {
      const int id = clamp_id(__ldg(prim_id + i), n_spheres);
      const V3 c = load3(centers, id);
      const float r = clamp_min(__ldg(radii + id), 1e-30f);
      nn = {(p.x - c.x) / r, (p.y - c.y) / r, (p.z - c.z) / r};
      m = __ldg(sphere_mat + id);
    }
    const bool ff = dot3(dv, nn) < 0.0f;
    if (!ff) nn = {-nn.x, -nn.y, -nn.z};
    store3(point, i, p);
    store3(normal, i, nn);
    front_face[i] = ff;
    material_id[i] = m;
  }
}

}  // namespace

// R.  o, d (n, 3) float32; the hits' t, prim_type, prim_id, u, v (n,);
// the sphere table's centers (S, 3), radii (S,), material ids (S,) int32;
// the triangle table's normals (T, 3, 3) and material ids (T,) int32
// (pointers unread where the count is 0).  Writes point, normal (n, 3),
// front_face (n,) bool, material_id (n,) int32.
extern "C" int ort_shading_frame(
    const float* o, const float* d, const float* t, const int* prim_type,
    const int* prim_id, const float* u, const float* v,
    const float* centers, const float* radii, const int* sphere_mat,
    int n_spheres, const float* normals, const int* tri_mat, int n_tris,
    long long n, float* point, float* normal, bool* front_face,
    int* material_id, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1LL << 20) ? blocks
                                                         : (1LL << 20));
  shading_frame_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      o, d, t, prim_type, prim_id, u, v, centers, radii, sphere_mat,
      n_spheres, normals, tri_mat, n_tris, n, point, normal, front_face,
      material_id);
  return static_cast<int>(cudaGetLastError());
}
