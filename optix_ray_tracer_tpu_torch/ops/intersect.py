"""Batched ray-primitive intersection and the brute-force oracle (port of
``optix_ray_tracer_tpu/ops/intersect.py``).

``intersect_scene_bruteforce`` streams every primitive past every ray in
chunks and keeps the running nearest hit: the oracle that the accelerated
paths (and both bench guards) are checked against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass, tree_map
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, cross, dot

PRIM_NONE = 0
PRIM_SPHERE = 1
PRIM_TRIANGLE = 2

#: default ray epsilon (see the JAX module for why it exceeds the
#: reference's 1e-6)
DEFAULT_T_MIN = 1e-3


@dataclasses.dataclass(frozen=True)
class Hit(TensorDataclass):
    """Nearest-hit record for a ray batch (all (R,))."""
    t: torch.Tensor          # hit distance, INF if miss
    prim_type: torch.Tensor  # int32 PRIM_*
    prim_id: torch.Tensor    # int32 index within its primitive array
    u: torch.Tensor          # triangle barycentric u (sphere: 0)
    v: torch.Tensor          # triangle barycentric v (sphere: 0)

    @property
    def is_hit(self):
        return self.prim_type != PRIM_NONE

    @staticmethod
    def none(batch_shape, device) -> "Hit":
        z = torch.zeros(batch_shape, device=device)
        zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
        return Hit(t=torch.full(batch_shape, INF, device=device),
                   prim_type=zi, prim_id=zi, u=z, v=z)

    def reshape(self, shape) -> "Hit":
        return tree_map(lambda x: x.reshape(tuple(shape) + x.shape[1:]), self)


def ray_bound(t, n: int, device) -> torch.Tensor:
    """A scalar or (n,)-shaped ray bound as an (n,) float32 tensor.  A
    host number, rounded to float32, becomes a fill on ``device``: a copy
    of host memory to a CUDA device would wait for the work queued before
    it."""
    if isinstance(t, torch.Tensor) or np.ndim(t):
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
    else:
        t = torch.full((), float(np.float32(t)), dtype=torch.float32,
                       device=device)
    return t.reshape(-1).expand(n) if t.dim() else t.expand(n)


def ray_sphere_block(o, d, centers, radii, t_min, t_max):
    """All-pairs ray/sphere test: (R, C) t, INF where no hit in
    (t_min, t_max).  Bounds are (R,) tensors."""
    t_min = t_min[:, None]
    t_max = t_max[:, None]
    oc = o[:, None, :] - centers[None, :, :]
    a = dot(d, d)[:, None]
    half_b = dot(oc, d[:, None, :])
    c = dot(oc, oc) - (radii * radii)[None, :]
    disc = half_b * half_b - a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_disc) * inv_a
    t_far = (-half_b + sqrt_disc) * inv_a
    near_ok = (t_near > t_min) & (t_near < t_max)
    far_ok = (t_far > t_min) & (t_far < t_max)
    inf = torch.full_like(t_near, INF)
    t = torch.where(near_ok, t_near, torch.where(far_ok, t_far, inf))
    return torch.where(disc > 0.0, t, inf)


def ray_triangle_block(o, d, v0, e1, e2, t_min, t_max, eps: float = 1e-9):
    """All-pairs Moller-Trumbore, backface culling off.  Returns (t, u, v)
    of shape (R, C); t is INF where there is no hit."""
    t_min = t_min[:, None]
    t_max = t_max[:, None]
    pvec = cross(d[:, None, :].expand(-1, e2.shape[0], -1),
                 e2[None, :, :].expand(d.shape[0], -1, -1))
    det = dot(e1[None, :, :], pvec)
    ok_det = torch.abs(det) > eps
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tvec = o[:, None, :] - v0[None, :, :]
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1[None, :, :].expand_as(tvec))
    v = dot(d[:, None, :], qvec) * inv_det
    t = dot(e2[None, :, :], qvec) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max))
    return torch.where(ok, t, torch.full_like(t, INF)), u, v


def _merge(hit: Hit, t, ptype: int, pid, u, v) -> Hit:
    closer = t < hit.t
    return Hit(
        t=torch.where(closer, t, hit.t),
        prim_type=torch.where(closer, torch.full_like(hit.prim_type, ptype),
                              hit.prim_type),
        prim_id=torch.where(closer, pid.to(torch.int32), hit.prim_id),
        u=torch.where(closer, u, hit.u),
        v=torch.where(closer, v, hit.v))


def intersect_scene_bruteforce(scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                               t_max=INF, chunk: int = 512) -> Hit:
    """Nearest hit by streaming all primitives past all rays, ``chunk``
    primitives at a time (a Python loop where the JAX side scans)."""
    shape = o.shape[:-1]
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    n = o2.shape[0]
    dev = o2.device
    tmin = ray_bound(t_min, n, dev)
    tmax = ray_bound(t_max, n, dev)
    hit = Hit.none((n,), dev)
    # bound the (R, chunk, 3) temporaries whatever the wave size
    chunk = min(chunk, max(32, (1 << 24) // max(n, 1)))

    sph = scene.spheres
    for base in range(0, scene.sphere_count, chunk):
        t = ray_sphere_block(o2, d2, sph.centers[base:base + chunk],
                             sph.radii[base:base + chunk], tmin, tmax)
        bi = torch.argmin(t, dim=-1)
        bt = torch.gather(t, 1, bi[:, None])[:, 0]
        hit = _merge(hit, bt, PRIM_SPHERE, base + bi, torch.zeros_like(bt),
                     torch.zeros_like(bt))

    verts = scene.triangles.vertices
    for base in range(0, scene.triangle_count, chunk):
        blk = verts[base:base + chunk]
        v0 = blk[:, 0]
        e1 = blk[:, 1] - blk[:, 0]
        e2 = blk[:, 2] - blk[:, 0]
        t, u, v = ray_triangle_block(o2, d2, v0, e1, e2, tmin, tmax)
        bi = torch.argmin(t, dim=-1)
        g = bi[:, None]
        hit = _merge(hit, torch.gather(t, 1, g)[:, 0], PRIM_TRIANGLE,
                     base + bi, torch.gather(u, 1, g)[:, 0],
                     torch.gather(v, 1, g)[:, 0])
    return hit.reshape(shape)


def intersect_any_bruteforce(scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                             t_max=INF, chunk: int = 512):
    """Occlusion query: True where something blocks (t_min, t_max)."""
    return intersect_scene_bruteforce(scene, o, d, t_min, t_max,
                                      chunk=chunk).is_hit


def __getattr__(name):
    """``BruteForceIntersector`` lives in ``ops/traverse.py`` beside the
    LBVH, as in the JAX package; this module re-exports it lazily (the
    traversal module imports this one)."""
    if name == "BruteForceIntersector":
        from optix_ray_tracer_tpu_torch.ops.traverse import (
            BruteForceIntersector,
        )
        return BruteForceIntersector
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def shading_frame_fn(intersector):
    """The intersector's own ``shading_frame`` if it defines one, else the
    scene-table path below."""
    fn = getattr(intersector, "shading_frame", None)
    return fn if fn is not None else shading_frame


def shading_frame(scene: Scene, o, d, hit: Hit):
    """Hit point and two-sided shading normal for a batch of hits: spheres
    use (p - c) / r, triangles interpolate vertex normals w*n1 + u*n2 +
    v*n3.  Returns (point, normal (un-normalized), front_face,
    material_id).  CUDA tensors launch kernel R
    (``ops/kernels/march_glue.shading_frame_call``); others take
    :func:`shading_frame_plain`, which computes the same bits."""
    if o.is_cuda:
        # imported here: the kernels' module imports this one
        from optix_ray_tracer_tpu_torch.ops.kernels import march_glue
        return march_glue.shading_frame_call(scene, o, d, hit)
    return shading_frame_plain(scene, o, d, hit)


def shading_frame_plain(scene: Scene, o, d, hit: Hit):
    """Plain version of :func:`shading_frame` on any device (kernel R's
    twin): both frames for every ray, then a select."""
    point = o + hit.t[..., None] * d
    sph_id = torch.clamp(hit.prim_id, 0, max(scene.sphere_count - 1, 0)
                         ).long()
    tri_id = torch.clamp(hit.prim_id, 0, max(scene.triangle_count - 1, 0)
                         ).long()
    if scene.sphere_count > 0:
        centers = scene.spheres.centers[sph_id]
        radii = scene.spheres.radii[sph_id]
        n_sphere = (point - centers) / torch.clamp(radii, min=1e-30)[..., None]
        m_sphere = scene.spheres.material_id[sph_id]
    else:
        n_sphere = torch.zeros_like(point)
        m_sphere = torch.zeros(hit.t.shape, dtype=torch.int32,
                               device=point.device)
    if scene.triangle_count > 0:
        n123 = scene.triangles.normals[tri_id]
        w = (1.0 - hit.u - hit.v)[..., None]
        n_tri = (w * n123[..., 0, :] + hit.u[..., None] * n123[..., 1, :]
                 + hit.v[..., None] * n123[..., 2, :])
        m_tri = scene.triangles.material_id[tri_id]
    else:
        n_tri = torch.zeros_like(point)
        m_tri = torch.zeros(hit.t.shape, dtype=torch.int32,
                            device=point.device)
    is_tri = hit.prim_type == PRIM_TRIANGLE
    normal = torch.where(is_tri[..., None], n_tri, n_sphere)
    material_id = torch.where(is_tri, m_tri, m_sphere)
    front_face = dot(d, normal) < 0.0
    normal = torch.where(front_face[..., None], normal, -normal)
    return point, normal, front_face, material_id


def interpolate_uv(scene: Scene, hit: Hit):
    """Barycentric-interpolated texture coordinates at triangle hits:
    (R, 2), zeros for sphere hits, misses and scenes without uvs."""
    tris = scene.triangles
    if tris.uvs is None or scene.triangle_count == 0:
        return torch.zeros(hit.t.shape + (2,), device=hit.t.device)
    tri_id = torch.clamp(hit.prim_id, 0, scene.triangle_count - 1).long()
    uv3 = tris.uvs[tri_id]                                   # (R, 3, 2)
    w = (1.0 - hit.u - hit.v)[..., None]
    uv = (w * uv3[..., 0, :] + hit.u[..., None] * uv3[..., 1, :]
          + hit.v[..., None] * uv3[..., 2, :])
    return torch.where((hit.prim_type == PRIM_TRIANGLE)[..., None], uv, 0.0)


def hit_mismatches(prim_a, t_a, prim_b, t_b) -> int:
    """Rays on which two hit records disagree under the bench rule: the
    prim ids differ AND the distances differ by more than
    1e-5 |t_b| + 1e-6 (at an fp-equal t either triangle is the nearest)."""
    prim_ok = prim_a == prim_b
    tie_ok = torch.abs(t_a - t_b) <= 1e-5 * torch.abs(t_b) + 1e-6
    return int((~(prim_ok | tie_ok)).sum())
