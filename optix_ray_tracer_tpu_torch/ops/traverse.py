"""LBVH traversal and the brute-force intersector (port of
``optix_ray_tracer_tpu/ops/traverse.py``): the software stand-in for
OptiX's RT-core traversal (``optixTrace``, ``shader/Shader.cu:46-92``),
an oracle for small scenes that no integrator routes to.

Every ray carries a node stack; one step of the loop pops a node for
every ray that is still walking, tests the primitive of a leaf or the
two child boxes of an internal node, and pushes the hit children far
first, so the near one pops next (Aila and Laine's while-while loop, in
lockstep over the wave).  Each step runs on the rays still walking only.
Leaves dispatch by primitive id: spheres first, then triangles.  Plain
torch, on the device of the scene's tensors: no kernel of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops.bvh import LBVH, build_scene_lbvh
from optix_ray_tracer_tpu_torch.ops.intersect import (
    DEFAULT_T_MIN, PRIM_NONE, PRIM_SPHERE, PRIM_TRIANGLE, Hit,
    intersect_any_bruteforce, intersect_scene_bruteforce, ray_bound,
)
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, cross, dot

STACK_DEPTH = 64
#: rays per lockstep batch: bounds the (R, STACK_DEPTH) stacks
TRAVERSE_CHUNK = 1 << 18


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test of rays against boxes, all (..., 3) / (...,): (hit mask,
    entry t)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_enter = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min)
    t_exit = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max)
    return t_enter <= t_exit, t_enter


def _make_leaf_tester(scene: Scene):
    """test(pid, o, d, t_min, best) -> best updated by primitive ``pid``
    (a unified id per ray); best = (t, prim_type, prim_id, u, v)."""
    S = scene.sphere_count
    T = scene.triangle_count

    def test(pid, o, d, t_min, best):
        best_t, b_type, b_id, b_u, b_v = best
        inf = torch.full_like(best_t, INF)
        is_sphere = pid < S
        if S > 0:
            sid = torch.clamp(pid, 0, S - 1)
            oc = o - scene.spheres.centers[sid]
            radius = scene.spheres.radii[sid]
            half_b = dot(oc, d)
            c = dot(oc, oc) - radius * radius
            disc = half_b * half_b - c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t_near = -half_b - sq
            t_far = -half_b + sq
            t_s = torch.where((t_near > t_min) & (t_near < best_t), t_near,
                              torch.where((t_far > t_min) & (t_far < best_t),
                                          t_far, inf))
            t_s = torch.where((disc > 0.0) & is_sphere, t_s, inf)
        else:
            t_s = inf
        if T > 0:
            tri = scene.triangles.vertices[torch.clamp(pid - S, 0, T - 1)]
            v0 = tri[:, 0]
            e1 = tri[:, 1] - v0
            e2 = tri[:, 2] - v0
            pvec = cross(d, e2)
            det = dot(e1, pvec)
            ok_det = torch.abs(det) > 1e-9
            inv_det = torch.where(ok_det, 1.0 / det, 0.0)
            tvec = o - v0
            u = dot(tvec, pvec) * inv_det
            qvec = cross(tvec, e1)
            v = dot(d, qvec) * inv_det
            t_t = dot(e2, qvec) * inv_det
            ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t_t > t_min) & (t_t < best_t) & ~is_sphere)
            t_t = torch.where(ok, t_t, inf)
        else:
            t_t = inf
            u = v = torch.zeros_like(best_t)
        sphere_wins = t_s < best_t
        tri_wins = t_t < torch.minimum(t_s, best_t)
        zero = torch.zeros_like(best_t)
        return (torch.minimum(best_t, torch.minimum(t_s, t_t)),
                torch.where(tri_wins, PRIM_TRIANGLE,
                            torch.where(sphere_wins, PRIM_SPHERE, b_type)),
                torch.where(tri_wins, pid - S,
                            torch.where(sphere_wins, pid, b_id)),
                torch.where(tri_wins, u, torch.where(sphere_wins, zero, b_u)),
                torch.where(tri_wins, v, torch.where(sphere_wins, zero, b_v)))

    return test


def _traverse(bvh: LBVH, scene: Scene, o, d, t_min, t_max,
              any_hit: bool) -> Hit:
    """The stack walk of rays (R, 3) with (R,) bounds."""
    n = bvh.num_prims
    ni = n - 1
    R = o.shape[0]
    dev = o.device
    leaf_test = _make_leaf_tester(scene)
    inv_d = torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                        torch.sign(d) * 1e12 + torch.where(d == 0.0, 1e12,
                                                           0.0))
    left, right = bvh.left.long(), bvh.right.long()
    prim_index = bvh.prim_index.long()

    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)   # the root, node 0
    best = [t_max.clone(), torch.full((R,), PRIM_NONE, dtype=torch.int64,
                                      device=dev),
            torch.zeros(R, dtype=torch.int64, device=dev),
            torch.zeros(R, device=dev), torch.zeros(R, device=dev)]
    while True:
        walking = sp > 0
        if any_hit:
            walking &= best[1] == PRIM_NONE
        a = walking.nonzero()[:, 0]
        if a.numel() == 0:
            break
        oa, da, inv_a, lo = o[a], d[a], inv_d[a], t_min[a]
        sp_a = sp[a] - 1
        node = stack[a, sp_a]
        cur = [b[a] for b in best]

        is_leaf = node >= ni
        pid = prim_index[torch.clamp(node - ni, 0, n - 1)]
        new = leaf_test(pid, oa, da, lo, cur)
        cur = [torch.where(is_leaf, x, y) for x, y in zip(new, cur)]

        node_c = torch.clamp(node, max=max(ni - 1, 0))
        lc, rc = left[node_c], right[node_c]
        lhit, lt = ray_aabb(oa, inv_a, bvh.node_min[lc], bvh.node_max[lc],
                            lo, cur[0])
        rhit, rt = ray_aabb(oa, inv_a, bvh.node_min[rc], bvh.node_max[rc],
                            lo, cur[0])
        # push the far child first, so the near one pops next
        near_left = lt <= rt
        far = torch.where(near_left, rc, lc)
        near = torch.where(near_left, lc, rc)
        for child, hit in ((far, torch.where(near_left, rhit, lhit)),
                           (near, torch.where(near_left, lhit, rhit))):
            push = ~is_leaf & hit & (sp_a < STACK_DEPTH)
            rows = a[push]
            stack[rows, sp_a[push]] = child[push]
            sp_a = sp_a + push.long()
        sp[a] = sp_a
        for b, x in zip(best, cur):
            b[a] = x
    t, ptype, pid, u, v = best
    return Hit(t=torch.where(ptype == PRIM_NONE, INF, t),
               prim_type=ptype.to(torch.int32), prim_id=pid.to(torch.int32),
               u=u, v=v)


def _traverse_batch(bvh: LBVH, scene: Scene, o, d, t_min, t_max,
                    any_hit: bool = False) -> Hit:
    n = o.shape[0]
    lo = ray_bound(t_min, n, o.device)
    hi = ray_bound(t_max, n, o.device)
    parts = [_traverse(bvh, scene, o[s:s + TRAVERSE_CHUNK],
                       d[s:s + TRAVERSE_CHUNK], lo[s:s + TRAVERSE_CHUNK],
                       hi[s:s + TRAVERSE_CHUNK], any_hit)
             for s in range(0, n, TRAVERSE_CHUNK)]
    if len(parts) == 1:
        return parts[0]
    return Hit(*(torch.cat([getattr(p, f.name) for p in parts])
                 for f in dataclasses.fields(Hit)))


@dataclasses.dataclass(frozen=True)
class BVHIntersector(TensorDataclass):
    """The LBVH as an intersector; ``bvh=None`` (scenes of fewer than two
    primitives) falls back to brute force."""
    bvh: LBVH | None

    def _walk(self, scene, o, d, t_min, t_max, any_hit: bool) -> Hit:
        shape = o.shape[:-1]
        hit = _traverse_batch(self.bvh, scene, o.reshape(-1, 3),
                              d.reshape(-1, 3), t_min, t_max, any_hit)
        return hit.reshape(shape)

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                  t_max=INF) -> Hit:
        if self.bvh is None:
            return intersect_scene_bruteforce(scene, o, d, t_min, t_max)
        return self._walk(scene, o, d, t_min, t_max, False)

    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        if self.bvh is None:
            return intersect_any_bruteforce(scene, o, d, t_min, t_max)
        return self._walk(scene, o, d, t_min, t_max, True).is_hit


class BruteForceIntersector:
    """The brute-force oracle as an intersector."""

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                  t_max=INF) -> Hit:
        return intersect_scene_bruteforce(scene, o, d, t_min, t_max)

    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return intersect_any_bruteforce(scene, o, d, t_min, t_max)


def make_intersector(scene: Scene, use_bvh: bool = True):
    """The LBVH intersector of a scene (the reference's GAS build at
    commit, ``RendererMesh.cu:169-253``), built on its device; brute force
    without ``use_bvh``, and ``BVHIntersector(None)`` under two
    primitives."""
    total = scene.sphere_count + scene.triangle_count
    if total < 2:
        return BVHIntersector(bvh=None)
    if not use_bvh:
        return BruteForceIntersector()
    return BVHIntersector(bvh=build_scene_lbvh(scene))
