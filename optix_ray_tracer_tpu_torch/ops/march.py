"""MarchIntersector (port of ``optix_ray_tracer_tpu/ops/march.py``).

Host-side duties around the hit-path kernels: coherence-sort a wave
(Morton keys for coherent waves, probe keys from kernel C for incoherent
ones), pad it to blocks, run kernel B, unsort, and merge the analytic
spheres; route common-point waves through the tile-raster engine
(kernel A) with an exact whole-wave fallback to the marcher.
Device refit/rebuild, the bundle engine and the short-first query wait
for later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops.bvh import morton_codes
from optix_ray_tracer_tpu_torch.ops.intersect import (
    DEFAULT_T_MIN, PRIM_NONE, PRIM_TRIANGLE, Hit, ray_bound,
)
from optix_ray_tracer_tpu_torch.ops.kernels.block_march import (
    block_march, probe_first_cluster,
)
from optix_ray_tracer_tpu_torch.ops.raster import (
    RasterSet, build_raster_set, raster_query,
)
from optix_ray_tracer_tpu_torch.ops.raysort import (
    ray_sort_keys, sphere_bruteforce_merge,
)
from optix_ray_tracer_tpu_torch.ops.sweep import ClusterSet, build_clusters
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot

#: scenes at or below this triangle count skip the coherence sort
SORT_FREE_TRIS = 2048

#: raster schedule granularity (windows of CHUNK / g triangles) for
#: nearest-hit and for occlusion waves (TPU-measured starting points)
DEFAULT_GRANULARITY = 4
DEFAULT_ANYHIT_GRANULARITY = 2


def ray_probe_keys(clusters, o, d, t_min, t_max):
    """(first-cluster id << 18) | direction Morton >> 12."""
    cid = probe_first_cluster(clusters, o, d, t_min, t_max).to(torch.int64)
    unit = torch.ones(3, device=d.device)
    d_m = morton_codes(d, -unit, unit)
    return (cid << 18) | (d_m >> 12)


def _hit_from_slots(clusters: ClusterSet, t, slot, u, v) -> Hit:
    missed = slot < 0
    prim_id = clusters.prim_index[torch.clamp(slot, min=0).long()]
    zero = torch.zeros_like(u)
    return Hit(
        t=torch.where(missed, torch.full_like(t, INF), t),
        prim_type=torch.where(missed, PRIM_NONE, PRIM_TRIANGLE
                              ).to(torch.int32),
        prim_id=torch.where(missed, torch.zeros_like(prim_id), prim_id
                            ).to(torch.int32),
        u=torch.where(missed, zero, u),
        v=torch.where(missed, zero, v))


@dataclasses.dataclass(frozen=True)
class MarchIntersector(TensorDataclass):
    clusters: ClusterSet
    scene_lo: torch.Tensor
    scene_hi: torch.Tensor
    # raster tables (None until attach_raster): enable intersect_from
    raster: RasterSet | None = None
    num_tris: int = 0
    # coherence-sort keys: "morton" (origin + direction Morton, camera-like
    # waves) or "probe" (nearest-cluster id from kernel C + direction
    # Morton, incoherent waves; see for_incoherent)
    sort_mode: str = "morton"

    def for_incoherent(self) -> "MarchIntersector":
        """Variant for incoherent (bounce >= 1 / shadow) waves."""
        return dataclasses.replace(self, sort_mode="probe")

    def intersect_from(self, scene: Scene, o, d, mode: str = "origin",
                       point=None, t_min=DEFAULT_T_MIN, t_max=INF,
                       any_hit: bool = False, block_rays: int = 1024,
                       pc_max: int | None = None,
                       granularity: int | None = None) -> Hit:
        """Common-point wave query through the tile-raster engine; rays in
        a screen-coherent layout (camera tile order).  Exact at any pair
        count: when the schedule overflows, the whole wave goes to the
        marcher.

        Occlusion waves in "target" mode are re-traced FROM the common
        point: the segment [o + t_min d, o + t_max d] through
        p = o + dist d is [p + (dist - t_max)(-d), p + (dist - t_min)(-d)],
        and a common origin shares the o-projections.  Only ``is_hit`` is
        meaningful for such a flipped wave."""
        if self.raster is None:
            raise ValueError("attach_raster(...) first: the raster tables "
                             "are built per scene")
        shape = o.shape[:-1]
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        n = o2.shape[0]
        t_min_a = ray_bound(t_min, n, o2.device)
        t_max_a = ray_bound(t_max, n, o2.device)
        if any_hit and mode == "target":
            p = torch.as_tensor(point, dtype=torch.float32, device=o2.device)
            dist = dot(p[None, :] - o2, d2)
            o2 = p.expand(o2.shape)
            d2 = -d2
            t_min_a, t_max_a = dist - t_max_a, dist - t_min_a
            mode = "origin"
        if granularity is None:
            granularity = (DEFAULT_ANYHIT_GRANULARITY if any_hit
                           else DEFAULT_GRANULARITY)
        t, slot, u, v, ok = raster_query(
            self.raster, self.clusters, o2, d2, t_min_a, t_max_a, mode=mode,
            point=point, any_hit=any_hit, block_rays=block_rays,
            pc_max=pc_max, granularity=granularity)
        if not ok:
            t, slot, u, v = block_march(self.clusters, o2, d2, t_min_a,
                                        t_max_a, any_hit=any_hit,
                                        coherent=True)
        hit = _hit_from_slots(self.clusters, t, slot, u, v)
        if scene.sphere_count > 0:
            hit = sphere_bruteforce_merge(scene, o2, d2, t_min_a, t_max_a,
                                          hit)
        return hit.reshape(shape)

    def any_hit_from(self, scene: Scene, o, d, mode: str = "target",
                     point=None, t_min=DEFAULT_T_MIN, t_max=INF,
                     block_rays: int = 1024, pc_max: int | None = None,
                     granularity: int | None = None):
        """Occlusion variant of :meth:`intersect_from`."""
        return self.intersect_from(scene, o, d, mode=mode, point=point,
                                   t_min=t_min, t_max=t_max, any_hit=True,
                                   block_rays=block_rays, pc_max=pc_max,
                                   granularity=granularity).is_hit

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF,
                  _any_hit: bool = False) -> Hit:
        shape = o.shape[:-1]
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        n = o2.shape[0]
        t_min_a = ray_bound(t_min, n, o2.device)
        t_max_a = ray_bound(t_max, n, o2.device)

        sort_free = self.num_tris <= SORT_FREE_TRIS
        if sort_free:
            o_s, d_s, tmin_s, tmax_s = o2, d2, t_min_a, t_max_a
        else:
            if self.sort_mode == "probe":
                key = ray_probe_keys(self.clusters, o2, d2, t_min_a, t_max_a)
            else:
                key = ray_sort_keys(o2, d2, self.scene_lo, self.scene_hi)
            perm = torch.argsort(key, stable=True)
            packed = torch.cat([o2, d2, t_min_a[:, None], t_max_a[:, None]],
                               1)[perm]
            o_s, d_s = packed[:, 0:3], packed[:, 3:6]
            tmin_s, tmax_s = packed[:, 6], packed[:, 7]

        t, slot, u, v = block_march(
            self.clusters, o_s, d_s, tmin_s, tmax_s, any_hit=_any_hit,
            coherent=sort_free or self.sort_mode != "probe")
        if not sort_free:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(n, device=perm.device)
            t, slot, u, v = t[inv], slot[inv], u[inv], v[inv]
        hit = _hit_from_slots(self.clusters, t, slot, u, v)
        if scene.sphere_count > 0:
            hit = sphere_bruteforce_merge(scene, o2, d2, t_min_a, t_max_a,
                                          hit)
        return hit.reshape(shape)

    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self.intersect(scene, o, d, t_min, t_max,
                              _any_hit=True).is_hit


def march_intersector_from_clusters(clusters: ClusterSet, scene: Scene,
                                    raster: bool = False
                                    ) -> MarchIntersector:
    """A MarchIntersector over an existing ClusterSet of ``scene``'s
    triangles (on the scene's device)."""
    tv = scene.triangles.vertices
    if tv.numel():
        lo, hi = tv.amin(dim=(0, 1)), tv.amax(dim=(0, 1))
    else:
        lo, hi = torch.zeros(3, device=tv.device), torch.ones(3,
                                                             device=tv.device)
    inter = MarchIntersector(clusters=clusters.to(tv.device), scene_lo=lo,
                             scene_hi=hi, num_tris=int(tv.shape[0]))
    return attach_raster(inter, scene) if raster else inter


def make_march_intersector(scene: Scene, method: str = "sah",
                           raster: bool = False) -> MarchIntersector:
    """Build the ClusterSet on the host and the intersector on the scene's
    device."""
    tv = scene.triangles.vertices
    clusters = build_clusters(tv.cpu().numpy(), method=method,
                              device=tv.device)
    return march_intersector_from_clusters(clusters, scene, raster=raster)


def attach_raster(inter: MarchIntersector,
                  scene: Scene) -> MarchIntersector:
    """Derive the tile-raster tables, enabling ``intersect_from`` /
    ``any_hit_from`` on common-point waves."""
    return dataclasses.replace(
        inter, raster=build_raster_set(inter.clusters,
                                       scene.triangles.vertices))
