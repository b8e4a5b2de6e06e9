"""MarchIntersector (port of ``optix_ray_tracer_tpu/ops/march.py``).

Host-side duties around the hit-path kernels: coherence-sort a wave
(Morton keys for coherent waves, probe keys from kernel C for incoherent
ones; kernel O), pack and pad it to blocks (kernel P), run kernel B or F,
unsort it into a Hit (kernel Q), and merge the analytic spheres; route
common-point and common-direction waves through the tile-raster engine
(kernel A) and secondary waves in a tile layout
through the bundle engine (3-D binning, kernel A), each with an exact
whole-wave fallback to the marcher; refit or rebuild the intersector for
new vertex positions on the device.  Spans (``utils/profiling.span``):
``route.raster`` around each raster or bundle schedule wave,
``route.overflow`` around the marcher's re-trace of a wave whose schedule
overflowed, ``march.deep`` around each marcher wave past
``block_march.MAX_CLUSTERS`` (its probe, sort and march on the deep kernels
C2 and F2).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops.intersect import (
    DEFAULT_T_MIN, Hit, ray_bound,
)
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from optix_ray_tracer_tpu_torch.ops.kernels import march_glue
from optix_ray_tracer_tpu_torch.ops.raster import (
    RasterSet, build_raster_set, bundle_query, raster_query,
)
from optix_ray_tracer_tpu_torch.ops.raysort import (
    probe_sort_keys, sphere_bruteforce_merge,
)
from optix_ray_tracer_tpu_torch.ops.sweep import (
    ClusterSet, build_clusters, rebuild_clusters, refit_clusters,
)
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.utils import profiling
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot

#: scenes at or below this triangle count skip the coherence sort
SORT_FREE_TRIS = 2048

#: raster schedule granularity (windows of CHUNK / g triangles) for
#: nearest-hit and for occlusion waves (TPU-measured starting points)
DEFAULT_GRANULARITY = 4
DEFAULT_ANYHIT_GRANULARITY = 2


def ray_probe_keys(clusters, o, d, t_min, t_max):
    """(first-cluster id << 18) | direction Morton >> 12, the id shifted
    right by ``block_march.probe_key_shift`` past 16,383 clusters."""
    cid = bm.probe_first_cluster(clusters, o, d, t_min, t_max)
    shift = bm.probe_key_shift(-(-clusters.num_clusters // 8) * 8)
    return probe_sort_keys(cid >> shift if shift else cid, d)


def _hit_from_slots(clusters: ClusterSet, t, slot, u, v) -> Hit:
    """The Hit of a query's (t, slot, u, v) in the caller's order (kernel
    Q on the card)."""
    return Hit(*march_glue.finish_hits(t, slot, clusters.prim_index,
                                       slot.shape[0], u=u, v=v))


def _deep_span(clusters: ClusterSet):
    """The ``march.deep`` span for a wave past MAX_CLUSTERS, else a null
    context (the waves of smaller scenes open no span)."""
    if bm.is_deep(clusters.num_clusters):
        return profiling.span("march.deep")
    return contextlib.nullcontext()


def _march_hit(clusters: ClusterSet, o, d, t_min, t_max, coherent: bool,
               any_hit: bool, perm=None, tables=None) -> Hit:
    """A wave's Hit in the caller's order: kernel P (through ``perm``, or
    in place), B, F or past MAX_CLUSTERS F2 (``block_march``'s rule), then
    Q.  ``tables``: the wave's ``march_tables``, when the caller has built
    them."""
    deep = bm.is_deep(clusters.num_clusters)
    hier = not deep and bm.use_hier(clusters.num_clusters, coherent)
    if tables is None:
        tables = bm.march_tables(clusters, coherent, hier)
    rays, inv = march_glue.gather_rays(o, d, t_min, t_max, perm, tables["w"])
    march = (bm.march_deep_call if deep else
             bm.march_hier_call if hier else bm.march_call)
    t, slot, _ = march(rays=rays, **tables, any_hit=any_hit)
    return Hit(*march_glue.finish_hits(t, slot, clusters.prim_index,
                                       o.shape[0], o, d, clusters.woop,
                                       inv=inv, any_hit=any_hit))


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
        """Common-point ("origin", "target") or common-direction ("ortho")
        wave query through the tile-raster engine; rays in a
        screen-coherent layout (camera tile order).  Exact at any pair
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
        with profiling.span("route.raster"):
            t, slot, u, v, ok = raster_query(
                self.raster, self.clusters, o2, d2, t_min_a, t_max_a,
                mode=mode, point=point, any_hit=any_hit,
                block_rays=block_rays, pc_max=pc_max,
                granularity=granularity)
        if ok:
            hit = _hit_from_slots(self.clusters, t, slot, u, v)
        else:
            with profiling.span("route.overflow"), \
                    _deep_span(self.clusters):
                hit = _march_hit(self.clusters, o2, d2, t_min_a, t_max_a,
                                 coherent=True, any_hit=any_hit)
        if scene.sphere_count > 0:
            hit = sphere_bruteforce_merge(scene, o2, d2, t_min_a, t_max_a,
                                          hit)
        return hit.reshape(shape)

    def intersect_bundled(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                          t_max=INF, any_hit: bool = False,
                          block_rays: int = 1024, pc_max: int | None = None,
                          granularity: int | None = None) -> Hit:
        """Arbitrary-wave query through the bundle engine
        (``ops/raster.bundle_query``): rays in a spatially coherent layout
        (screen-tile order), dead lanes (t_max <= t_min) drop out of the
        block bounds.  Exact at any pair count: when the schedule
        overflows, the whole wave goes to the incoherent marcher (decided
        on the host; the JAX package selects on the device)."""
        shape = o.shape[:-1]
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        n = o2.shape[0]
        t_min_a = ray_bound(t_min, n, o2.device)
        t_max_a = ray_bound(t_max, n, o2.device)
        # bundles keep whole-cluster windows (the JAX package's measured
        # choice: finer windows pair secondary blocks with more windows)
        with profiling.span("route.raster"):
            t, slot, u, v, ok = bundle_query(
                self.clusters, o2, d2, t_min_a, t_max_a, any_hit=any_hit,
                block_rays=block_rays, pc_max=pc_max,
                granularity=granularity or 1)
        if ok:
            hit = _hit_from_slots(self.clusters, t, slot, u, v)
        else:
            with profiling.span("route.overflow"), \
                    _deep_span(self.clusters):
                hit = _march_hit(self.clusters, o2, d2, t_min_a, t_max_a,
                                 coherent=False, any_hit=any_hit)
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

        cs = self.clusters
        sort_free = self.num_tris <= SORT_FREE_TRIS
        coherent = sort_free or self.sort_mode != "probe"
        perm = tables = None
        with _deep_span(cs):
            if not sort_free:
                if self.sort_mode == "probe":
                    tables = bm.march_tables(cs, coherent=False)
                    boxes = tables["boxes"]
                    rays, _ = march_glue.gather_rays(o2, d2, t_min_a,
                                                     t_max_a)
                    # past MAX_CLUSTERS, C2's tables: the wave's own
                    deep = {k: tables[k] for k in ("sup_boxes", "hyper_boxes")
                            if k in tables}
                    cid = bm.probe_call(
                        rays=rays, boxes=boxes, n_clusters=cs.num_clusters,
                        c_pad=boxes.shape[0], **deep)[0]
                    shift = bm.probe_key_shift(boxes.shape[0])
                    if shift:
                        cid = cid >> shift
                    key = march_glue.march_keys(d2, cid=cid)
                else:
                    key = march_glue.march_keys(d2, o2, self.scene_lo,
                                                self.scene_hi)
                perm = torch.argsort(key, stable=True)
            hit = _march_hit(cs, o2, d2, t_min_a, t_max_a, coherent,
                             _any_hit, perm, tables)
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
    """Build the ClusterSet on the host ("sah", "morton"), or with
    "median" on the scene's device (``rebuild_clusters`` from scratch), and
    the intersector on the scene's device."""
    tv = scene.triangles.vertices
    if method == "median":
        clusters = rebuild_clusters(None, tv)
    else:
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


def _moved(prev: MarchIntersector, scene: Scene,
           clusters: ClusterSet) -> MarchIntersector:
    """``prev`` with new clusters for ``scene``: bounds recomputed, raster
    tables re-attached when ``prev`` had them."""
    tv = scene.triangles.vertices
    out = MarchIntersector(clusters=clusters, scene_lo=tv.amin((0, 1)),
                           scene_hi=tv.amax((0, 1)), num_tris=prev.num_tris,
                           sort_mode=prev.sort_mode)
    return attach_raster(out, scene) if prev.raster is not None else out


def _check_count(prev: MarchIntersector, scene: Scene, what: str) -> None:
    n = scene.triangles.vertices.shape[0]
    if n != prev.num_tris:
        raise ValueError(
            f"{what} requires the build-time triangle count "
            f"({prev.num_tris}); got {n} -- use make_march_intersector")


def rebuild_march_intersector(prev: MarchIntersector, scene: Scene,
                              method: str = "median") -> MarchIntersector:
    """A fresh slot order and refit on the device (``rebuild_clusters``),
    the per-file build.  ``method``: "median" or "morton"."""
    _check_count(prev, scene, "rebuild")
    return _moved(prev, scene, rebuild_clusters(
        prev.clusters, scene.triangles.vertices, method=method))


def refit_march_intersector(prev: MarchIntersector,
                            scene: Scene) -> MarchIntersector:
    """New vertex positions in ``prev``'s slot order (``refit_clusters``),
    the per-frame refit."""
    _check_count(prev, scene, "refit")
    return _moved(prev, scene, refit_clusters(prev.clusters,
                                              scene.triangles.vertices))
