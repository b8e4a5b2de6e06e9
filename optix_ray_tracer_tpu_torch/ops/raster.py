"""Binning for the tile-raster engine (port of
``optix_ray_tracer_tpu/ops/raster.py``; the binning's kernels S, T and U
in ``ops/kernels/binning.py``, the raster kernel in
``ops/kernels/tile_raster.py``).

Projective binning (:func:`raster_query`): a wave qualifies when every ray
passes through one point (camera waves share their origin, shadow waves
toward a point light their target) or shares one direction (ortho / sun
waves).  Such rays map to points on a projection plane, so (ray tile,
cluster window) candidate pairs follow from 2-D rectangle and
depth-interval overlap.  Bundle binning (:func:`bundle_query`): an
arbitrary wave in a spatially coherent layout (area-light shadow segments
from a tile's hit points) gets per-block origin and direction intervals,
split by direction octant, and interval arithmetic admits the (block,
cluster) pairs some ray could reach.  Both are conservative (margined
rects and boxes; vertices behind the plane make their window full-plane;
dead rays drop out), so they only decide WHICH pairs the kernel tests,
never the result.

Pair counts depend on the data.  The schedule has a fixed capacity
``pc_max``; when the wave needs more, the query reports ok=False and
``MarchIntersector.intersect_from`` / ``intersect_bundled`` trace the
whole wave with the exact marcher instead.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops.kernels import binning
from optix_ray_tracer_tpu_torch.ops.kernels.tile_raster import (
    GROUP_TRIS, raster_cluster_call,
)
from optix_ray_tracer_tpu_torch.ops.sweep import SUBS_PER_CLUSTER, ClusterSet
from optix_ray_tracer_tpu_torch.utils import profiling
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass, tree_map
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

#: projection modes: the rays share their origin / their target point /
#: their direction (orthographic)
MODES = ("origin", "target", "ortho")

#: callables ``fn(args, kw, S)`` that :func:`bundle_query` calls with each
#: wave's :func:`bundle_stage` arguments and its schedule, before kernel A
#: runs it: instrumentation, empty unless a caller appends one
BUNDLE_OBSERVERS: list = []


@dataclasses.dataclass(frozen=True)
class RasterSet(TensorDataclass):
    """verts: (n_pad, 3, 3) sorted triangle vertices, NaN where padded."""
    verts: torch.Tensor

    @property
    def num_groups(self) -> int:
        return self.verts.shape[0] // GROUP_TRIS


def build_raster_set(clusters: ClusterSet, tri_vertices) -> RasterSet:
    """Raster tables from a ClusterSet and the original (n, 3, 3) vertices."""
    n_pad = clusters.woop.shape[0]
    tv = tri_vertices.reshape(-1, 3, 3).to(torch.float32)
    n = tv.shape[0]
    dev = clusters.woop.device
    if n == 0:
        return RasterSet(torch.full((n_pad, 3, 3), float("nan"), device=dev))
    sv = tv[torch.clamp(clusters.prim_index.long(), max=n - 1)]
    live = (torch.arange(n_pad, device=dev) < n)[:, None, None]
    return RasterSet(torch.where(live, sv, torch.full_like(sv, float("nan"))))


def default_pc_max(n_blocks: int, n_clusters: int,
                   granularity: int = 1) -> int:
    """Pair-capacity heuristic sized for coherent waves; overflow falls back
    to the marcher, so it bounds cost, not correctness."""
    pc = 12 * n_blocks + 2 * n_clusters + 1024
    pc = pc * (1 + granularity) // 2
    return ((pc + 1023) // 1024) * 1024


def _target(point, mode: str, dev):
    """The shared point as T reads it: a tensor on ``dev`` in the "target"
    mode (the only one whose block bounds use it), else None."""
    if mode != "target":
        return None
    return torch.as_tensor(point, dtype=torch.float32, device=dev)


def _schedule(o, d, t_min, t_max, W: int, pc_max: int, mode: str, rects,
              cfull=None, basis=None, point=None, dir_octants: bool = True,
              tables=None) -> dict:
    """The (block, window) schedule of a wave against S's window
    ``rects`` (``ops/kernels/binning``): T's ray pack, block bounds,
    counts and hit mask, then U's sorted pairs.  ``mode`` is one of MODES
    (projective, on ``basis`` from ``point``) or "bundle"; ``tables`` the
    TLAS pairs' (pair_shape, pair_inst) for U's pair_libs and pair_insts.
    The dict
    holds the padded wave as views of the ray pack ``rays_t_ext`` (8,
    (nb + 1) W), b_i, c_i, validc, the kernels' pair arrays, pc_total (a
    0-dim tensor: no host read) and cnt_b."""
    rays, cnt_b, offs, bounds, mask = binning.bin_count(
        o, d, t_min, t_max, W, mode, rects, cfull, basis, point, dir_octants)
    lib_of, inst_of = tables or (None, None)
    S = binning.bin_emit(rects, bounds, cnt_b, offs, mask, pc_max, mode,
                         lib_of, inst_of)
    nb = cnt_b.shape[0]
    return dict(n=o.shape[0], nb=nb, o_p=rays[0:3].T, d_p=rays[3:6].T,
                tmin_p=rays[6], tmax_p=rays[7], rays_t_ext=rays,
                pc_total=offs[nb], cnt_b=cnt_b, **S)


def _coarse_stage(rset: RasterSet, clusters: ClusterSet, o, d, t_min,
                  t_max, mode: str, point, W: int, pc_max: int,
                  granularity: int = 1) -> dict:
    """Projections, window/block rects with depth ranges, coarse (block,
    window) pair enumeration and the per-block depth sort.  A window is
    CHUNK/granularity consecutive triangles; its id is cluster * g + sub.
    Kernel S takes the projection axis from the vertex centroid seen from
    the shared point (not from the wave's rays, so any band of the wave
    bins alike), or, "ortho", from ``d[0]`` (the contract: every ray
    shares d)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    rects, cfull, basis = binning.bin_rects(
        binning.RECTS_CLUSTER, rset.verts,
        point=None if mode == "ortho" else point, granularity=granularity,
        d=d)
    return _schedule(o, d, t_min, t_max, W, pc_max, mode, rects, cfull,
                     basis, _target(point, mode, o.device))


def raster_query(rset: RasterSet, clusters: ClusterSet, o, d, t_min, t_max,
                 mode: str = "origin", point=None, any_hit: bool = False,
                 block_rays: int = 1024, pc_max: int | None = None,
                 granularity: int = 1):
    """Nearest-hit (or occlusion) query for a common-point or
    common-direction wave, rays in caller order (blocks are consecutive
    runs of ``block_rays``; camera tile order makes them coherent).
    ``point`` is the shared point of the "origin" and "target" modes;
    "ortho" takes the shared direction from ``d[0]``.

    Returns (t, slot, u, v, ok): slot indexes the sorted triangles (-1
    miss); ``ok`` (a Python bool) is False when the schedule overflowed
    ``pc_max``, and then the other results are not valid."""
    W = block_rays
    n = o.shape[0]
    nb = -(-n // W)
    pc_max = pc_max or default_pc_max(nb, clusters.num_clusters,
                                      granularity)
    S = _coarse_stage(rset, clusters, o, d, t_min, t_max, mode, point, W,
                      pc_max, granularity)
    # "origin" rays all start at ``point``: their o-projections are shared
    # per tile; "ortho" rays share d, and so their d-projections.  "target"
    # waves keep full width (occlusion callers flip them to "origin"
    # upstream, ops/march.py intersect_from).
    common = {"origin": "origin", "ortho": "dir", "target": None}[mode]
    return _run_pair_schedule(clusters, S, W, n, nb, any_hit, common,
                              pc_max, granularity)


def _run_pair_schedule(clusters: ClusterSet, S: dict, W: int, n: int,
                       nb: int, any_hit: bool, common: str | None,
                       pc_max: int, granularity: int = 1):
    """Run kernel A over an enumerated schedule and unpack
    (t, slot, u, v, ok)."""
    g = granularity
    if SUBS_PER_CLUSTER % g:
        raise ValueError(f"granularity {g} must divide SUBS_PER_CLUSTER "
                         f"({SUBS_PER_CLUSTER})")
    # the overflow decides on the host: one read of the pair count per
    # wave (the JAX package selects on the device with lax.cond)
    with profiling.span("sync.pair_count"):
        pc_total = int(S["pc_total"])
    ok = pc_total <= pc_max
    dev = S["o_p"].device
    if ok:
        t, slot, u, v = (x.reshape(-1)[:n] for x in raster_cluster_call(
            **schedule_inputs(clusters, S, nb, g), w=W, any_hit=any_hit,
            common=common))
        touched = (S["cnt_b"] > 0)[:, None].expand(nb, W).reshape(-1)[:n]
        miss = (slot < 0) | ~touched
    else:
        t = torch.zeros(n, device=dev)
        slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
        u = v = t
        miss = torch.ones(n, dtype=torch.bool, device=dev)
    zero = torch.zeros_like(t)
    t = torch.where(miss, torch.full_like(t, INF), t)
    slot = torch.where(miss, torch.full_like(slot, -1), slot)
    u = torch.where(miss, zero, u)
    v = torch.where(miss, zero, v)
    return t, slot, u, v, ok


def schedule_inputs(clusters: ClusterSet, S: dict, nb: int,
                    granularity: int = 1) -> dict:
    """The ``raster_cluster_call`` arguments (all but ``w``, ``any_hit``
    and ``common``) for a schedule ``S`` from :func:`_coarse_stage` or
    :func:`bundle_stage`."""
    C = clusters.num_clusters
    g = granularity
    n_subs = SUBS_PER_CLUSTER // g
    dev = S["validc"].device
    return dict(
        pair_tiles=S["pair_tiles"], pair_clusters=S["pair_clusters"],
        rays_t_ext=S["rays_t_ext"],
        # per-window gate rows: a pure reshape of the build's sub boxes
        sub_boxes=torch.cat([clusters.sub_min.reshape(C * g, n_subs, 3),
                             clusters.sub_max.reshape(C * g, n_subs, 3),
                             torch.zeros((C * g, n_subs, 2), device=dev)],
                            2).contiguous(),
        woop_t=clusters.woop_t, n_blocks=nb, n_subs=n_subs, granularity=g)


def measure_pair_count(rset: RasterSet | None, clusters: ClusterSet, o, d,
                       t_min, t_max, mode: str = "origin", point=None,
                       block_rays: int = 1024, granularity: int = 1) -> int:
    """The exact pair count the binning enumerates for this wave (for
    calibrating ``pc_max`` once per scene and wave kind); ``rset=None``
    measures the 3-D bundle binning instead of the projective one."""
    if rset is None:
        S = bundle_stage(clusters, o, d, t_min, t_max, block_rays, 8,
                         granularity=granularity)
    else:
        S = _coarse_stage(rset, clusters, o, d, t_min, t_max, mode, point,
                          block_rays, 8, granularity)
    return int(S["pc_total"])


def round_pc_max(count: int, margin: float = 1.15) -> int:
    """Capacity from a measured pair count: a margin, rounded up to 1024."""
    pc = int(count * margin) + 256
    return max(1024, ((pc + 1023) // 1024) * 1024)


def default_bundle_pc_max(n_blocks: int, n_clusters: int,
                          granularity: int = 1) -> int:
    """Bundle-pair capacity heuristic: secondary blocks overlap more
    clusters than common-point blocks, so ~an order more pairs per block.
    An overflow falls back to the marcher: a cost bound, not a correctness
    bound."""
    pc = 96 * n_blocks + 2 * n_clusters * granularity + 1024
    pc = pc * (1 + granularity) // 2
    return ((pc + 1023) // 1024) * 1024


def bundle_stage(clusters: ClusterSet, o, d, t_min, t_max, W: int,
                 pc_max: int, dir_octants: bool = True,
                 granularity: int = 1) -> dict:
    """Conservative 3-D binning for an arbitrary wave in a spatially
    coherent layout (screen tiles: a tile's secondary origins are its
    primary-hit surface patch).

    Each W-ray block gets componentwise origin and direction interval
    bounds over its live rays (dead lanes, t_max <= t_min, drop out).  A
    (block, window) pair survives when interval arithmetic admits some
    t >= 0 with [olo + t dlo, ohi + t dhi] overlapping the window's
    margined AABB on every axis, inside the block's [t_min, t_max].  With
    ``dir_octants`` the test runs once per direction-sign octant of the
    block's lanes and the results are OR'd (one pair however many octants
    admit it, keyed by the smallest admitted entry t for the depth sort).
    Margins: absolute on the boxes, relative on the division results;
    |d| <= 1e-12 counts as always satisfiable."""
    rects = binning.bin_rects(binning.RECTS_BOX, clusters.sub_min,
                              clusters.sub_max, granularity=granularity)[0]
    return _schedule(o, d, t_min, t_max, W, pc_max, "bundle", rects,
                     dir_octants=dir_octants)


def bundle_query(clusters: ClusterSet, o, d, t_min, t_max,
                 any_hit: bool = False, block_rays: int = 1024,
                 pc_max: int | None = None, dir_octants: bool = True,
                 granularity: int = 1):
    """Nearest-hit (or occlusion) query for an arbitrary wave in a
    spatially coherent layout, through :func:`bundle_stage` and kernel A
    with full-width dots (no shared point or direction).  The contract of
    :func:`raster_query`: rays in caller order, blocks of ``block_rays``;
    returns (t, slot, u, v, ok), ok False on a schedule overflow."""
    W = block_rays
    n = o.shape[0]
    nb = -(-n // W)
    pc_max = pc_max or default_bundle_pc_max(nb, clusters.num_clusters,
                                             granularity)
    args = (clusters, o, d, t_min, t_max, W, pc_max)
    kw = dict(dir_octants=dir_octants, granularity=granularity)
    S = bundle_stage(*args, **kw)
    for observe in BUNDLE_OBSERVERS:
        observe(args, kw, S)
    return _run_pair_schedule(clusters, S, W, n, nb, any_hit, None, pc_max,
                              granularity)


def pick_camera_tiles(height: int, width: int):
    """(th, tw) pixel tiles whose th*tw-ray blocks feed the raster engine,
    or None if the frame does not tile cleanly into >= 256-ray blocks."""
    def edge(x):
        for t in (32, 16, 8):
            if x % t == 0:
                return t
        return 0
    th, tw = edge(height), edge(width)
    if th * tw < 256:
        return None
    return th, tw


def to_tiles(a, S: int, H: int, W: int, th: int, tw: int):
    """A camera wave's rays (S * H * W, ...) in (sample, row, col) order ->
    (sample, tile, block, in-block) order: th x tw pixel tiles, row-major,
    each cut into 8-wide, 4-tall pixel blocks, row-major (th a multiple of
    4, tw of 8).  Every 32 consecutive rays are then one block, the rays
    that a warp of kernels A and D gates together; a tile's first ray is
    still its top-left pixel.  A pure reshape; :func:`from_tiles` undoes
    it."""
    rest = a.shape[1:]
    return (a.reshape((S, H // th, th // 4, 4, W // tw, tw // 8, 8) + rest)
            .permute(0, 1, 4, 2, 5, 3, 6, *range(7, 7 + len(rest)))
            .reshape((S * H * W,) + rest))


def from_tiles(a, S: int, H: int, W: int, th: int, tw: int):
    """The inverse of :func:`to_tiles`."""
    rest = a.shape[1:]
    return (a.reshape((S, H // th, W // tw, th // 4, tw // 8, 4, 8) + rest)
            .permute(0, 1, 3, 5, 2, 4, 6, *range(7, 7 + len(rest)))
            .reshape((S * H * W,) + rest))


def make_camera_intersect(intersector, point, S: int, H: int, W: int,
                          th: int, tw: int):
    """An ``intersect``-compatible callable that routes a camera wave
    (rays flattened in (sample, row, col) order) through the raster engine
    in :func:`to_tiles` order, and returns the Hit in the caller's
    order."""
    layout = (S, H, W, th, tw)

    def isect(scene, o, d, t_min=1e-3, t_max=INF):
        t_max_t = (to_tiles(t_max.expand(o.shape[0]), *layout)
                   if isinstance(t_max, torch.Tensor) and t_max.dim()
                   else t_max)
        hit = intersector.intersect_from(
            scene, to_tiles(o, *layout), to_tiles(d, *layout), mode="origin",
            point=point, t_min=t_min, t_max=t_max_t, block_rays=th * tw)
        return tree_map(lambda a: from_tiles(a, *layout), hit)

    return isect


def make_tiled_bundle_intersect(intersector, S: int, H: int, W: int,
                                th: int, tw: int,
                                block_rays: int | None = None,
                                pc_max: int | None = None):
    """An ``intersect``-compatible callable routing a secondary wave (NEE
    shadow segments) through the bundle engine
    (``intersector.intersect_bundled``), with an ``any_hit`` attribute.
    Rays arrive in (sample, row, col) order and are re-viewed in
    :func:`to_tiles` order, so a block is a camera tile and its origins
    the tile's hit points; the Hit comes back in the caller's order."""
    layout = (S, H, W, th, tw)
    br = block_rays or th * tw

    def tiled(x, n):
        return (to_tiles(x.expand(n), *layout)
                if isinstance(x, torch.Tensor) and x.dim() else x)

    def query(scene, o, d, t_min, t_max, any_hit):
        n = o.shape[0]
        hit = intersector.intersect_bundled(
            scene, to_tiles(o, *layout), to_tiles(d, *layout),
            t_min=tiled(t_min, n), t_max=tiled(t_max, n), any_hit=any_hit,
            block_rays=br, pc_max=pc_max)
        return tree_map(lambda a: from_tiles(a, *layout), hit)

    # both call ``query``, never each other: ``isect`` holds ``any_hit_fn``,
    # so a reference back would be a cycle that keeps the frame's
    # intersector on the device until the garbage collector's next full pass
    def isect(scene, o, d, t_min=1e-3, t_max=INF, any_hit=False):
        return query(scene, o, d, t_min, t_max, any_hit)

    def any_hit_fn(scene, o, d, t_min=1e-3, t_max=INF):
        return query(scene, o, d, t_min, t_max, True).is_hit

    isect.any_hit = any_hit_fn
    return isect


def camera_tile_layout(intersector, camera, S: int, height: int,
                       width: int):
    """(S, H, W, th, tw) when the camera wave can take the raster engine
    (the intersector carries raster tables, the camera is a pinhole, the
    frame tiles cleanly), else None."""
    if getattr(intersector, "raster", None) is None:
        return None
    if not hasattr(intersector, "intersect_from"):
        return None
    if float(getattr(camera, "aperture", 0.0)) != 0.0:
        return None
    tiles = pick_camera_tiles(height, width)
    if tiles is None:
        return None
    return (S, height, width, tiles[0], tiles[1])
