"""Perspective binning for common-point waves: the scheduler side of the
tile-raster engine (port of the common-point subset of
``optix_ray_tracer_tpu/ops/raster.py``; kernel in
``ops/kernels/tile_raster.py``).

A wave qualifies when every ray passes through one point: camera waves
share their origin, shadow waves toward a point light their target.  Such
rays map to points on a projection plane, so (ray tile, cluster window)
candidate pairs follow from 2-D rectangle and depth-interval overlap.
The binning is conservative (margined rects; vertices behind the plane
make their window full-plane; dead rays drop out), so it only decides
WHICH pairs the kernel tests, never the result.

Pair counts depend on the data.  The schedule has a fixed capacity
``pc_max``; when the wave needs more, ``raster_query`` reports ok=False
and ``MarchIntersector.intersect_from`` traces the whole wave with the
exact marcher instead.  The bundle (3-D) binning and ortho mode wait for a
later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops.kernels.tile_raster import (
    GROUP_TRIS, raster_cluster_call,
)
from optix_ray_tracer_tpu_torch.ops.sweep import (
    CHUNK, SUBS_PER_CLUSTER, ClusterSet,
)
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, nanmax, nanmin, tree_map,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, cross, dot

GROUPS_PER_CLUSTER = CHUNK // GROUP_TRIS

#: projection modes: the rays share their origin / their target point
MODES = ("origin", "target")


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


def _basis_from(wvec):
    """Right-handed orthonormal (u, v, w) with w along ``wvec``."""
    w = wvec / torch.clamp(torch.linalg.norm(wvec), min=1e-12)
    ex = torch.tensor([1.0, 0.0, 0.0], device=w.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=w.device)
    a = torch.where(torch.abs(w[0]) < 0.9, ex, ey)
    u = cross(w, a)
    u = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
    return u, cross(w, u), w


def _proj(q, basis):
    """Perspective projection of rows of q: (x, y, w, good).  NaN rows stay
    NaN and read good=False; rows on or behind the plane (w <= 0) read
    good=False with finite garbage coordinates."""
    u, v, w = basis
    qu, qv, qw = dot(q, u), dot(q, v), dot(q, w)
    good = qw > 0.0
    den = torch.where(good, qw, torch.ones_like(qw))
    return qu / den, qv / den, qw, good


def default_pc_max(n_blocks: int, n_clusters: int,
                   granularity: int = 1) -> int:
    """Pair-capacity heuristic sized for coherent waves; overflow falls back
    to the marcher, so it bounds cost, not correctness."""
    pc = 12 * n_blocks + 2 * n_clusters + 1024
    pc = pc * (1 + granularity) // 2
    return ((pc + 1023) // 1024) * 1024


def _rank_lookup(cum_rows, flat_dim: int, row_idx, rank):
    """Smallest column c with cum_rows[row, c] >= rank + 1, by bisection
    over the flattened inclusive row-cumsum matrix."""
    flat = cum_rows.reshape(-1)
    lo = torch.zeros_like(row_idx)
    hi = torch.full_like(row_idx, flat_dim - 1)
    for _ in range(max(1, (flat_dim - 1).bit_length())):
        mid = (lo + hi) // 2
        ge = flat[row_idx * flat_dim + mid] >= rank + 1
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return hi


def _enumerate_sorted_pairs(ov, entry_depth, nb: int, C: int, pc_max: int):
    """Enumerate the True cells of the (nb, C) overlap matrix into flat
    (block, cluster) lists capped at ``pc_max`` (fixed shapes, no host
    read), stable-sorted by (block, entry_depth[cluster]) so each tile sees
    its windows near to far.  Returns (b_i, c_i, validc, pc_total, cnt_b).
    """
    dev = ov.device
    ovi = ov.to(torch.int64)
    cnt_b = ovi.sum(1)
    cum_b = torch.cumsum(cnt_b, 0)
    pc_total = cum_b[-1]
    i = torch.arange(pc_max, device=dev)
    b_i = torch.clamp(torch.searchsorted(cum_b, i, right=True), max=nb - 1)
    validc = i < pc_total
    j = i - (cum_b[b_i] - cnt_b[b_i])
    c_i = _rank_lookup(torch.cumsum(ovi, 1), C, b_i, j)
    key_tile = torch.where(validc, b_i, torch.full_like(b_i, nb))
    key_depth = torch.where(validc, entry_depth[c_i],
                            torch.full_like(entry_depth[c_i], INF))
    # lexicographic stable sort: by depth, then (stably) by tile
    o1 = torch.argsort(key_depth, stable=True)
    perm = o1[torch.argsort(key_tile[o1], stable=True)]
    return b_i[perm], c_i[perm], validc[perm], pc_total, cnt_b


def _pad_wave(o, d, t_min, t_max, n: int, nb: int, W: int):
    """Pad a wave to nb*W rays plus one trailing dead block; padded lanes
    are dead (t_max <= t_min)."""
    dev = o.device
    t_min_a = torch.as_tensor(t_min, dtype=torch.float32, device=dev
                              ).expand(n)
    t_max_a = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32,
                                          device=dev).expand(n), max=INF)
    pad = nb * W - n + W
    dead_d = torch.zeros((pad, 3), device=dev)
    dead_d[:, 2] = 1.0
    return (torch.cat([o, torch.zeros((pad, 3), device=dev)]),
            torch.cat([d, dead_d]),
            torch.cat([t_min_a, torch.ones(pad, device=dev)]),
            torch.cat([t_max_a, torch.zeros(pad, device=dev)]))


def _block_rects(o_p, d_p, tmin_p, tmax_p, nb: int, W: int, basis,
                 mode: str, point):
    """Per-block ray rects and depth ranges on the projection plane.
    Returns (bx0, bx1, by0, by1, bz0, bz1, live_any)."""
    q_rays = (d_p if mode == "origin" else o_p - point)[:nb * W]
    rx, ry, rqw, rgood = _proj(q_rays, basis)
    tmin_r = tmin_p[:nb * W]
    tmax_r = tmax_p[:nb * W]
    live = tmax_r > tmin_r
    pv = rgood & live
    nan = torch.full_like(rx, float("nan"))
    pxm = torch.where(pv, rx, nan).reshape(nb, W)
    pym = torch.where(pv, ry, nan).reshape(nb, W)
    live_any = live.reshape(nb, W).any(1)
    # depth along a ray is w0 + t * (d . w_basis) for every ray (no
    # division): segments only need geometry inside their depth interval
    if mode == "origin":
        wd = rqw
        w0 = torch.zeros_like(wd)
    else:
        wd = dot(d_p[:nb * W], basis[2])
        w0 = rqw
    dlo = w0 + torch.minimum(tmin_r * wd, tmax_r * wd)
    dhi = w0 + torch.maximum(tmin_r * wd, tmax_r * wd)
    bz0 = torch.where(live, dlo, torch.full_like(dlo, INF)
                      ).reshape(nb, W).amin(1)
    bz1 = torch.where(live, dhi, torch.full_like(dhi, -INF)
                      ).reshape(nb, W).amax(1)
    return (nanmin(pxm, 1), nanmax(pxm, 1), nanmin(pym, 1), nanmax(pym, 1),
            bz0, bz1, live_any)


def _coarse_stage(rset: RasterSet, clusters: ClusterSet, o, d, t_min,
                  t_max, mode: str, point, W: int, pc_max: int,
                  granularity: int = 1) -> dict:
    """Projections, window/block rects with depth ranges, coarse (block,
    window) pair enumeration and the per-block depth sort.  A window is
    CHUNK/granularity consecutive triangles; its id is cluster * g + sub."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = o.device
    C = clusters.num_clusters * granularity
    n_g = rset.num_groups
    n = o.shape[0]
    nb = -(-n // W)
    o_p, d_p, tmin_p, tmax_p = _pad_wave(o, d, t_min, t_max, n, nb, W)

    p = torch.as_tensor(point, dtype=torch.float32, device=dev)
    q_verts = rset.verts.reshape(-1, 3) - p
    # projection axis from the vertex centroid seen from the shared point
    # (not from the wave's rays, so any band of the wave bins alike)
    vmask = torch.isnan(q_verts[:, 0])
    vsum = torch.where(vmask[:, None], torch.zeros_like(q_verts),
                       q_verts).sum(0)
    vcnt = torch.clamp((~vmask).sum(), min=1).to(torch.float32)
    wvec = vsum / vcnt
    wvec = torch.where(torch.linalg.norm(wvec) > 1e-12, wvec,
                       torch.tensor([0.0, 0.0, 1.0], device=dev))
    basis = _basis_from(wvec)

    # ---- window rects (plane + depth), via 8-triangle groups ----
    vx, vy, vw, vgood = _proj(q_verts, basis)
    behind = ~vgood & ~torch.isnan(vx)
    nan = torch.full_like(vx, float("nan"))
    vxm = torch.where(vgood, vx, nan).reshape(n_g, 3 * GROUP_TRIS)
    vym = torch.where(vgood, vy, nan).reshape(n_g, 3 * GROUP_TRIS)
    vzm = vw.reshape(n_g, 3 * GROUP_TRIS)     # depth keeps behind verts
    gx0, gx1 = nanmin(vxm, 1), nanmax(vxm, 1)
    gy0, gy1 = nanmin(vym, 1), nanmax(vym, 1)
    gz0, gz1 = nanmin(vzm, 1), nanmax(vzm, 1)
    gfull = behind.reshape(n_g, 3 * GROUP_TRIS).any(1)
    # conservative margin: dominates fp projection error (rel ~1e-7)
    mx = 1e-5 * (torch.abs(gx0) + torch.abs(gx1)) + 1e-6
    my = 1e-5 * (torch.abs(gy0) + torch.abs(gy1)) + 1e-6
    mz = 1e-5 * (torch.abs(gz0) + torch.abs(gz1)) + 1e-6
    G = GROUPS_PER_CLUSTER // granularity
    cx0 = nanmin((gx0 - mx).reshape(C, G), 1)
    cx1 = nanmax((gx1 + mx).reshape(C, G), 1)
    cy0 = nanmin((gy0 - my).reshape(C, G), 1)
    cy1 = nanmax((gy1 + my).reshape(C, G), 1)
    cz0 = nanmin((gz0 - mz).reshape(C, G), 1)
    cz1 = nanmax((gz1 + mz).reshape(C, G), 1)
    cfull = gfull.reshape(C, G).any(1)

    bx0, bx1, by0, by1, bz0, bz1, live_any = _block_rects(
        o_p, d_p, tmin_p, tmax_p, nb, W, basis, mode, p)

    ov = ((bx0[:, None] <= cx1[None, :]) & (bx1[:, None] >= cx0[None, :])
          & (by0[:, None] <= cy1[None, :]) & (by1[:, None] >= cy0[None, :]))
    ovz = (bz0[:, None] <= cz1[None, :]) & (bz1[:, None] >= cz0[None, :])
    ov = (ov | cfull[None, :]) & ovz & live_any[:, None]
    b_s, c_s, v_s, pc_total, cnt_b = _enumerate_sorted_pairs(
        ov, cz0, nb, C, pc_max)
    return dict(n=n, nb=nb, o_p=o_p, d_p=d_p, tmin_p=tmin_p, tmax_p=tmax_p,
                b_i=b_s, c_i=c_s, validc=v_s, pc_total=pc_total,
                cnt_b=cnt_b)


def raster_query(rset: RasterSet, clusters: ClusterSet, o, d, t_min, t_max,
                 mode: str = "origin", point=None, any_hit: bool = False,
                 block_rays: int = 1024, pc_max: int | None = None,
                 granularity: int = 1):
    """Nearest-hit (or occlusion) query for a common-point wave, rays in
    caller order (blocks are consecutive runs of ``block_rays``; camera
    tile order makes them coherent).

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
    # per tile.  "target" waves keep full width (occlusion callers flip
    # them to "origin" upstream, ops/march.py intersect_from).
    common = "origin" if mode == "origin" else None
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
    and ``common``) for a schedule ``S`` from :func:`_coarse_stage`."""
    C = clusters.num_clusters
    g = granularity
    n_subs = SUBS_PER_CLUSTER // g
    validc = S["validc"]
    dev = validc.device
    return dict(
        pair_tiles=torch.where(validc, S["b_i"], torch.full_like(S["b_i"], nb)
                               ).to(torch.int32),
        pair_clusters=torch.where(validc, S["c_i"],
                                  torch.zeros_like(S["c_i"])
                                  ).to(torch.int32),
        rays_t_ext=torch.cat([S["o_p"].T, S["d_p"].T, S["tmin_p"][None, :],
                              S["tmax_p"][None, :]], 0).contiguous(),
        # per-window gate rows: a pure reshape of the build's sub boxes
        sub_boxes=torch.cat([clusters.sub_min.reshape(C * g, n_subs, 3),
                             clusters.sub_max.reshape(C * g, n_subs, 3),
                             torch.zeros((C * g, n_subs, 2), device=dev)],
                            2).contiguous(),
        woop_t=clusters.woop_t, n_blocks=nb, n_subs=n_subs, granularity=g)


def measure_pair_count(rset: RasterSet, clusters: ClusterSet, o, d, t_min,
                       t_max, mode: str = "origin", point=None,
                       block_rays: int = 1024, granularity: int = 1) -> int:
    """The exact pair count the binning enumerates for this wave (for
    calibrating ``pc_max`` once per scene and wave kind)."""
    S = _coarse_stage(rset, clusters, o, d, t_min, t_max, mode, point,
                      block_rays, 8, granularity)
    return int(S["pc_total"])


def round_pc_max(count: int, margin: float = 1.15) -> int:
    """Capacity from a measured pair count: a margin, rounded up to 1024."""
    pc = int(count * margin) + 256
    return max(1024, ((pc + 1023) // 1024) * 1024)


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
