"""TLAS-pair raster binning: the tile-raster engine at INSTANCE granularity
(port of ``optix_ray_tracer_tpu/ops/raster_instanced.py``).

Common-point TLAS waves (camera primaries, point-light shadows) are
binned as ``ops/raster.py`` bins clusters, but over TLAS pairs:

* each pair's WORLD box (refit per frame by
  ``ops/instanced.refit_instanced``) projects to a rect and a depth
  interval through its 8 corners;
* ray blocks get the cluster path's rects (``ops/raster._block_rects``);
* kernel D (``ops/kernels/tile_raster.raster_instanced_call``) tests each
  scheduled pair's OBJECT-space library cluster with the tile's rays moved
  into the pair's instance space.

Exactness mirrors the cluster path: the binning is conservative (margined
corner rects, behind-plane corners go full-plane, NaN boxes of invalid
instances never overlap), and a schedule overflow returns ok=False so the
caller falls back to the exact instanced marcher.  The TPU's SMEM cap on
the schedule is dropped: the port's schedule is device memory.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops.kernels.tile_raster import (
    raster_instanced_call,
)
from optix_ray_tracer_tpu_torch.ops.raster import (
    MODES, _basis_from, _block_rects, _enumerate_sorted_pairs, _pad_wave,
    _proj,
)
from optix_ray_tracer_tpu_torch.ops.sweep import SUBS_PER_CLUSTER
from optix_ray_tracer_tpu_torch.utils.tensors import nanmax, nanmin
from optix_ray_tracer_tpu_torch.utils.vecmath import INF


def default_instanced_pc_max(n_blocks: int, n_pairs: int) -> int:
    """Schedule capacity heuristic: coherent blocks overlap few instances;
    an overflow falls back to the marcher (a cost bound, not a correctness
    bound)."""
    pc = 12 * n_blocks + 2 * n_pairs + 1024
    return ((pc + 1023) // 1024) * 1024


def _pair_rects(pair_min, pair_max, basis, point):
    """Project each pair's world box (8 corners) onto the plane seen from
    ``point``.  Returns margined (cx0, cx1, cy0, cy1, cz0, cz1, cfull); NaN
    boxes give NaN rects that never overlap."""
    Cp = pair_min.shape[0]
    dev = pair_min.device
    sel = torch.tensor([[(k >> a) & 1 for a in range(3)] for k in range(8)],
                       dtype=torch.float32, device=dev)[None]     # (1, 8, 3)
    corners = pair_min[:, None, :] * (1.0 - sel) + pair_max[:, None, :] * sel
    q = corners.reshape(-1, 3) - point
    vx, vy, vw, vgood = _proj(q, basis)
    behind = ~vgood & ~torch.isnan(vx)
    nan = torch.full_like(vx, float("nan"))
    vxm = torch.where(vgood, vx, nan).reshape(Cp, 8)
    vym = torch.where(vgood, vy, nan).reshape(Cp, 8)
    vzm = vw.reshape(Cp, 8)           # depth keeps behind-plane corners
    cx0, cx1 = nanmin(vxm, 1), nanmax(vxm, 1)
    cy0, cy1 = nanmin(vym, 1), nanmax(vym, 1)
    cz0, cz1 = nanmin(vzm, 1), nanmax(vzm, 1)
    cfull = behind.reshape(Cp, 8).any(1)
    # conservative margin dominating fp projection error (the cluster
    # path's rule)
    mx = 1e-5 * (torch.abs(cx0) + torch.abs(cx1)) + 1e-6
    my = 1e-5 * (torch.abs(cy0) + torch.abs(cy1)) + 1e-6
    mz = 1e-5 * (torch.abs(cz0) + torch.abs(cz1)) + 1e-6
    return (cx0 - mx, cx1 + mx, cy0 - my, cy1 + my, cz0 - mz, cz1 + mz,
            cfull)


def instanced_coarse_stage(pair_min, pair_max, o, d, t_min, t_max,
                           mode: str, point, W: int, pc_max: int) -> dict:
    """Pair-granularity analog of ``ops/raster._coarse_stage``: pair rects
    from world box corners, the shared block rects, and the depth-sorted
    (block, pair) enumeration."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = o.device
    Cp = pair_min.shape[0]
    n = o.shape[0]
    nb = -(-n // W)
    o_p, d_p, tmin_p, tmax_p = _pad_wave(o, d, t_min, t_max, n, nb, W)

    p = torch.as_tensor(point, dtype=torch.float32, device=dev)
    # projection axis from the finite pair centers' centroid seen from the
    # shared point (geometry, not the wave, decides it)
    c = (pair_min + pair_max) * 0.5 - p
    cmask = torch.isnan(c[:, 0])
    csum = torch.where(cmask[:, None], torch.zeros_like(c), c).sum(0)
    ccnt = torch.clamp((~cmask).sum(), min=1).to(torch.float32)
    wvec = csum / ccnt
    wvec = torch.where(torch.linalg.norm(wvec) > 1e-12, wvec,
                       torch.tensor([0.0, 0.0, 1.0], device=dev))
    basis = _basis_from(wvec)

    cx0, cx1, cy0, cy1, cz0, cz1, cfull = _pair_rects(pair_min, pair_max,
                                                      basis, p)
    bx0, bx1, by0, by1, bz0, bz1, live_any = _block_rects(
        o_p, d_p, tmin_p, tmax_p, nb, W, basis, mode, p)
    ov = ((bx0[:, None] <= cx1[None, :]) & (bx1[:, None] >= cx0[None, :])
          & (by0[:, None] <= cy1[None, :]) & (by1[:, None] >= cy0[None, :]))
    ovz = (bz0[:, None] <= cz1[None, :]) & (bz1[:, None] >= cz0[None, :])
    ov = (ov | cfull[None, :]) & ovz & live_any[:, None]
    b_s, c_s, v_s, pc_total, cnt_b = _enumerate_sorted_pairs(
        ov, cz0, nb, Cp, pc_max)
    return dict(n=n, nb=nb, o_p=o_p, d_p=d_p, tmin_p=tmin_p, tmax_p=tmax_p,
                b_i=b_s, c_i=c_s, validc=v_s, pc_total=pc_total,
                cnt_b=cnt_b)


def instanced_schedule_inputs(intersector, S: dict) -> dict:
    """The ``raster_instanced_call`` arguments (all but ``w``, ``any_hit``
    and ``common``) for a schedule ``S`` from
    :func:`instanced_coarse_stage` over ``intersector``'s pairs."""
    nb = S["nb"]
    validc = S["validc"]
    Cp = intersector.pair_min.shape[0]
    dev = validc.device
    pair_ids = torch.where(validc, S["c_i"], torch.zeros_like(S["c_i"]))
    sub_boxes = torch.cat([
        intersector.sub_min.reshape(Cp, SUBS_PER_CLUSTER, 3),
        intersector.sub_max.reshape(Cp, SUBS_PER_CLUSTER, 3),
        torch.zeros((Cp, SUBS_PER_CLUSTER, 2), device=dev)], 2)
    return dict(
        pair_tiles=torch.where(validc, S["b_i"], torch.full_like(S["b_i"], nb)
                               ).to(torch.int32),
        pair_libs=intersector.pair_shape[pair_ids].to(torch.int32),
        pair_ids=pair_ids.to(torch.int32),
        pair_insts=intersector.pair_inst[pair_ids].to(torch.int32),
        rays_t_ext=torch.cat([S["o_p"].T, S["d_p"].T, S["tmin_p"][None, :],
                              S["tmax_p"][None, :]], 0).contiguous(),
        sub_boxes=sub_boxes.contiguous(), inst_rows=intersector.inst_rows,
        woop_t=intersector.library.woop_t, n_blocks=nb)


def instanced_raster_query(intersector, o, d, t_min, t_max,
                           mode: str = "origin", point=None,
                           any_hit: bool = False, block_rays: int = 1024,
                           pc_max: int | None = None):
    """Nearest-hit (or occlusion) TLAS query for a common-point wave via
    pair binning and kernel D.

    ``intersector`` is an ``ops/instanced.InstancedMarchIntersector`` (its
    refit pair state is the binning input).  Rays in caller order; blocks
    are consecutive runs of ``block_rays`` (screen-tile layout).  Returns
    (t, slot, u, v, ok): slot = TLAS pair * CHUNK + row (-1 miss); ``ok``
    (a Python bool, one host read) is False on a schedule overflow, and
    then the other results are not valid."""
    W = block_rays
    n = o.shape[0]
    nb = -(-n // W)
    pc_max = pc_max or default_instanced_pc_max(
        nb, intersector.pair_min.shape[0])
    S = instanced_coarse_stage(intersector.pair_min, intersector.pair_max,
                               o, d, t_min, t_max, mode, point, W, pc_max)
    ok = int(S["pc_total"]) <= pc_max
    dev = o.device
    if not ok:
        zero = torch.zeros(n, device=dev)
        return (torch.full((n,), INF, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev),
                zero, zero, False)
    # "origin" rays all start at ``point``: their o-projections are shared
    # per tile ("target" waves keep full width; occlusion callers flip
    # them to "origin" upstream, InstancedMarchIntersector.intersect_from)
    common = "origin" if mode == "origin" else None
    t, slot, u, v = (x.reshape(-1)[:n] for x in raster_instanced_call(
        **instanced_schedule_inputs(intersector, S), w=W, any_hit=any_hit,
        common=common))
    touched = (S["cnt_b"] > 0)[:, None].expand(nb, W).reshape(-1)[:n]
    miss = (slot < 0) | ~touched
    zero = torch.zeros_like(t)
    return (torch.where(miss, torch.full_like(t, INF), t),
            torch.where(miss, torch.full_like(slot, -1), slot),
            torch.where(miss, zero, u), torch.where(miss, zero, v), True)


def measure_instanced_pair_count(intersector, o, d, t_min, t_max,
                                 mode: str = "origin", point=None,
                                 block_rays: int = 1024) -> int:
    """The exact pair count the binning enumerates for this wave (for
    calibrating ``pc_max`` per scene and wave kind, as
    ``ops/raster.measure_pair_count`` does for clusters)."""
    S = instanced_coarse_stage(intersector.pair_min, intersector.pair_max,
                               o, d, t_min, t_max, mode, point, block_rays, 8)
    return int(S["pc_total"])
