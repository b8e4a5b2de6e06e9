"""TLAS-pair raster binning: the tile-raster engine at INSTANCE granularity
(port of ``optix_ray_tracer_tpu/ops/raster_instanced.py``).

Common-point TLAS waves (camera primaries, point-light shadows) and
common-direction ones (ortho / sun shadows) are binned as
``ops/raster.py`` bins clusters, but over TLAS pairs:

* each pair's WORLD box (refit per frame by
  ``ops/instanced.refit_instanced``) projects to a rect and a depth
  interval through its 8 corners;
* ray blocks get the cluster path's rects (kernel T,
  ``ops/kernels/binning``);
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

from optix_ray_tracer_tpu_torch.ops.kernels import binning
from optix_ray_tracer_tpu_torch.ops.kernels.tile_raster import (
    raster_instanced_call,
)
from optix_ray_tracer_tpu_torch.ops.raster import MODES, _schedule, _target
from optix_ray_tracer_tpu_torch.ops.sweep import SUBS_PER_CLUSTER
from optix_ray_tracer_tpu_torch.utils.vecmath import INF


def default_instanced_pc_max(n_blocks: int, n_pairs: int) -> int:
    """Schedule capacity heuristic: coherent blocks overlap few instances;
    an overflow falls back to the marcher (a cost bound, not a correctness
    bound)."""
    pc = 12 * n_blocks + 2 * n_pairs + 1024
    return ((pc + 1023) // 1024) * 1024


def instanced_coarse_stage(pair_min, pair_max, o, d, t_min, t_max,
                           mode: str, point, W: int, pc_max: int,
                           pair_shape=None, pair_inst=None) -> dict:
    """Pair-granularity analog of ``ops/raster._coarse_stage``: pair rects
    from world box corners (kernel S, each pair projected through its 8
    corners and margined once; NaN boxes give NaN rects that never
    overlap), the shared block rects, and the depth-sorted (block, pair)
    enumeration.  With the pairs' ``pair_shape`` and ``pair_inst``, the
    schedule also holds kernel D's pair_libs and pair_insts."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    # S's projection axis: the finite pair centers' centroid seen from the
    # shared point (geometry, not the wave, decides it), or d[0] ("ortho")
    rects, cfull, basis = binning.bin_rects(
        binning.RECTS_PAIR, pair_min, pair_max,
        point=None if mode == "ortho" else point, d=d)
    tables = None if pair_shape is None else (pair_shape, pair_inst)
    return _schedule(o, d, t_min, t_max, W, pc_max, mode, rects, cfull,
                     basis, _target(point, mode, o.device), tables=tables)


def instanced_schedule_inputs(intersector, S: dict) -> dict:
    """The ``raster_instanced_call`` arguments (all but ``w``, ``any_hit``
    and ``common``) for a schedule ``S`` from
    :func:`instanced_coarse_stage` over ``intersector``'s pairs, given
    their ``pair_shape`` and ``pair_inst``."""
    nb = S["nb"]
    Cp = intersector.pair_min.shape[0]
    dev = S["validc"].device
    sub_boxes = torch.cat([
        intersector.sub_min.reshape(Cp, SUBS_PER_CLUSTER, 3),
        intersector.sub_max.reshape(Cp, SUBS_PER_CLUSTER, 3),
        torch.zeros((Cp, SUBS_PER_CLUSTER, 2), device=dev)], 2)
    return dict(
        pair_tiles=S["pair_tiles"], pair_libs=S["pair_libs"],
        pair_ids=S["pair_clusters"], pair_insts=S["pair_insts"],
        rays_t_ext=S["rays_t_ext"],
        sub_boxes=sub_boxes.contiguous(), inst_rows=intersector.inst_rows,
        woop_t=intersector.library.woop_t, n_blocks=nb)


def instanced_raster_query(intersector, o, d, t_min, t_max,
                           mode: str = "origin", point=None,
                           any_hit: bool = False, block_rays: int = 1024,
                           pc_max: int | None = None):
    """Nearest-hit (or occlusion) TLAS query for a common-point or
    common-direction wave via pair binning and kernel D.

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
                               o, d, t_min, t_max, mode, point, W, pc_max,
                               intersector.pair_shape, intersector.pair_inst)
    ok = int(S["pc_total"]) <= pc_max
    dev = o.device
    if not ok:
        zero = torch.zeros(n, device=dev)
        return (torch.full((n,), INF, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev),
                zero, zero, False)
    # "origin" rays all start at ``point``: their o-projections are shared
    # per tile; "ortho" rays share d, and so their d-projections ("target"
    # waves keep full width; occlusion callers flip them to "origin"
    # upstream, InstancedMarchIntersector.intersect_from)
    common = {"origin": "origin", "ortho": "dir", "target": None}[mode]
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
