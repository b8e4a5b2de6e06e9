"""Tile-raster kernels (port of
``optix_ray_tracer_tpu/ops/pallas/tile_raster.py``).

Kernel A (``raster_cluster_call``) runs a binned (ray tile, cluster
window) pair schedule from ``ops/raster.py``: each tile tests its pairs in
schedule order (near to far), gating every window part on its sub box,
and keeps best t / slot / u / v per ray.  Kernel D
(``raster_instanced_call``) runs a (ray tile, TLAS pair) schedule from
``ops/raster_instanced.py`` the same way, moving the tile's rays into each
pair's instance space before the Woop test.  CUDA in
``csrc/tile_raster.cu`` (design notes there): each warp walks its tile's
pairs for 32 of the tile's rays and gates on a warp vote.  For CPU tensors
the wrappers run the plain PyTorch versions below, which walk the same
pairs in the same order with the same gates over the same groups of rays,
so they agree bit for bit, the count of Woop-tested rows included.

A warp's rays are 32 consecutive rays of a tile: in a camera wave in
``ops/raster.to_tiles`` order, an 8-wide, 4-tall pixel block.
``_raster_plain`` also gates on other group sizes (1: each ray alone; w:
the whole tile, the CTA-wide gate of the kernels' first design), for the
counts the kernels are measured against.  :func:`needed_raster_work`
counts the work a wave's answers require of either kernel over its
schedule, the yardstick of their bounds.

Dropped TPU-only features: the packed pair encoding and its SMEM
capacity cap, the slot carried as f32, and the bf16 measurement arm.
"""

from __future__ import annotations

import ctypes

import torch

from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels.block_march import (
    instance_dirs, instance_points, inv_dir, slab_entry, woop_dots,
    woop_hit,
)
from optix_ray_tracer_tpu_torch.ops.sweep import CHUNK
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

GROUP_TRIS = 8    # binning granularity of the schedule's rects
WARP = 32         # rays per gate group of the kernels
MAX_SUBS = 4      # sub boxes per window the kernels take


def _tile_schedule(pair_tiles, pair_clusters, n_blocks: int):
    """(pair ids, per-tile offsets (n_blocks + 1,)) as the kernel takes
    them: tile b owns pairs [tile_start[b], tile_start[b + 1])."""
    keys = torch.arange(n_blocks + 1, device=pair_tiles.device,
                        dtype=pair_tiles.dtype)
    tile_start = torch.searchsorted(pair_tiles.contiguous(), keys)
    return (pair_clusters.to(torch.int32).contiguous(),
            tile_start.to(torch.int32))


def raster_cluster_plain(pair_tiles, pair_clusters, rays_t_ext, sub_boxes,
                         woop_t, n_blocks: int, w: int = 1024,
                         any_hit: bool = False, n_subs: int = 4,
                         common: str | None = None, granularity: int = 1,
                         visits: bool = False):
    """Plain version of kernel A (the arguments and results of
    :func:`raster_cluster_call`): the same pairs in the same order, each
    part gated per warp of 32 consecutive rays, vectorised over warps."""
    out = _raster_plain(dict(
        pair_tiles=pair_tiles, pair_clusters=pair_clusters,
        rays_t_ext=rays_t_ext, sub_boxes=sub_boxes, woop_t=woop_t,
        n_blocks=n_blocks, n_subs=n_subs, granularity=granularity),
        w, any_hit, common)
    return out if visits else out[:4]


def raster_instanced_plain(pair_tiles, pair_libs, pair_ids, pair_insts,
                           rays_t_ext, sub_boxes, inst_rows, woop_t,
                           n_blocks: int, w: int = 1024,
                           any_hit: bool = False,
                           common: str | None = None, visits: bool = False):
    """Plain version of kernel D (the arguments and results of
    :func:`raster_instanced_call`), gated as :func:`raster_cluster_plain`."""
    out = _raster_plain(dict(
        pair_tiles=pair_tiles, pair_libs=pair_libs, pair_ids=pair_ids,
        pair_insts=pair_insts, rays_t_ext=rays_t_ext, sub_boxes=sub_boxes,
        inst_rows=inst_rows, woop_t=woop_t, n_blocks=n_blocks),
        w, any_hit, common)
    return out if visits else out[:4]


def _raster_plain(inp: dict, w: int, any_hit: bool, common: str | None,
                  group: int = WARP):
    """Kernels A and D in plain PyTorch over the schedule ``inp`` (the
    :func:`raster_cluster_call` or :func:`raster_instanced_call` arguments;
    D when it holds ``pair_insts``).  Entry p of tile b gates on its pair's
    sub boxes, tests its window (A: ``pair_clusters[p]`` = cluster * g +
    sub; D: library cluster ``pair_libs[p]``, the tile's rays first moved
    by the affine row ``inst_rows[pair_insts[p]]``) and writes slot
    box * CHUNK/g + row (box: the window, or D's TLAS pair
    ``pair_ids[p]``).  A part is tested for a group of ``group``
    consecutive rays of a tile when one of them enters its sub box before
    its best t: WARP, the kernels' warps; 1 gates each ray alone and w the
    whole tile (the CTA-wide gate of the kernels' first design), for the
    counts the kernels are measured against.  Returns (t, slot, u, v)
    (n_blocks, w) and the Woop-tested rows per group, (n_blocks * w //
    group,) int32."""
    if w % group:
        raise ValueError(f"group={group} must divide w={w}")
    n_blocks = inp["n_blocks"]
    sub_boxes, woop_t = inp["sub_boxes"], inp["woop_t"]
    rays = inp["rays_t_ext"]
    if "pair_insts" in inp:
        win_ids, tile_start = _tile_schedule(inp["pair_tiles"],
                                             inp["pair_libs"], n_blocks)
        box_ids = inp["pair_ids"].to(torch.int32)
        inst_ids = inp["pair_insts"].to(torch.int32)
        inst_rows = inp["inst_rows"]
        n_subs, granularity = sub_boxes.shape[1], 1
    else:
        win_ids, tile_start = _tile_schedule(inp["pair_tiles"],
                                             inp["pair_clusters"], n_blocks)
        box_ids, inst_ids, inst_rows = win_ids, None, None
        n_subs, granularity = inp["n_subs"], inp["granularity"]
    common_origin = common == "origin"
    dev = rays.device
    nw = n_blocks * w
    per = w // group                   # groups per tile
    ng = n_blocks * per

    def grouped(x):
        """(nw, ...) -> (ng, group, ...)."""
        return x.reshape((ng, group) + x.shape[1:])

    o = grouped(rays[0:3, :nw].T)
    d = grouped(rays[3:6, :nw].T)
    inv = inv_dir(d)
    tmin = grouped(rays[6, :nw])
    bt = grouped(rays[7, :nw]).clone()
    # a common origin's o-projections come from the tile's first ray
    o_first = rays[0:3, 0:nw:w].T.repeat_interleave(per, 0)[:, None]
    slot = torch.full((ng, group), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((ng, group), device=dev)
    v = torch.zeros((ng, group), device=dev)
    rows = torch.zeros(ng, dtype=torch.int64, device=dev)
    ct = CHUNK // granularity
    step = ct // n_subs
    tile = torch.arange(ng, device=dev) // per
    start = tile_start[:-1].long()[tile]
    cnt = (tile_start[1:] - tile_start[:-1]).long()[tile]
    cols = torch.arange(step, device=dev)
    k12 = torch.arange(12, device=dev)[None, :, None]
    for k in range(int(cnt.max()) if ng else 0):
        tl = torch.nonzero(cnt > k)[:, 0]      # groups with a k-th pair
        entry = start[tl] + k
        box = box_ids[entry].long()
        sb = sub_boxes[box]                               # (T, n_subs, 8)

        def part_entry(part, tl=tl, sb=sb):
            return slab_entry(sb[:, None, part, 0:3], sb[:, None, part, 3:6],
                              o[tl], inv[tl], tmin[tl])

        live = torch.zeros_like(bt[tl], dtype=torch.bool)
        for part in range(n_subs):
            live |= part_entry(part) < bt[tl]
        keep = live.any(1)
        tl, entry, box, sb = tl[keep], entry[keep], box[keep], sb[keep]
        if tl.numel() == 0:
            continue
        win = win_ids[entry].long()
        c = win // granularity
        col0 = (win % granularity) * ct
        rows_i = (None if inst_ids is None
                  else inst_rows[inst_ids[entry].long()][:, None, :])
        for part in range(n_subs):
            gate = (part_entry(part, tl, sb) < bt[tl]).any(1)
            tp = tl[gate]
            if tp.numel() == 0:
                continue
            rows[tp] += step
            col = (col0[gate] + part * step)[:, None] + cols   # (T', step)
            wp = woop_t[c[gate][:, None, None], k12, col[:, None, :]]
            o_t = o_first[tp] if common_origin else o[tp]
            d_t = d[tp]
            if rows_i is not None:
                o_t = instance_points(rows_i[gate], o_t)
                d_t = instance_dirs(rows_i[gate], d_t)
            t, uu, vv, dz_ok = woop_hit(*torch.broadcast_tensors(
                *woop_dots(wp, o_t, d_t)))
            b_cur = bt[tp][..., None]
            ok = (dz_ok & (uu >= 0.0) & (vv >= 0.0)
                  & (1.0 - (uu + vv) >= 0.0) & (t > tmin[tp][..., None])
                  & (t < b_cur))
            base = (box[gate] * ct + part * step)[:, None]
            if any_hit:
                hit = ok.any(-1)
                first = torch.argmax(ok.to(torch.int8), dim=-1)
                s_new = (base + first).to(torch.int32)
                slot[tp] = torch.where(hit, s_new, slot[tp])
                bt[tp] = torch.where(hit, torch.full_like(bt[tp], -INF),
                                     bt[tp])
                continue
            t = torch.where(ok, t, torch.full_like(t, INF))
            li = torch.argmin(t, dim=-1)
            tb = torch.gather(t, 2, li[..., None])[..., 0]
            closer = tb < b_cur[..., 0]
            slot[tp] = torch.where(closer, (base + li).to(torch.int32),
                                   slot[tp])
            bt[tp] = torch.where(closer, tb, bt[tp])
            u[tp] = torch.where(closer, torch.gather(uu, 2, li[..., None])
                                [..., 0], u[tp])
            v[tp] = torch.where(closer, torch.gather(vv, 2, li[..., None])
                                [..., 0], v[tp])
    return (*(x.reshape(n_blocks, w) for x in (bt, slot, u, v)),
            rows.to(torch.int32))


def needed_raster_work(inp: dict, w: int, t, slot,
                       chunk: int = 1 << 22) -> dict:
    """The work a raster wave's answers require of kernel A or D over the
    schedule ``inp`` (the :func:`raster_cluster_call` or
    :func:`raster_instanced_call` arguments; D when it holds
    ``pair_insts``) with blocks of ``w`` rays, given each ray's nearest
    hit ``t``, ``slot`` ((n_blocks, w) or flat; slot -1 on a miss; for an
    occlusion wave its nearest hit within the segment, an upper
    estimate).  Per (ray, scheduled pair of its tile): the n_subs sub-box
    tests; for D one ray transform where some part is needed; and the
    part's Woop rows for each part the ray enters at or before its final
    t (before its t_max on a miss).  Plain PyTorch on the wave's device,
    ``chunk`` (ray, part) entries at a time.

    Returns Python ints ``slab``, ``inst``, ``woop``."""
    instanced = "pair_insts" in inp
    sub_boxes = inp["sub_boxes"]
    n_subs = sub_boxes.shape[1]
    g = 1 if instanced else inp["granularity"]
    step = CHUNK // g // n_subs
    nb = inp["n_blocks"]
    rays = inp["rays_t_ext"][:, :nb * w]
    o = rays[0:3].T.reshape(nb, w, 3)
    inv = inv_dir(rays[3:6].T).reshape(nb, w, 3)
    tmin = rays[6].reshape(nb, w)
    t, slot = t.reshape(nb, w), slot.reshape(nb, w)
    reach = torch.where(slot >= 0, torch.nextafter(
        t, torch.full_like(t, float("inf"))), rays[7].reshape(nb, w))
    real = inp["pair_tiles"] < nb
    tiles = inp["pair_tiles"][real].long()
    boxes = (inp["pair_ids"] if instanced else inp["pair_clusters"])[real]
    work = dict(slab=tiles.numel() * w * n_subs, inst=0, woop=0)
    per = max(1, chunk // (w * n_subs))
    for p0 in range(0, tiles.numel(), per):
        tl = tiles[p0:p0 + per]
        sb = sub_boxes[boxes[p0:p0 + per].long()]        # (P, n_subs, 8)
        ent = slab_entry(sb[:, None, :, 0:3], sb[:, None, :, 3:6],
                         o[tl][:, :, None], inv[tl][:, :, None],
                         tmin[tl][:, :, None])          # (P, w, n_subs)
        need = ent < reach[tl][:, :, None]
        work["woop"] += int(need.sum()) * step
        if instanced:
            work["inst"] += int(need.any(-1).sum())
    return work


def raster_cluster_call(pair_tiles, pair_clusters, rays_t_ext, sub_boxes,
                        woop_t, n_blocks: int, w: int = 1024,
                        any_hit: bool = False, n_subs: int = 4,
                        common: str | None = None, granularity: int = 1,
                        visits: bool = False):
    """Kernel A over a pair schedule.

    pair_tiles / pair_clusters: (NP,) int32, real pairs first, grouped by
        tile ascending (near to far within a tile), padding pairs with tile
        == n_blocks; a pair id is ``cluster * granularity + sub``;
    rays_t_ext: (8, (n_blocks + 1) * w) rays [o, d, t_min, t_max] in tile
        order (one trailing dead block, the JAX layout);
    sub_boxes: (C * granularity, n_subs, 8) per-pair sub-box rows;
    woop_t: (C, 16, CHUNK), the marcher's array: window ``sub`` of a
        cluster is its columns [sub * CHUNK/g, (sub + 1) * CHUNK/g).
    ``common="origin"``: every ray of a tile starts at the tile's first
        ray's origin, whose Woop o-projections are computed once.

    Returns (t, slot, u, v), each (n_blocks, w): best t (t_max where
    nothing hit; -INF for any-hit hits), slot into the sorted triangles
    (-1 miss), barycentrics of the winner; with ``visits`` also the
    Woop-tested rows of each warp of 32 rays, (n_blocks * w // 32,)
    int32."""
    if common not in (None, "origin"):
        raise ValueError(f"common={common!r}: only None and 'origin'")
    dev = rays_t_ext.device
    if CHUNK % granularity or (CHUNK // granularity) % n_subs:
        raise ValueError(f"granularity {granularity} / n_subs {n_subs} "
                         f"must divide CHUNK={CHUNK}")
    if not rays_t_ext.is_cuda:
        return raster_cluster_plain(pair_tiles, pair_clusters, rays_t_ext,
                                    sub_boxes, woop_t, n_blocks, w, any_hit,
                                    n_subs, common, granularity, visits)
    pair_ids, tile_start = _tile_schedule(pair_tiles, pair_clusters,
                                          n_blocks)
    stride = _check_raster(rays_t_ext, sub_boxes, woop_t, n_subs, n_blocks,
                           w, CHUNK // granularity)
    _lib.check(pair_ids, "pair_clusters", torch.int32, dev)
    if sub_boxes.shape[0] != woop_t.shape[0] * granularity:
        raise ValueError("sub_boxes must hold one row block per window")
    out = _raster_outputs(n_blocks, w, dev, visits)
    if n_blocks:
        _lib.TILE_RASTER(
            dev, pair_ids.data_ptr(), tile_start.data_ptr(),
            rays_t_ext.data_ptr(), stride, sub_boxes.data_ptr(), n_subs,
            woop_t.data_ptr(), granularity, n_blocks, w, int(any_hit),
            int(common == "origin"),
            *(x.data_ptr() for x in out[:4]),
            out[4].data_ptr() if visits else None)
    return out


def _check_raster(rays_t_ext, sub_boxes, woop_t, n_subs: int, n_blocks: int,
                  w: int, window: int) -> int:
    """Validate a raster schedule's rays and tables for the card (windows
    of ``window`` rows); returns the ray stride."""
    dev = rays_t_ext.device
    if w % WARP or not WARP <= w <= 1024:
        raise ValueError(f"w={w}: need a multiple of {WARP} in "
                         f"[{WARP}, 1024]")
    if n_subs > MAX_SUBS or window % n_subs or window // n_subs % WARP:
        raise ValueError(f"{n_subs} parts of a {window}-row window: need at "
                         f"most {MAX_SUBS} parts of a multiple of {WARP} "
                         f"rows")
    stride = rays_t_ext.shape[1]
    if stride < n_blocks * w:
        raise ValueError("rays_t_ext holds fewer than n_blocks * w rays")
    _lib.check(rays_t_ext, "rays_t_ext", torch.float32, dev, (8, stride))
    _lib.check(sub_boxes, "sub_boxes", torch.float32, dev, (-1, n_subs, 8))
    _lib.check(woop_t, "woop_t", torch.float32, dev, (-1, 16, CHUNK))
    return stride


def _raster_outputs(n_blocks: int, w: int, dev, visits: bool):
    out_t = torch.empty((n_blocks, w), dtype=torch.float32, device=dev)
    out = (out_t, torch.empty((n_blocks, w), dtype=torch.int32, device=dev),
           torch.empty_like(out_t), torch.empty_like(out_t))
    if visits:
        out += (torch.empty(n_blocks * w // WARP, dtype=torch.int32,
                            device=dev),)
    return out


def raster_occupancy(instanced: bool = False, any_hit: bool = False,
                     common: str | None = "origin") -> int:
    """Resident warps per SM of kernel A (D with ``instanced``) in the
    given variant on the current CUDA device: the runtime's occupancy
    number for its 4-warp CTAs (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = _lib.load().ort_tile_raster_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    err = fn(int(instanced), int(any_hit), int(common == "origin"),
             ctypes.byref(warps))
    if err:
        raise RuntimeError(f"occupancy query failed with CUDA error {err}")
    return warps.value


def raster_instanced_call(pair_tiles, pair_libs, pair_ids, pair_insts,
                          rays_t_ext, sub_boxes, inst_rows, woop_t,
                          n_blocks: int, w: int = 1024,
                          any_hit: bool = False, common: str | None = None,
                          visits: bool = False):
    """Kernel D, the TLAS raster, over a (ray tile, TLAS pair) schedule.

    pair_tiles: (NP,) int32 schedule tiles as :func:`raster_cluster_call`
        (real entries grouped by tile near to far, padding -> n_blocks);
    pair_libs: (NP,) int32 LIBRARY cluster of each entry (its Woop rows);
    pair_ids: (NP,) int32 TLAS pair of each entry (its world sub boxes,
        and the slot base: slot = pair * CHUNK + row);
    pair_insts: (NP,) int32 instance of each entry (its affine row);
    rays_t_ext: (8, (n_blocks + 1) * w) WORLD rays in tile order;
    sub_boxes: (Cp, n_subs, 8) world sub boxes per pair (refit per frame);
    inst_rows: (P, 128) rows [A(9), b(3), 0...] of o' = A (o - b);
    woop_t: (SC, 16, CHUNK) object-space library rows.

    Returns (t, slot, u, v), each (n_blocks, w), and with ``visits`` the
    Woop-tested rows per warp, as :func:`raster_cluster_call`."""
    if common not in (None, "origin"):
        raise ValueError(f"common={common!r}: only None and 'origin'")
    dev = rays_t_ext.device
    if not rays_t_ext.is_cuda:
        return raster_instanced_plain(pair_tiles, pair_libs, pair_ids,
                                      pair_insts, rays_t_ext, sub_boxes,
                                      inst_rows, woop_t, n_blocks, w,
                                      any_hit, common, visits)
    libs, tile_start = _tile_schedule(pair_tiles, pair_libs, n_blocks)
    n_subs = sub_boxes.shape[1]
    stride = _check_raster(rays_t_ext, sub_boxes, woop_t, n_subs, n_blocks,
                           w, CHUNK)
    ids = pair_ids.to(torch.int32).contiguous()
    insts = pair_insts.to(torch.int32).contiguous()
    for name, x in (("pair_libs", libs), ("pair_ids", ids),
                    ("pair_insts", insts)):
        _lib.check(x, name, torch.int32, dev, (pair_tiles.shape[0],))
    _lib.check(inst_rows, "inst_rows", torch.float32, dev, (-1, 128))
    out = _raster_outputs(n_blocks, w, dev, visits)
    if n_blocks:
        _lib.TILE_RASTER_INSTANCED(
            dev, libs.data_ptr(), ids.data_ptr(), insts.data_ptr(),
            tile_start.data_ptr(), rays_t_ext.data_ptr(), stride,
            sub_boxes.data_ptr(), n_subs, inst_rows.data_ptr(),
            woop_t.data_ptr(), n_blocks, w, int(any_hit),
            int(common == "origin"), *(x.data_ptr() for x in out[:4]),
            out[4].data_ptr() if visits else None)
    return out
