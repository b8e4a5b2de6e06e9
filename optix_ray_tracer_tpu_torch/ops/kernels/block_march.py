"""Block marchers and cluster probe (port of
``optix_ray_tracer_tpu/ops/pallas/block_march.py``).

Kernel B (``march_call``) answers a nearest-hit or occlusion query for
blocks of rays over a ClusterSet; kernel F (``march_hier_call``) does the
same over 8-cluster superclusters, for coherent waves of large scenes;
kernel E (``march_instanced_call``) over the (instance, library cluster)
pairs of a TLAS; kernel C (``probe_call``) returns each ray's nearest
entered cluster, the sort key of incoherent waves.  Past MAX_CLUSTERS
clusters every wave goes to the deep kernels, which cull on one more
level, 64-cluster hyperclusters: F2 (``march_deep_call``) marches, C2
(``probe_call``'s deep route) probes, up to MAX_DEEP_CLUSTERS.  All are CUDA
(``csrc/block_march.cu``, design notes there: B, E and F march per warp
of 32 rays, F with superclusters as its cull rows, C per warp of packed
live rays over superclusters; the third output of B, E and F counts each
warp's Woop-tested rows, shape (R / 32,)).  Each wrapper launches its kernel for CUDA tensors, or
raises; for CPU tensors it runs the plain PyTorch version
beside it, a vectorised loop over cull rows that computes the same
function: the exact nearest t (or hit / miss), with equal-t ties free to
resolve to another triangle.  :func:`needed_work` counts the work a
wave's answer requires of any exact marcher of this structure, and
:func:`needed_probe_work` what its probe answers require: the yardsticks
of the kernels' bounds.
"""

from __future__ import annotations

import ctypes

import torch

from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.sweep import CHUNK, SUBS_PER_CLUSTER
from optix_ray_tracer_tpu_torch.utils.tensors import nanmax, nanmin
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot

BLOCK_RAYS = 128          # minimum block granularity callers pad to
CLUSTER_TRIS = CHUNK
#: B, C and F take scenes up to this many clusters (C stages its
#: superclusters in 32 KB); past it the deep kernels F2 and C2 take every
#: wave, up to MAX_DEEP_CLUSTERS (C2 stages 1,024 hyperclusters in 32 KB)
MAX_CLUSTERS = 8192
MAX_DEEP_CLUSTERS = 65536
WARP = 32                 # B, E and F count their work per warp of rays
N_SUBS = SUBS_PER_CLUSTER
N_SUBS_INCOHERENT = 2     # incoherent waves pair-merge the sub boxes
GROUP = 8                 # clusters per supercluster (kernel F)
#: coherent waves of at least this many clusters go to kernel F (the JAX
#: package's TPU-measured crossover, kept for parity; the card's own
#: crossover is not measured yet)
HIER_MIN_CLUSTERS = 3072


def choose_block_rays(n_clusters: int, coherent: bool = True) -> int:
    """Block width by wave coherence (the JAX package's TPU-measured
    choice, kept as the starting point: coherent waves share their cluster
    set, so wide blocks amortize per-visit work; incoherent ones don't)."""
    if not coherent:
        return BLOCK_RAYS
    c_pad = ((n_clusters + 7) // 8) * 8
    for w in (512, 256):
        if c_pad * w * 4 <= 3 * 1024 * 1024:
            return w
    return BLOCK_RAYS


def inv_dir(d):
    """1/d where |d| > 1e-12, else +1e12 whatever the sign."""
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                       torch.full_like(d, 1e12))


def slab_entry(bmin, bmax, o, inv_d, tmin):
    """Slab entry of boxes [bmin, bmax] (..., 3) for rays (..., 3): entry t,
    or INF where missed.  NaN (padding) boxes propagate NaN through
    minimum/maximum and never fire."""
    ent = torch.full(torch.broadcast_shapes(bmin.shape[:-1], o.shape[:-1]),
                     -INF, device=o.device)
    ext = torch.full_like(ent, INF)
    for ax in range(3):
        t0 = (bmin[..., ax] - o[..., ax]) * inv_d[..., ax]
        t1 = (bmax[..., ax] - o[..., ax]) * inv_d[..., ax]
        ent = torch.maximum(ent, torch.minimum(t0, t1))
        ext = torch.minimum(ext, torch.maximum(t0, t1))
    ent = torch.maximum(ent, tmin)
    return torch.where(ent <= ext, ent, torch.full_like(ent, INF))


def woop_dots(w, o, d):
    """Ray x triangle Woop projections, in the kernels' operation order.

    w: (..., 12, T) woop_t rows; o, d: (..., R, 3).  Returns
    (opx, opy, opz, dpx, dpy, dpz), each (..., R, T)."""
    def row(k):
        return w[..., k, None, :]

    def comp(x, k):
        return x[..., :, k, None]

    ox, oy, oz = comp(o, 0), comp(o, 1), comp(o, 2)
    dx, dy, dz = comp(d, 0), comp(d, 1), comp(d, 2)
    ops = tuple(((row(4 * i) * ox + row(4 * i + 1) * oy)
                 + row(4 * i + 2) * oz) - row(4 * i + 3) for i in range(3))
    dps = tuple((row(4 * i) * dx + row(4 * i + 1) * dy)
                + row(4 * i + 2) * dz for i in range(3))
    return ops + dps


def woop_hit(opx, opy, opz, dpx, dpy, dpz):
    """(t, uu, vv, dz_ok) from the Woop projections."""
    dz_ok = torch.abs(dpz) > 1e-12
    t = (-opz) / torch.where(dz_ok, dpz, torch.full_like(dpz, 1e-12))
    return t, opx + t * dpx, opy + t * dpy, dz_ok


def instance_points(rows, p):
    """World points -> instance space, A (p - b), for affine rows [A (3x3
    row-major), b, ...] (one row for every point, or one per point),
    summed left to right as the kernels sum them (ort_to_instance)."""
    return _apply_rows(rows, *(p[..., k] - rows[..., 9 + k]
                               for k in range(3)))


def instance_dirs(rows, d):
    """World directions -> instance space, A d (left unnormalised)."""
    return _apply_rows(rows, d[..., 0], d[..., 1], d[..., 2])


def _apply_rows(rows, x, y, z):
    return torch.stack([(rows[..., 3 * k] * x + rows[..., 3 * k + 1] * y)
                        + rows[..., 3 * k + 2] * z for k in range(3)], -1)


def _unpack(rays):
    """(o, d, t_min, best t, 1/d, slot) of an (8, R) ray block."""
    o = rays[0:3].T
    d = rays[3:6].T
    tmin = rays[6]
    return (o, d, tmin, rays[7].clone(), inv_dir(d),
            torch.full_like(tmin, -1, dtype=torch.int32))


def _enter(box, o, inv, tmin, bt, idx):
    """The rays of ``idx`` whose entry into ``box`` (8,) is < their best
    t."""
    return idx[slab_entry(box[0:3], box[3:6], o[idx], inv[idx], tmin[idx])
               < bt[idx]]


def _visit(o, d, inv, tmin, bt, slot, idx, c, sub_boxes, n_subs, ws_c,
           any_hit: bool, rows=None):
    """One visit of the plain marchers to cull row ``c`` for the rays
    ``idx`` that enter its box: each part gated per ray on its sub box,
    then Woop-tested against ``ws_c`` (12, CHUNK), the rays moved by the
    affine ``rows`` first where given; slot = c * CHUNK + row."""
    step = CLUSTER_TRIS // n_subs
    if idx.numel() == 0:
        return
    sb = sub_boxes[c, :, None, :]                # (n_subs, 1, 8)
    ent = slab_entry(sb[..., 0:3], sb[..., 3:6], o[idx], inv[idx],
                     tmin[idx])                  # (n_subs, len(idx))
    for part in range(n_subs):
        live = idx[ent[part] < bt[idx]]          # gated on the current t
        if live.numel() == 0:
            continue
        ol, dl = o[live], d[live]
        if rows is not None:
            ol, dl = instance_points(rows, ol), instance_dirs(rows, dl)
        ws = ws_c[:, part * step:(part + 1) * step]
        t, uu, vv, dz_ok = woop_hit(*woop_dots(ws, ol, dl))
        bl = bt[live, None]
        ok = (dz_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (t > tmin[live, None]) & (t < bl))
        t = torch.where(ok, t, torch.full_like(t, INF))
        li = torch.argmin(t, dim=1)
        tb = torch.gather(t, 1, li[:, None])[:, 0]
        closer = tb < bl[:, 0]
        hit = live[closer]
        slot[hit] = (c * CLUSTER_TRIS + part * step + li[closer]
                     ).to(torch.int32)
        bt[hit] = -INF if any_hit else tb[closer]


def march_plain(rays, boxes, sub_boxes, woop_t, n_clusters: int,
                n_subs: int, any_hit: bool):
    """Plain version of kernel B (same arguments as :func:`march_call`):
    clusters in id order, each ray gated on its own entries."""
    o, d, tmin, bt, inv, slot = _unpack(rays)
    every = torch.arange(o.shape[0], device=o.device)
    for c in range(n_clusters):
        idx = _enter(boxes[c], o, inv, tmin, bt, every)
        _visit(o, d, inv, tmin, bt, slot, idx, c, sub_boxes, n_subs,
               woop_t[c, :12], any_hit)
    return bt, slot


def march_instanced_plain(rays, boxes, sub_boxes, pair_shape, pair_inst,
                          inst_rows, woop_t, n_pairs: int, any_hit: bool):
    """Plain version of kernel E (same arguments as
    :func:`march_instanced_call`): pairs in id order."""
    o, d, tmin, bt, inv, slot = _unpack(rays)
    every = torch.arange(o.shape[0], device=o.device)
    shapes = pair_shape[:n_pairs].tolist()
    insts = pair_inst[:n_pairs].tolist()
    for c in range(n_pairs):
        idx = _enter(boxes[c], o, inv, tmin, bt, every)
        if idx.numel():
            _visit(o, d, inv, tmin, bt, slot, idx, c, sub_boxes,
                   sub_boxes.shape[1], woop_t[shapes[c], :12], any_hit,
                   rows=inst_rows[insts[c]])
    return bt, slot


def march_hier_plain(rays, sup_boxes, boxes, sub_boxes, woop_t,
                     n_clusters: int, n_subs: int, any_hit: bool):
    """Plain version of kernel F (same arguments as
    :func:`march_hier_call`): superclusters in id order, each gating its
    clusters, all per ray."""
    o, d, tmin, bt, inv, slot = _unpack(rays)
    every = torch.arange(o.shape[0], device=o.device)
    for s in range(-(-n_clusters // GROUP)):
        sidx = _enter(sup_boxes[s], o, inv, tmin, bt, every)
        for c in range(s * GROUP, min(s * GROUP + GROUP, n_clusters)):
            if sidx.numel() == 0:
                break
            idx = _enter(boxes[c], o, inv, tmin, bt, sidx)
            _visit(o, d, inv, tmin, bt, slot, idx, c, sub_boxes, n_subs,
                   woop_t[c, :12], any_hit)
    return bt, slot


def march_deep_plain(rays, hyper_boxes, sup_boxes, boxes, sub_boxes, woop_t,
                     n_clusters: int, n_subs: int, any_hit: bool):
    """Plain version of kernel F2 (same arguments as
    :func:`march_deep_call`): hyperclusters in id order, each gating its
    superclusters, each of those its clusters, all per ray."""
    o, d, tmin, bt, inv, slot = _unpack(rays)
    every = torch.arange(o.shape[0], device=o.device)
    n_sup, n_hyper = _deep_rows(n_clusters)
    for h in range(n_hyper):
        hidx = _enter(hyper_boxes[h], o, inv, tmin, bt, every)
        for s in range(h * GROUP, min(h * GROUP + GROUP, n_sup)):
            if hidx.numel() == 0:
                break
            sidx = _enter(sup_boxes[s], o, inv, tmin, bt, hidx)
            for c in range(s * GROUP, min(s * GROUP + GROUP, n_clusters)):
                if sidx.numel() == 0:
                    break
                idx = _enter(boxes[c], o, inv, tmin, bt, sidx)
                _visit(o, d, inv, tmin, bt, slot, idx, c, sub_boxes, n_subs,
                       woop_t[c, :12], any_hit)
    return bt, slot


def needed_work(rays, t, slot, boxes, sub_boxes, n_rows: int, n_subs: int,
                instanced: bool = False, sup_boxes=None) -> dict:
    """The work a wave's answers require of an exact marcher that culls
    every cull row (with ``sup_boxes``: every GROUP-cluster supercluster,
    then the clusters of those it enters) and gates parts on sub boxes,
    if it knew each ray's final t in advance: the least such a marcher
    can do.  Plain PyTorch, on the wave's device.

    rays, boxes, sub_boxes, n_rows, n_subs as :func:`march_call`; t,
    slot: each ray's nearest hit (a plain nearest-hit version's output;
    for an occlusion wave, its nearest hit within the segment), slot -1 on
    a miss.  A ray needs a box when it enters it before its t_max on a
    miss, at or before its t on a hit.

    Returns Python ints: ``slab``, the slab tests (per ray every cull row
    or supercluster, the clusters of each supercluster it needs, and
    n_subs sub boxes per cull row it needs); ``inst``, the ray transforms
    (instanced: one per needed row with a needed part); ``woop``, the
    (ray, triangle) tests (every row of every needed part)."""
    o, inv, tmin = rays[0:3].T, inv_dir(rays[3:6].T), rays[6]
    R = o.shape[0]
    reach = torch.where(slot >= 0, torch.nextafter(
        t, torch.full_like(t, float("inf"))), rays[7])
    work = dict(slab=R * n_rows, inst=0, woop=0)
    if sup_boxes is not None:
        n_sup = -(-n_rows // GROUP)
        members = torch.clamp(
            n_rows - GROUP * torch.arange(n_sup, device=o.device), max=GROUP)
        entered = _entries(sup_boxes[:n_sup], o, inv, tmin) < reach[:, None]
        work["slab"] = R * n_sup + int((entered * members).sum())
    chunk = max(1, (1 << 22) // max(1, R * n_subs))
    for c0 in range(0, n_rows, chunk):
        c1 = min(c0 + chunk, n_rows)
        need = _entries(boxes[c0:c1], o, inv, tmin) < reach[:, None]
        parts = (_entries(sub_boxes[c0:c1].reshape(-1, 8), o, inv, tmin)
                 .reshape(R, c1 - c0, n_subs) < reach[:, None, None]) \
            & need[..., None]
        work["slab"] += int(need.sum()) * n_subs
        work["woop"] += int(parts.sum()) * (CLUSTER_TRIS // n_subs)
        if instanced:
            work["inst"] += int(parts.any(-1).sum())
    return work


def _entries(box_rows, o, inv, tmin):
    """(R, n) slab entries of R rays into n box rows (n, 8)."""
    return slab_entry(box_rows[None, :, 0:3], box_rows[None, :, 3:6],
                      o[:, None], inv[:, None], tmin[:, None])


def march_call(rays, boxes, sub_boxes, woop_t, n_clusters: int,
               n_subs: int, any_hit: bool = False, w: int = BLOCK_RAYS):
    """Kernel B.  rays: (8, R) rows [o, d, t_min, t_max] with R % w == 0
    and t_max <= INF (dead lanes: t_min=1, t_max=0); boxes: (C_pad, 8);
    sub_boxes: (C_pad, n_subs, 8); woop_t: (C, 16, CHUNK).

    Returns (t, slot, visits): best t (-INF for any-hit hits), slot into
    the sorted triangles (-1 miss), and on the card, per warp of 32 rays
    (R // 32,), the Woop rows it tested, each one test on each of its
    lanes (None for the plain version).  ``w`` (on the card a multiple of
    BLOCK_RAYS, the 4-warp CTA) only pads the wave: the kernel marches each
    warp on its own."""
    if not rays.is_cuda:
        t, slot = march_plain(rays, boxes, sub_boxes, woop_t, n_clusters,
                              n_subs, any_hit)
        return t, slot, None
    dev = rays.device
    R = _check_march(rays, boxes, sub_boxes, n_clusters, n_subs, w)
    _lib.check(woop_t, "woop_t", torch.float32, dev, (-1, 16, CLUSTER_TRIS))
    if woop_t.shape[0] < n_clusters:
        raise ValueError(f"woop_t must cover {n_clusters} clusters")
    t, slot, visits = _march_outputs(R, dev)
    if R:
        _lib.BLOCK_MARCH(dev, rays.data_ptr(), R, boxes.data_ptr(),
                         n_clusters, sub_boxes.data_ptr(), n_subs,
                         woop_t.data_ptr(), int(any_hit), w, t.data_ptr(),
                         slot.data_ptr(), visits.data_ptr())
    return t, slot, visits


def _check_march(rays, boxes, sub_boxes, n_rows: int, n_subs: int,
                 w: int, cap: int = MAX_CLUSTERS) -> int:
    """Validate a march's rays and cull rows for the card (blocks of a
    multiple of BLOCK_RAYS rays, the 4-warp CTA; parts of a multiple of
    WARP rows, the warp's staged slice; at most ``cap`` rows); returns
    R."""
    dev = rays.device
    R = rays.shape[1]
    if R % w or w % BLOCK_RAYS or not BLOCK_RAYS <= w <= 1024:
        raise ValueError(f"{R} rays in blocks of {w}: need R % w == 0 and "
                         f"w a multiple of {BLOCK_RAYS} in [{BLOCK_RAYS}, "
                         f"1024]")
    if (not 0 < n_rows <= cap or CLUSTER_TRIS % n_subs
            or CLUSTER_TRIS // n_subs % WARP):
        raise ValueError(f"{n_rows} cull rows / {n_subs} sub boxes "
                         f"unsupported (max {cap} rows, parts of a "
                         f"multiple of {WARP} rows)")
    _lib.check(rays, "rays", torch.float32, dev, (8, R))
    _lib.check(boxes, "boxes", torch.float32, dev, (-1, 8))
    _lib.check(sub_boxes, "sub_boxes", torch.float32, dev, (-1, n_subs, 8))
    if boxes.shape[0] < n_rows or sub_boxes.shape[0] < n_rows:
        raise ValueError(f"boxes and sub_boxes must cover {n_rows} rows")
    return R


def _march_outputs(R: int, dev):
    """(t, slot, Woop-tested rows per warp) of a march on the card."""
    return (torch.empty(R, dtype=torch.float32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.zeros(R // WARP, dtype=torch.int32, device=dev))


def march_occupancy(instanced: bool = False, any_hit: bool = False,
                    hier: bool = False) -> int:
    """Resident warps per SM of kernel B (E with ``instanced``, F with
    ``hier``) on the current CUDA device: the runtime's occupancy number
    for its 4-warp launch (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = _lib.load().ort_march_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    kind = 2 if hier else int(instanced)     # csrc MarchKind: B 0, E 1, F 2
    err = fn(kind, int(any_hit), ctypes.byref(warps))
    if err:
        raise RuntimeError(f"occupancy query failed with CUDA error {err}")
    return warps.value


def march_instanced_call(rays, boxes, sub_boxes, pair_shape, pair_inst,
                         inst_rows, woop_t, n_pairs: int,
                         any_hit: bool = False, w: int = BLOCK_RAYS):
    """Kernel E, the TLAS march.  rays: (8, R) as :func:`march_call`;
    boxes: (>= n_pairs, 8) and sub_boxes (>= n_pairs, n_subs, 8) WORLD
    pair boxes (NaN for invalid instances and padding); pair_shape /
    pair_inst: (n_pairs,) int32 library cluster and instance of each pair;
    inst_rows: (P, 128) rows [A(9), b(3), 0...] of the world->object
    affine o' = A (o - b); woop_t: (SC, 16, CHUNK) library rows.

    Returns (t, slot, visits) as :func:`march_call` (visits per warp),
    with slot = pair * CHUNK + row."""
    if not rays.is_cuda:
        t, slot = march_instanced_plain(rays, boxes, sub_boxes, pair_shape,
                                        pair_inst, inst_rows, woop_t,
                                        n_pairs, any_hit)
        return t, slot, None
    dev = rays.device
    n_subs = sub_boxes.shape[1]
    R = _check_march(rays, boxes, sub_boxes, n_pairs, n_subs, w)
    _lib.check(woop_t, "woop_t", torch.float32, dev, (-1, 16, CLUSTER_TRIS))
    _lib.check(inst_rows, "inst_rows", torch.float32, dev, (-1, 128))
    _lib.check(pair_shape, "pair_shape", torch.int32, dev)
    _lib.check(pair_inst, "pair_inst", torch.int32, dev)
    if pair_shape.numel() < n_pairs or pair_inst.numel() < n_pairs:
        raise ValueError(f"pair_shape and pair_inst must cover {n_pairs} "
                         f"pairs")
    t, slot, visits = _march_outputs(R, dev)
    if R:
        _lib.BLOCK_MARCH_INSTANCED(
            dev, rays.data_ptr(), R, boxes.data_ptr(), n_pairs,
            sub_boxes.data_ptr(), n_subs, pair_shape.data_ptr(),
            pair_inst.data_ptr(), inst_rows.data_ptr(), woop_t.data_ptr(),
            int(any_hit), w, t.data_ptr(), slot.data_ptr(),
            visits.data_ptr())
    return t, slot, visits


def march_hier_call(rays, sup_boxes, boxes, sub_boxes, woop_t,
                    n_clusters: int, n_subs: int, any_hit: bool = False,
                    w: int = BLOCK_RAYS):
    """Kernel F, the hierarchical march.  As :func:`march_call` (visits
    per warp of 32 rays: its Woop-tested rows), plus sup_boxes:
    (>= ceil(n_clusters / GROUP), 8) NaN-aware union boxes of clusters
    [GROUP s, GROUP s + GROUP), the kernel's cull rows."""
    if not rays.is_cuda:
        t, slot = march_hier_plain(rays, sup_boxes, boxes, sub_boxes,
                                   woop_t, n_clusters, n_subs, any_hit)
        return t, slot, None
    dev = rays.device
    R = _check_march(rays, boxes, sub_boxes, n_clusters, n_subs, w)
    n_sup = -(-n_clusters // GROUP)
    _lib.check(sup_boxes, "sup_boxes", torch.float32, dev, (-1, 8))
    _lib.check(woop_t, "woop_t", torch.float32, dev, (-1, 16, CLUSTER_TRIS))
    if sup_boxes.shape[0] < n_sup or woop_t.shape[0] < n_clusters:
        raise ValueError(f"sup_boxes must cover {n_sup} superclusters and "
                         f"woop_t {n_clusters} clusters")
    t, slot, visits = _march_outputs(R, dev)
    if R:
        _lib.BLOCK_MARCH_HIER(
            dev, rays.data_ptr(), R, sup_boxes.data_ptr(), n_sup,
            boxes.data_ptr(), n_clusters, sub_boxes.data_ptr(), n_subs,
            woop_t.data_ptr(), int(any_hit), w, t.data_ptr(),
            slot.data_ptr(), visits.data_ptr())
    return t, slot, visits


def march_deep_call(rays, hyper_boxes, sup_boxes, boxes, sub_boxes, woop_t,
                    n_clusters: int, n_subs: int, any_hit: bool = False,
                    w: int = BLOCK_RAYS):
    """Kernel F2, the deep march past MAX_CLUSTERS.  As
    :func:`march_hier_call`, plus hyper_boxes: (>= ceil(n_sup / GROUP), 8)
    NaN-aware unions of superclusters [GROUP h, GROUP h + GROUP) of
    sup_boxes (:func:`deep_tables`), the kernel's cull rows.  Up to
    MAX_DEEP_CLUSTERS clusters."""
    if not rays.is_cuda:
        t, slot = march_deep_plain(rays, hyper_boxes, sup_boxes, boxes,
                                   sub_boxes, woop_t, n_clusters, n_subs,
                                   any_hit)
        return t, slot, None
    dev = rays.device
    R = _check_march(rays, boxes, sub_boxes, n_clusters, n_subs, w,
                     cap=MAX_DEEP_CLUSTERS)
    n_sup, n_hyper = _deep_rows(n_clusters)
    _lib.check(sup_boxes, "sup_boxes", torch.float32, dev, (-1, 8))
    _lib.check(hyper_boxes, "hyper_boxes", torch.float32, dev, (-1, 8))
    _lib.check(woop_t, "woop_t", torch.float32, dev, (-1, 16, CLUSTER_TRIS))
    if (sup_boxes.shape[0] < n_sup or hyper_boxes.shape[0] < n_hyper
            or woop_t.shape[0] < n_clusters):
        raise ValueError(f"sup_boxes must cover {n_sup} superclusters, "
                         f"hyper_boxes {n_hyper} hyperclusters and woop_t "
                         f"{n_clusters} clusters")
    t, slot, visits = _march_outputs(R, dev)
    if R:
        _lib.BLOCK_MARCH_DEEP(
            dev, rays.data_ptr(), R, hyper_boxes.data_ptr(), n_hyper,
            sup_boxes.data_ptr(), n_sup, boxes.data_ptr(), n_clusters,
            sub_boxes.data_ptr(), n_subs, woop_t.data_ptr(), int(any_hit),
            t.data_ptr(), slot.data_ptr(), visits.data_ptr())
    return t, slot, visits


def _deep_rows(n_clusters: int) -> tuple[int, int]:
    """(superclusters, hyperclusters) of a deep wave's tables."""
    n_sup = -(-n_clusters // GROUP)
    return n_sup, -(-n_sup // GROUP)


def deep_occupancy(probe: bool = False, any_hit: bool = False) -> int:
    """Resident warps per SM of kernel F2 (C2 with ``probe``) on the
    current CUDA device, by the runtime's occupancy number."""
    fn = _lib.load().ort_deep_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    err = fn(int(probe), int(any_hit), ctypes.byref(warps))
    if err:
        raise RuntimeError(f"occupancy query failed with CUDA error {err}")
    return warps.value


def probe_plain(rays, boxes, n_clusters: int, c_pad: int):
    """Plain version of kernel C (same arguments as :func:`probe_call`):
    every cluster box in ascending chunks, the lowest id winning ties."""
    o = rays[0:3].T[:, None, :]
    inv = inv_dir(rays[3:6].T)[:, None, :]
    tmin = rays[6][:, None]
    tmax = rays[7][:, None]
    R = rays.shape[1]
    emin = torch.full((R,), INF, device=rays.device)
    first = torch.full((R,), c_pad, dtype=torch.int64, device=rays.device)
    for c0 in range(0, n_clusters, 512):   # ascending chunks: lowest id wins
        b = boxes[c0:min(c0 + 512, n_clusters)]
        e = slab_entry(b[None, :, 0:3], b[None, :, 3:6], o, inv, tmin)
        e = torch.where(e < tmax, e, torch.full_like(e, INF))
        arg = torch.argmin(e, dim=1)
        cmin = torch.gather(e, 1, arg[:, None])[:, 0]
        better = cmin < emin
        emin = torch.where(better, cmin, emin)
        first = torch.where(better, c0 + arg, first)
    return torch.where(emin < INF, first, torch.full_like(first, c_pad)
                       ).to(torch.int32)


def probe_deep_plain(rays, boxes, sup_boxes, hyper_boxes, n_clusters: int,
                     c_pad: int):
    """Plain version of kernel C2 (``probe_call`` past MAX_CLUSTERS):
    hyperclusters, their superclusters and their clusters in ascending id
    order, each level tested per ray only where the union is entered below
    the ray's best entry and its t_max; a cluster takes the answer on a
    strictly smaller entry, so the lowest id wins ties.  Dead rays get
    c_pad."""
    R = rays.shape[1]
    dev = rays.device
    emin = torch.full((R,), INF, device=dev)
    first = torch.full((R,), c_pad, dtype=torch.int64, device=dev)
    live = torch.nonzero(probe_live(rays))[:, 0]
    o = rays[0:3, live].T
    inv = inv_dir(rays[3:6, live].T)
    tmin, tmax = rays[6, live], rays[7, live]
    em, fi = emin[live], first[live]
    n_sup, n_hyper = _deep_rows(n_clusters)

    def gate(box, idx):
        e = slab_entry(box[0:3], box[3:6], o[idx], inv[idx], tmin[idx])
        return idx[(e < em[idx]) & (e < tmax[idx])]

    every = torch.arange(live.numel(), device=dev)
    for h in range(n_hyper):
        hidx = gate(hyper_boxes[h], every)
        for s in range(h * GROUP, min(h * GROUP + GROUP, n_sup)):
            if hidx.numel() == 0:
                break
            sidx = gate(sup_boxes[s], hidx)
            for c in range(s * GROUP, min(s * GROUP + GROUP, n_clusters)):
                if sidx.numel() == 0:
                    break
                b = boxes[c]
                e = slab_entry(b[0:3], b[3:6], o[sidx], inv[sidx],
                               tmin[sidx])
                take = sidx[(e < tmax[sidx]) & (e < em[sidx])]
                em[take] = e[(e < tmax[sidx]) & (e < em[sidx])]
                fi[take] = c
    first[live] = fi
    return first.to(torch.int32)


def probe_call(rays, boxes, n_clusters: int, c_pad: int, sup_boxes=None,
               hyper_boxes=None):
    """Kernel C, or past MAX_CLUSTERS kernel C2.  rays: (8, R); boxes:
    (c_pad, 8) rows [min3, max3, 0, 0] (min <= max per axis, or NaN).  C
    pre-culls on the unions of GROUP consecutive clusters, which it forms
    as it stages them; C2 on :func:`deep_tables`' hyperclusters, then
    their superclusters (``sup_boxes``, ``hyper_boxes``: formed here where
    not given).

    Returns (ids, tests): (R,) int32, the nearest cluster each ray enters
    before t_max (lowest id on ties), else c_pad; and on the card a (1,)
    int64 count of the box tests the kernel ran (rows tested x 32 lanes
    per warp; None for the plain version)."""
    if is_deep(n_clusters):
        _check_clusters(n_clusters)
        if sup_boxes is None or hyper_boxes is None:
            sup_boxes, hyper_boxes = deep_tables(boxes)
        return _probe_deep(rays, boxes, sup_boxes, hyper_boxes, n_clusters,
                           c_pad)
    if not rays.is_cuda:
        return probe_plain(rays, boxes, n_clusters, c_pad), None
    dev = rays.device
    R = rays.shape[1]
    if not 0 < n_clusters <= MAX_CLUSTERS:
        raise ValueError(f"{n_clusters} clusters unsupported "
                         f"(max {MAX_CLUSTERS})")
    _lib.check(rays, "rays", torch.float32, dev, (8, R))
    _lib.check(boxes, "boxes", torch.float32, dev, (-1, 8))
    if boxes.shape[0] < n_clusters:
        raise ValueError(f"boxes must cover {n_clusters} clusters")
    out = torch.empty(R, dtype=torch.int32, device=dev)
    tests = torch.zeros(1, dtype=torch.int64, device=dev)
    if R:
        _lib.PROBE(dev, rays.data_ptr(), R, boxes.data_ptr(), n_clusters,
                   c_pad, out.data_ptr(), tests.data_ptr())
    return out, tests


def _probe_deep(rays, boxes, sup_boxes, hyper_boxes, n_clusters: int,
                c_pad: int):
    """Kernel C2 (:func:`probe_call` past MAX_CLUSTERS)."""
    if not rays.is_cuda:
        return probe_deep_plain(rays, boxes, sup_boxes, hyper_boxes,
                                n_clusters, c_pad), None
    dev = rays.device
    R = rays.shape[1]
    n_sup, n_hyper = _deep_rows(n_clusters)
    _lib.check(rays, "rays", torch.float32, dev, (8, R))
    for name, t, rows in (("boxes", boxes, n_clusters),
                          ("sup_boxes", sup_boxes, n_sup),
                          ("hyper_boxes", hyper_boxes, n_hyper)):
        _lib.check(t, name, torch.float32, dev, (-1, 8))
        if t.shape[0] < rows:
            raise ValueError(f"{name} must cover {rows} rows")
    out = torch.empty(R, dtype=torch.int32, device=dev)
    tests = torch.zeros(1, dtype=torch.int64, device=dev)
    if R:
        _lib.PROBE_DEEP(dev, rays.data_ptr(), R, boxes.data_ptr(),
                        n_clusters, sup_boxes.data_ptr(), n_sup,
                        hyper_boxes.data_ptr(), n_hyper, c_pad,
                        out.data_ptr(), tests.data_ptr())
    return out, tests


def probe_occupancy() -> int:
    """Resident warps per SM of kernel C on the current CUDA device (the
    runtime's occupancy number; its shared memory does not depend on the
    cluster count)."""
    fn = _lib.load().ort_probe_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    err = fn(ctypes.byref(warps))
    if err:
        raise RuntimeError(f"occupancy query failed with CUDA error {err}")
    return warps.value


def probe_live(rays):
    """(R,) bool: the rays kernel C tests boxes for (t_min < t_max, no NaN
    in the origin); every other ray gets c_pad, exactly (every entry is >=
    t_min, and a NaN origin makes every entry NaN)."""
    return (rays[6] < rays[7]) & ~torch.isnan(rays[0:3]).any(0)


def needed_probe_work(rays, first, boxes, n_clusters: int,
                      chunk: int = 1 << 16) -> dict:
    """The box tests a wave's probe answers ``first`` (kernel C's output)
    require of an exact two-level probe over ``boxes`` (c_pad, 8): per live
    ray (:func:`probe_live`) every supercluster
    (:func:`supercluster_boxes`), then the real members of each one whose
    entry is <= the entry of the ray's answer, or < its t_max where it has
    none (an upper estimate only at exact ties).  Dead rays need nothing.
    Plain PyTorch on the wave's device, ``chunk`` rays at a time.

    Returns Python ints: ``slab`` (those tests), ``flat`` (every live ray x
    every cluster, the flat scan's) and ``live`` (the live rays)."""
    n_sup = -(-n_clusters // GROUP)
    sup_boxes = supercluster_boxes(boxes)
    members = torch.clamp(n_clusters - GROUP * torch.arange(
        n_sup, device=rays.device), max=GROUP)
    live = probe_live(rays)
    work = dict(slab=0, flat=0, live=int(live.sum()))
    work["flat"] = work["live"] * n_clusters
    for r0 in range(0, rays.shape[1], chunk):
        sl = slice(r0, r0 + chunk)
        idx = torch.nonzero(live[sl])[:, 0] + r0
        if idx.numel() == 0:
            continue
        o, inv, tmin = rays[0:3, idx].T, inv_dir(rays[3:6, idx].T), rays[6, idx]
        f = first[idx].long()
        hit = f < n_clusters
        ans = boxes[f.clamp(max=n_clusters - 1)]
        e_ans = slab_entry(ans[:, 0:3], ans[:, 3:6], o, inv, tmin)
        reach = torch.where(hit, torch.nextafter(
            e_ans, torch.full_like(e_ans, float("inf"))), rays[7, idx])
        opened = _entries(sup_boxes[:n_sup], o, inv, tmin) < reach[:, None]
        work["slab"] += idx.numel() * n_sup + int((opened * members).sum())
    return work


def pack_rays(o, d, t_min, t_max):
    """(8, R) SoA ray rows [o, d, t_min, t_max] (t_max clamped to INF: a
    larger bound would make sentinel entries and misses look needed)."""
    return torch.cat([o.T, d.T, t_min[None, :],
                      torch.clamp(t_max, max=INF)[None, :]], 0).contiguous()


def pad_rays(o, d, t_min, t_max, w: int):
    """Pad a wave to a multiple of ``w`` with dead rays (t_min=1, t_max=0,
    d = +z)."""
    n = o.shape[0]
    pad = (-n) % w
    if not pad:
        return o, d, t_min, t_max
    dev = o.device
    dead_d = torch.zeros((pad, 3), device=dev)
    dead_d[:, 2] = 1.0
    return (torch.cat([o, torch.zeros((pad, 3), device=dev)]),
            torch.cat([d, dead_d]),
            torch.cat([t_min, torch.ones(pad, device=dev)]),
            torch.cat([t_max, torch.zeros(pad, device=dev)]))


def _pad_boxes(bmin, bmax, pad: int):
    """(C + pad, 8) rows [min3, max3, 0, 0], NaN rows for the padding."""
    if pad:
        nan = torch.full((pad, 3), float("nan"), device=bmin.device)
        bmin = torch.cat([bmin, nan])
        bmax = torch.cat([bmax, nan])
    return torch.cat([bmin, bmax, torch.zeros((bmin.shape[0], 2),
                                              device=bmin.device)], 1)


def _wave_sub_boxes(clusters, c_pad: int, coherent: bool):
    """(sub_boxes (c_pad, n_subs, 8), n_subs) for the wave's coherence
    class; incoherent waves merge the build's sub boxes pairwise (a NaN
    union: all-padding halves stay NaN)."""
    C = clusters.num_clusters
    n_subs = N_SUBS if coherent else N_SUBS_INCOHERENT
    sub_min, sub_max = clusters.sub_min, clusters.sub_max
    if n_subs != N_SUBS:
        f = N_SUBS // n_subs
        sub_min = nanmin(sub_min.reshape(C, n_subs, f, 3), 2
                         ).reshape(C * n_subs, 3)
        sub_max = nanmax(sub_max.reshape(C, n_subs, f, 3), 2
                         ).reshape(C * n_subs, 3)
    boxes = _pad_boxes(sub_min, sub_max, (c_pad - C) * n_subs)
    return boxes.reshape(c_pad, n_subs, 8), n_subs


def probe_inputs(clusters, o, d, t_min, t_max) -> dict:
    """The ``probe_call`` arguments for a wave (past MAX_CLUSTERS with the
    deep tables)."""
    C = clusters.num_clusters
    c_pad = ((C + 7) // 8) * 8
    boxes = _pad_boxes(clusters.cluster_min, clusters.cluster_max, c_pad - C)
    out = dict(rays=pack_rays(o, d, t_min, t_max), boxes=boxes,
               n_clusters=C, c_pad=c_pad)
    if is_deep(C):
        out["sup_boxes"], out["hyper_boxes"] = deep_tables(boxes)
    return out


def probe_first_cluster(clusters, o, d, t_min, t_max):
    """Per-ray id of the nearest cluster the ray enters (C_pad if none):
    the cull-only pass that coherence-sorts incoherent waves."""
    return probe_call(**probe_inputs(clusters, o, d, t_min, t_max))[0]


def supercluster_boxes(boxes):
    """(S_pad, 8) superclusters of padded cluster rows ``boxes`` (c_pad, 8),
    c_pad a multiple of GROUP: each box the NaN-aware union of its GROUP
    clusters' (a pure-padding supercluster stays NaN and is never
    entered), padded with NaN rows to a multiple of 8.  Kernel F culls on
    them; kernel C forms the same unions as it stages them."""
    S = boxes.shape[0] // GROUP
    return _pad_boxes(nanmin(boxes[:, 0:3].reshape(S, GROUP, 3), 1),
                      nanmax(boxes[:, 3:6].reshape(S, GROUP, 3), 1),
                      ((S + 7) // 8) * 8 - S)


def deep_tables(boxes):
    """(sup_boxes, hyper_boxes) of padded cluster rows ``boxes`` (c_pad,
    8): the superclusters (:func:`supercluster_boxes`) and the unions of
    GROUP superclusters each, the hyperclusters (64 clusters), both
    NaN-aware and padded with NaN rows to a multiple of 8: the cull levels
    of kernels F2 and C2."""
    sup = supercluster_boxes(boxes)
    return sup, supercluster_boxes(sup)


def probe_key_shift(c_pad: int) -> int:
    """The right shift that fits kernel C's ids (up to ``c_pad``) into the
    14 bits a probe sort key gives them (kernel O: id << 18 | direction
    Morton >> 12, 32 bits): 0 up to 16,383, so below MAX_CLUSTERS the
    keys are the JAX package's; past it, pairs (quads, ...) of consecutive
    clusters share a key's id field, and the sort only coheres less."""
    return max(0, int(c_pad).bit_length() - 14)


def is_deep(n_clusters: int) -> bool:
    """Whether a scene's waves go to the deep kernels F2 and C2: past the
    MAX_CLUSTERS that B, C and F take."""
    return n_clusters > MAX_CLUSTERS


def _check_clusters(C: int) -> None:
    if C > MAX_DEEP_CLUSTERS:
        raise ValueError(
            f"scene has {C:,} clusters; the marcher caps at "
            f"{MAX_DEEP_CLUSTERS:,} clusters = "
            f"{MAX_DEEP_CLUSTERS * CLUSTER_TRIS:,} triangles")


def march_tables(clusters, coherent: bool = True, hier: bool = False,
                 block_rays: int | None = None) -> dict:
    """The ``march_call`` (with ``hier``: ``march_hier_call``, over
    superclusters of GROUP clusters, :func:`supercluster_boxes`; past
    MAX_CLUSTERS, whatever ``hier``: ``march_deep_call``, over
    :func:`deep_tables`) arguments of a wave but its rays; ``w`` is the
    block width the rays are padded to."""
    C = clusters.num_clusters
    _check_clusters(C)
    c_pad = ((C + 7) // 8) * 8
    boxes = _pad_boxes(clusters.cluster_min, clusters.cluster_max, c_pad - C)
    sub_boxes, n_subs = _wave_sub_boxes(clusters, c_pad, coherent)
    tables = dict(boxes=boxes, sub_boxes=sub_boxes, woop_t=clusters.woop_t,
                  n_clusters=C, n_subs=n_subs)
    if is_deep(C):
        sup_boxes, hyper_boxes = deep_tables(boxes)
        return dict(hyper_boxes=hyper_boxes, sup_boxes=sup_boxes, **tables,
                    w=BLOCK_RAYS)
    if hier:
        return dict(sup_boxes=supercluster_boxes(boxes), **tables,
                    w=BLOCK_RAYS)
    return dict(tables, w=block_rays or choose_block_rays(C, coherent))


def march_inputs(clusters, o, d, t_min, t_max, coherent: bool = True,
                 block_rays: int | None = None) -> dict:
    """The ``march_call`` arguments for a wave (padded to whole blocks)."""
    tables = march_tables(clusters, coherent, block_rays=block_rays)
    return dict(rays=pack_rays(*pad_rays(o, d, t_min, t_max, tables["w"])),
                **tables)


def hier_inputs(clusters, o, d, t_min, t_max,
                coherent: bool = True) -> dict:
    """The ``march_hier_call`` arguments for a wave."""
    tables = march_tables(clusters, coherent, hier=True)
    return dict(rays=pack_rays(*pad_rays(o, d, t_min, t_max, BLOCK_RAYS)),
                **tables)


def deep_inputs(clusters, o, d, t_min, t_max,
                coherent: bool = True) -> dict:
    """The ``march_deep_call`` arguments for a wave (past MAX_CLUSTERS)."""
    tables = march_tables(clusters, coherent)
    return dict(rays=pack_rays(*pad_rays(o, d, t_min, t_max, BLOCK_RAYS)),
                **tables)


def use_hier(n_clusters: int, coherent: bool,
             block_rays: int | None = None) -> bool:
    """Whether a wave goes to kernel F: coherent, at HIER_MIN_CLUSTERS
    clusters or more, and no explicit block width."""
    return n_clusters >= HIER_MIN_CLUSTERS and coherent and block_rays is None


def _finish(t, slot, any_hit: bool, winners):
    """(t, slot, u, v) of a march: INF t on misses; for nearest-hit
    queries u, v recomputed from ``winners()`` = (the winners' Woop rows
    (R, 12), o, d in the rows' space); zero for misses and for occlusion
    queries, which never call ``winners``."""
    miss = slot < 0
    t = torch.where(miss, torch.full_like(t, INF), t)
    zero = torch.zeros_like(t)
    if any_hit:
        return t, slot, zero, zero
    woop, o, d = winners()
    t_safe = torch.where(miss, zero, t)   # keep INF out of the arithmetic
    u = dot(woop[:, 0:3], o) - woop[:, 9] + t_safe * dot(woop[:, 0:3], d)
    v = dot(woop[:, 3:6], o) - woop[:, 10] + t_safe * dot(woop[:, 3:6], d)
    return t, slot, torch.where(miss, zero, u), torch.where(miss, zero, v)


def block_march(clusters, o, d, t_min, t_max, any_hit: bool = False,
                block_rays: int | None = None, coherent: bool = True):
    """Nearest-hit (or, with ``any_hit``, occlusion) query.

    o, d (R, 3), t bounds (R,); rays should be coherence-sorted by the
    caller.  Returns (t, slot, u, v): slot indexes the sorted triangles
    (-1 miss), u/v are recomputed from the winner's Woop row.  With
    ``any_hit`` only slot's hit/miss distinction is meaningful.

    Past MAX_CLUSTERS clusters every wave goes to the deep kernel F2;
    below, coherent waves at HIER_MIN_CLUSTERS clusters or more (and no
    explicit ``block_rays``) go to the hierarchical kernel F, every other
    wave to the flat kernel B.  All are exact; on a tie at exactly equal t
    they may pick different triangles."""
    _check_clusters(clusters.num_clusters)
    if is_deep(clusters.num_clusters):
        return block_march_deep(clusters, o, d, t_min, t_max,
                                any_hit=any_hit, coherent=coherent)
    if use_hier(clusters.num_clusters, coherent, block_rays):
        return block_march_hier(clusters, o, d, t_min, t_max,
                                any_hit=any_hit, coherent=coherent)
    n = o.shape[0]
    t, slot, _ = march_call(**march_inputs(clusters, o, d, t_min, t_max,
                                           coherent, block_rays),
                            any_hit=any_hit)
    t, slot = t[:n], slot[:n]
    return _finish(t, slot, any_hit, lambda: (
        clusters.woop[torch.clamp(slot, min=0).long()], o, d))


def block_march_hier(clusters, o, d, t_min, t_max, any_hit: bool = False,
                     coherent: bool = True):
    """Hierarchical (supercluster) variant of :func:`block_march`: the same
    contract and the same exact results, through kernel F."""
    n = o.shape[0]
    t, slot, _ = march_hier_call(**hier_inputs(clusters, o, d, t_min, t_max,
                                               coherent), any_hit=any_hit)
    t, slot = t[:n], slot[:n]
    return _finish(t, slot, any_hit, lambda: (
        clusters.woop[torch.clamp(slot, min=0).long()], o, d))


def block_march_deep(clusters, o, d, t_min, t_max, any_hit: bool = False,
                     coherent: bool = True):
    """The deep (hypercluster) variant of :func:`block_march`, past
    MAX_CLUSTERS: the same contract and exact results, through kernel
    F2."""
    n = o.shape[0]
    t, slot, _ = march_deep_call(**deep_inputs(clusters, o, d, t_min, t_max,
                                               coherent), any_hit=any_hit)
    t, slot = t[:n], slot[:n]
    return _finish(t, slot, any_hit, lambda: (
        clusters.woop[torch.clamp(slot, min=0).long()], o, d))


def march_instanced_inputs(pair_min, pair_max, sub_min, sub_max, pair_shape,
                           pair_inst, inst_rows, lib_woop_t, o, d, t_min,
                           t_max) -> dict:
    """The ``march_instanced_call`` arguments for a TLAS wave: N_SUBS sub
    boxes per pair on every wave, 128-ray blocks."""
    C = pair_min.shape[0]
    if C > MAX_CLUSTERS:
        raise ValueError(f"{C} instance pairs exceed {MAX_CLUSTERS}")
    c_pad = ((C + 7) // 8) * 8
    return dict(
        rays=pack_rays(*pad_rays(o, d, t_min, t_max, BLOCK_RAYS)),
        boxes=_pad_boxes(pair_min, pair_max, c_pad - C),
        sub_boxes=_pad_boxes(sub_min, sub_max, (c_pad - C) * N_SUBS
                             ).reshape(c_pad, N_SUBS, 8),
        pair_shape=pair_shape.to(torch.int32).contiguous(),
        pair_inst=pair_inst.to(torch.int32).contiguous(),
        inst_rows=inst_rows.contiguous(), woop_t=lib_woop_t, n_pairs=C,
        w=BLOCK_RAYS)


def block_march_instanced(pair_min, pair_max, sub_min, sub_max, pair_shape,
                          pair_inst, inst_rows, lib_woop_t, lib_woop, o, d,
                          t_min, t_max, any_hit: bool = False):
    """Instance-level (TLAS) nearest-hit or occlusion query through kernel
    E: each cull row is an (instance, library cluster) pair.

    pair_min/pair_max: (Cp, 3) world pair boxes; sub_min/sub_max:
    (Cp * N_SUBS, 3) world sub boxes; pair_shape/pair_inst: (Cp,) int32;
    inst_rows: (P, 128) world->object affine rows; lib_woop_t: (SC, 16,
    CHUNK); lib_woop: (SC * CHUNK, 12) object-space rows for the u/v
    recompute.  Returns (t, slot, u, v) with slot = pair * CHUNK + row
    (-1 miss); u, v are recomputed in the winner's object space."""
    n = o.shape[0]
    C = pair_min.shape[0]
    t, slot, _ = march_instanced_call(
        **march_instanced_inputs(pair_min, pair_max, sub_min, sub_max,
                                 pair_shape, pair_inst, inst_rows,
                                 lib_woop_t, o, d, t_min, t_max),
        any_hit=any_hit)
    t, slot = t[:n], slot[:n]

    def winners():
        pos = torch.clamp(slot, min=0).long()
        pair = torch.clamp(pos // CLUSTER_TRIS, max=C - 1)
        rows = inst_rows[pair_inst.long()[pair], :12]
        return (lib_woop[pair_shape.long()[pair] * CLUSTER_TRIS
                         + pos % CLUSTER_TRIS],
                instance_points(rows, o), instance_dirs(rows, d))

    return _finish(t, slot, any_hit, winners)
