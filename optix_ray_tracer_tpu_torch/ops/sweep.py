"""Cluster acceleration structure and the cluster-sweep intersector (port
of ``optix_ray_tracer_tpu/ops/sweep.py``).

Triangles are partitioned by a leaf-aligned sweep-SAH on the host (numpy,
float64 cost) into clusters of ``CHUNK`` consecutive triangles, each cut
into ``SUBS_PER_CLUSTER`` sub boxes.  The arrays and their layouts are the
JAX package's, bit for bit: ``woop`` (n_pad, 12), ``woop_t`` (C, 16,
CHUNK), and NaN boxes for pure-padding clusters and sub boxes.

``SweepIntersector`` finds exact nearest hits by a method unlike the
marcher's, which makes it the structural oracle of the hit path.  Each
pass, every live ray takes its nearest unvisited cluster by the
lexicographic key (slab entry, cluster id) over all cluster boxes (a
dense (R, C) reduction), rays are sorted by that cluster, and 128-ray
blocks sweep the cluster's 256-triangle window densely (kernel G,
``ops/kernels/leaf_sweep.py``).  A ray's visited frontier then jumps past
every cluster the window covered; it stops when no unvisited cluster is
nearer than its best hit.  The device refit/rebuild waits for the
animation-loop slice.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.bvh import morton_codes
from optix_ray_tracer_tpu_torch.ops.intersect import (
    DEFAULT_T_MIN, PRIM_NONE, PRIM_TRIANGLE, Hit, ray_bound,
)
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

CHUNK = 256             # triangles per cluster
SUBS_PER_CLUSTER = 4    # sub boxes per cluster
SUB_TRIS = CHUNK // SUBS_PER_CLUSTER
BLOCK_RAYS = 128        # rays per sweep block
WINDOW_CHUNKS = 1       # clusters swept per block window
WINDOW_TRIS = CHUNK * WINDOW_CHUNKS
#: elements of one (rays, clusters) slice of the dense reductions: the
#: rays are chunked so that their float32 temporaries (four (rays,
#: clusters, 3) arrays at most) stay under ~1 GB
_SLAB_ELEMENTS = 1 << 24

# woop_t row order: [r0xyz, cx, r1xyz, cy, r2xyz, cz] then 4 zero rows
_WOOP_T_PERM = (0, 1, 2, 9, 3, 4, 5, 10, 6, 7, 8, 11)
WOOP_T_ROWS = 16


def woop_transforms(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray
                    ) -> np.ndarray:
    """Per-triangle world -> unit-triangle transforms (n, 12) float32:
    M = inverse([e1 | e2 | e1 x e2]), c = M @ v0.  Degenerate triangles get
    zero rows and never hit."""
    n = v0.shape[0]
    A = np.stack([e1, e2, np.cross(e1, e2)], axis=-1)
    ok = np.abs(np.linalg.det(A)) > 1e-18
    M = np.zeros((n, 3, 3), np.float64)
    if ok.any():
        M[ok] = np.linalg.inv(A[ok])
    c = np.einsum('nij,nj->ni', M, v0)
    return np.concatenate([M.reshape(n, 9), c], axis=1).astype(np.float32)


def _transpose_woop(woop: np.ndarray) -> np.ndarray:
    """(n_pad, 12) Woop rows -> (C, WOOP_T_ROWS, CHUNK) per-cluster blocks."""
    C = woop.shape[0] // CHUNK
    wt = woop[:, list(_WOOP_T_PERM)].reshape(C, CHUNK, 12).swapaxes(1, 2)
    pad = np.zeros((C, WOOP_T_ROWS - 12, CHUNK), woop.dtype)
    return np.ascontiguousarray(np.concatenate([wt, pad], axis=1))


@dataclasses.dataclass(frozen=True)
class ClusterSet(TensorDataclass):
    """Partition-ordered scene clusters.

    woop (n_pad, 12), woop_t (C, 16, CHUNK), prim_index (n_pad,) int32
    sorted slot -> original triangle, cluster_min/max (C, 3),
    sub_min/max (C * SUBS_PER_CLUSTER, 3)."""
    woop: torch.Tensor
    woop_t: torch.Tensor
    prim_index: torch.Tensor
    cluster_min: torch.Tensor
    cluster_max: torch.Tensor
    sub_min: torch.Tensor
    sub_max: torch.Tensor

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]


def _sah_chunk_order(cents: np.ndarray, leaf: int) -> np.ndarray:
    """Recursive leaf-aligned sweep-SAH partition of the triangle order
    (clusters are contiguous ``leaf``-triangle runs).  Returns output
    slot -> original triangle id."""
    n = cents.shape[0]
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        m = idx.shape[0]
        if m <= leaf:
            out[pos:pos + m] = idx
            pos += m
            continue
        c = cents[idx]
        best = None
        for axis in range(3):
            srt = np.argsort(c[:, axis], kind="stable")
            cs = c[srt]
            pref_lo = np.minimum.accumulate(cs, 0)
            pref_hi = np.maximum.accumulate(cs, 0)
            suf_lo = np.minimum.accumulate(cs[::-1], 0)[::-1]
            suf_hi = np.maximum.accumulate(cs[::-1], 0)[::-1]
            cuts = np.arange(leaf, m, leaf)
            dl = pref_hi[cuts - 1] - pref_lo[cuts - 1]
            dr = suf_hi[cuts] - suf_lo[cuts]
            sa_l = dl[:, 0] * dl[:, 1] + dl[:, 1] * dl[:, 2] \
                + dl[:, 0] * dl[:, 2]
            sa_r = dr[:, 0] * dr[:, 1] + dr[:, 1] * dr[:, 2] \
                + dr[:, 0] * dr[:, 2]
            nl = cuts.astype(np.float64)
            # NaN centroids (degenerate triangles) poison suffix boxes:
            # treat those cuts as merely very bad
            cost = np.nan_to_num(sa_l * nl + sa_r * (m - nl), nan=np.inf)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (cost[k], cuts[k], srt)
        _, cut, srt = best
        stack.append(idx[srt[cut:]])
        stack.append(idx[srt[:cut]])
    assert pos == n
    return out


def _nan_boxes(pad_tris: np.ndarray, groups: int):
    """Per-group AABBs of (n_pad, 3, 3) triangles, NaN for pure padding."""
    g = pad_tris.reshape(groups, -1, 3, 3)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmin(g, axis=(1, 2)), np.nanmax(g, axis=(1, 2))


def build_clusters(tri_vertices, method: str = "sah",
                   device=None) -> ClusterSet:
    """Partition + chunk on the host; returns a ClusterSet of tensors on
    ``device``.

    method: "sah" (default) = leaf-aligned sweep-SAH down to SUB_TRIS
    granularity; "morton" = Morton-sort chunking."""
    tv = np.asarray(tri_vertices, np.float32)
    n = tv.shape[0]
    cents = tv.mean(axis=1)
    if method == "sah" and n > CHUNK:
        c64 = cents.astype(np.float64)
        order = _sah_chunk_order(c64, CHUNK)
        # refine within each full cluster so its sub boxes are compact too
        for s in range(0, n - CHUNK + 1, CHUNK):
            seg = order[s:s + CHUNK]
            order[s:s + CHUNK] = seg[_sah_chunk_order(c64[seg], SUB_TRIS)]
    elif method in ("sah", "morton"):
        codes = morton_codes(torch.as_tensor(cents),
                             torch.as_tensor(tv.min(axis=(0, 1))),
                             torch.as_tensor(tv.max(axis=(0, 1)))).numpy()
        order = np.argsort(codes, kind="stable").astype(np.int64)
    else:
        raise ValueError(f"unknown cluster build method: {method!r}")

    n_pad = max(((n + CHUNK - 1) // CHUNK) * CHUNK, CHUNK)
    sorted_tris = tv[order]
    v0 = sorted_tris[:, 0].astype(np.float64)
    e1 = (sorted_tris[:, 1] - sorted_tris[:, 0]).astype(np.float64)
    e2 = (sorted_tris[:, 2] - sorted_tris[:, 0]).astype(np.float64)
    woop = np.zeros((n_pad, 12), np.float32)
    woop[:n] = woop_transforms(v0, e1, e2)
    prim_index = np.zeros(n_pad, np.int32)
    prim_index[:n] = order

    C = n_pad // CHUNK
    pad_tris = np.full((n_pad, 3, 3), np.nan, np.float32)
    pad_tris[:n] = sorted_tris
    # pure-padding groups keep NaN boxes: every slab comparison is false
    cmin, cmax = _nan_boxes(pad_tris, C)
    smin, smax = _nan_boxes(pad_tris, C * SUBS_PER_CLUSTER)
    dev = resolve_device(device)
    return ClusterSet(**{k: torch.as_tensor(a, device=dev) for k, a in dict(
        woop=woop, woop_t=_transpose_woop(woop), prim_index=prim_index,
        cluster_min=cmin, cluster_max=cmax, sub_min=smin, sub_max=smax
    ).items()})


# ---------------------------------------------------------------------------
# The sweep intersector
# ---------------------------------------------------------------------------

def _cluster_keys(clusters: ClusterSet, o, inv_d, t_min, best_t, last_entry,
                  last_cid, win_lo=None, win_hi=None):
    """(argmin, min) over clusters of the key ``entry`` where a ray's slab
    hits the cluster within [t_min, best_t] after its visited frontier
    (last_entry, last_cid) -- and outside [win_lo, win_hi) where given --
    INF elsewhere; the first minimum, so the lowest cluster id on equal
    entries.  Chunked over rays; ``torch.minimum``/``maximum``/``amax``/
    ``amin`` propagate NaN as ``jnp`` does, so NaN padding boxes never
    hit."""
    cmin, cmax = clusters.cluster_min, clusters.cluster_max
    C = cmin.shape[0]
    cid = torch.arange(C, device=o.device)[None, :]
    step = max(1, _SLAB_ELEMENTS // max(C, 1))
    args, mins = [], []
    for r0 in range(0, o.shape[0], step):
        sl = slice(r0, r0 + step)
        t0 = (cmin[None] - o[sl, None]) * inv_d[sl, None]
        t1 = (cmax[None] - o[sl, None]) * inv_d[sl, None]
        enter = torch.maximum(torch.amax(torch.minimum(t0, t1), -1),
                              t_min[sl, None])
        exit_ = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                              best_t[sl, None])
        del t0, t1
        le = last_entry[sl, None]
        keep = (enter <= exit_) & ((enter > le) | (
            (enter == le) & (cid > last_cid[sl, None])))
        if win_lo is not None:
            keep &= (cid < win_lo[sl, None]) | (cid >= win_hi[sl, None])
        key = torch.where(keep, enter, torch.full_like(enter, INF))
        args.append(torch.argmin(key, -1))
        mins.append(torch.amin(key, -1))
    if not args:
        empty = torch.zeros(0, device=o.device)
        return empty.long(), empty
    return torch.cat(args), torch.cat(mins)


def _candidate_clusters(clusters: ClusterSet, o, inv_d, t_min, best_t,
                        last_entry, last_cid):
    """Nearest unvisited cluster per ray: (cand_id int64, cand_entry,
    active)."""
    cand, cand_entry = _cluster_keys(clusters, o, inv_d, t_min, best_t,
                                     last_entry, last_cid)
    return cand, cand_entry, cand_entry < INF


def _frontier_after_sweep(clusters: ClusterSet, o, inv_d, t_min, best_t,
                          last_entry, last_cid, win_lo, win_hi):
    """New visited frontier after sweeping clusters [win_lo, win_hi): just
    below the smallest unvisited key outside the window, i.e. its
    predecessor (entry, cid - 1); (INF, 0) and not active when none is
    left.  Returns (new_entry, new_cid int64, still_active)."""
    nxt, nxt_entry = _cluster_keys(clusters, o, inv_d, t_min, best_t,
                                   last_entry, last_cid, win_lo, win_hi)
    done = nxt_entry >= INF
    new_entry = torch.where(done, torch.full_like(nxt_entry, INF), nxt_entry)
    new_cid = torch.where(done, torch.zeros_like(nxt), nxt - 1)
    return new_entry, new_cid, ~done


def _sweep_pass(clusters: ClusterSet, o, d, t_min, best_t, slot, u, v,
                last_entry, last_cid):
    """One sweep pass over the given rays (the JAX package's
    ``_sweep_pass``, and the body of its in-jit ``sweep_intersect`` loop).
    Returns (best_t, slot, u, v, last_entry, last_cid, active)."""
    from optix_ray_tracer_tpu_torch.ops.kernels.leaf_sweep import (
        window_sweep_call,
    )
    dev = o.device
    R = o.shape[0]
    n_pad = clusters.woop.shape[0]
    C = clusters.num_clusters
    B = BLOCK_RAYS
    max_start = n_pad - WINDOW_TRIS
    # 1/d where |d| > 1e-12, else +1e12 whatever the sign of d
    inv_d = torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                        torch.full_like(d, 1e12))
    NW = (C + WINDOW_CHUNKS - 1) // WINDOW_CHUNKS
    # every group pads to whole blocks: at most NW + 1 partial blocks
    R_pad = ((R + (NW + 1) * (B - 1)) // B + 1) * B
    NBP = R_pad // B

    cand, _, active = _candidate_clusters(clusters, o, inv_d, t_min, best_t,
                                          last_entry, last_cid)
    # group = window id of the candidate; inactive rays -> group NW
    group = torch.where(active, cand // WINDOW_CHUNKS,
                        torch.full_like(cand, NW))
    perm = torch.argsort(group, stable=True)     # ray order within a group
    group_s = group[perm]
    counts = torch.bincount(group_s, minlength=NW + 1)
    padded = ((counts + B - 1) // B) * B
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    pad_off = torch.cat([zero, torch.cumsum(padded, 0)[:-1]])
    src_off = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])

    # padded slot -> source sorted ray, or an invalid filler
    slot_ids = torch.arange(R_pad, device=dev)
    g_of_slot = torch.clamp(torch.searchsorted(pad_off, slot_ids, right=True)
                            - 1, 0, NW)
    local = slot_ids - pad_off[g_of_slot]
    valid = local < counts[g_of_slot]
    src = torch.clamp(src_off[g_of_slot] + local, 0, max(R - 1, 0))
    ray_of_slot = perm[src]

    vcol = valid[:, None]
    o_s = torch.where(vcol, o[ray_of_slot], 0.0)
    d_s = torch.where(vcol, d[ray_of_slot], 0.0)
    d_s[:, 2] = torch.where(valid, d_s[:, 2], 1.0)
    tmin_s = torch.where(valid, t_min[ray_of_slot], 1.0)
    bt_s = torch.where(valid, best_t[ray_of_slot], 0.0)

    # every block belongs to one group; its window is that group's
    blk_group = g_of_slot.reshape(NBP, B)[:, 0]
    starts = torch.clamp(blk_group * WINDOW_TRIS, 0, max_start
                         ).to(torch.int32)
    best_in = (bt_s.reshape(NBP, B),
               torch.full((NBP, B), -1, dtype=torch.int32, device=dev),
               torch.zeros((NBP, B), device=dev),
               torch.zeros((NBP, B), device=dev))
    bt2, slot2, u2, v2 = window_sweep_call(
        clusters.woop, starts, o_s.reshape(NBP, B, 3),
        d_s.reshape(NBP, B, 3), tmin_s.reshape(NBP, B), best_in)

    # each original ray's padded slot (perm is a permutation: its inverse
    # by scatter equals argsort(perm))
    slot_of_sorted = pad_off[group_s] + (torch.arange(R, device=dev)
                                         - src_off[group_s])
    slot_of_ray = torch.empty_like(slot_of_sorted)
    slot_of_ray[perm] = slot_of_sorted
    bt2 = bt2.reshape(-1)[slot_of_ray]
    slot2 = slot2.reshape(-1)[slot_of_ray]
    u2 = u2.reshape(-1)[slot_of_ray]
    v2 = v2.reshape(-1)[slot_of_ray]
    win_lo = torch.minimum(
        torch.where(active, (cand // WINDOW_CHUNKS) * WINDOW_CHUNKS,
                    torch.zeros_like(cand)),
        torch.full_like(cand, max_start // CHUNK))
    win_hi = win_lo + WINDOW_CHUNKS

    improved = active & (bt2 < best_t)
    best_t = torch.where(improved, bt2, best_t)
    slot = torch.where(improved, slot2, slot)
    u = torch.where(improved, u2, u)
    v = torch.where(improved, v2, v)

    # advance the frontier through everything the window covered
    new_entry, new_cid, still_active = _frontier_after_sweep(
        clusters, o, inv_d, t_min, best_t, last_entry, last_cid, win_lo,
        win_hi)
    last_entry = torch.where(active, new_entry, last_entry)
    last_cid = torch.where(active, new_cid.to(last_cid.dtype), last_cid)
    return best_t, slot, u, v, last_entry, last_cid, active & still_active


@dataclasses.dataclass
class SweepStats:
    """What one sweep query did: the live rays at the start of each pass,
    and whether some ray was still active when the loop stopped at its
    pass cap (its answer is then not exact)."""
    live: list
    unfinished: bool

    @property
    def passes(self) -> int:
        return len(self.live)


def _initial_state(o, t_max):
    R = o.shape[0]
    dev = o.device
    return dict(best_t=t_max.to(torch.float32).clone(),
                slot=torch.full((R,), -1, dtype=torch.int32, device=dev),
                u=torch.zeros(R, device=dev), v=torch.zeros(R, device=dev),
                last_entry=torch.full((R,), -INF, device=dev),
                last_cid=torch.full((R,), -1, dtype=torch.int64, device=dev))


def sweep_intersect(clusters: ClusterSet, o, d, t_min, t_max,
                    max_passes: int = 64):
    """Nearest-hit query, the lockstep loop: every ray in every pass while
    any ray is active, at most ``max_passes`` passes (the loop the JAX
    integrators run under jit).  o, d (R, 3) with R a multiple of
    BLOCK_RAYS; t bounds (R,).  Returns (t, slot, u, v, stats), slot an
    index into the sorted prim arrays (-1 = miss)."""
    s = _initial_state(o, t_max)
    live = []
    n_active = o.shape[0]
    while n_active and len(live) < max_passes:
        live.append(n_active)
        (s["best_t"], s["slot"], s["u"], s["v"], s["last_entry"],
         s["last_cid"], active) = _sweep_pass(clusters, o, d, t_min, **s)
        n_active = int(active.sum())
    return (s["best_t"], s["slot"], s["u"], s["v"],
            SweepStats(live, n_active > 0))


def sweep_intersect_host(clusters: ClusterSet, o, d, t_min, t_max,
                         max_passes: int = 512):
    """Nearest-hit query, the compacting loop (the JAX package's host
    route): after each pass only the rays still active are kept.  A ray's
    pass depends only on its own state and on its group's window, so the
    result is the lockstep loop's for every ray either finishes; the JAX
    package compacts into 16x buckets instead, to bound TPU compiles, which
    eager PyTorch does not need.  Same arguments and results as
    :func:`sweep_intersect`."""
    res = _initial_state(o, t_max)
    cur = dict(res, o=o, d=d, t_min=t_min)
    idx = None                       # live subset -> ray, None = all rays
    live = []
    n_active = o.shape[0]
    while n_active and len(live) < max_passes:
        live.append(n_active)
        (cur["best_t"], cur["slot"], cur["u"], cur["v"], cur["last_entry"],
         cur["last_cid"], active) = _sweep_pass(clusters, **cur)
        n_active = int(active.sum())
        if n_active < cur["o"].shape[0]:
            # write back everything, then keep only the live rays
            for k in ("best_t", "slot", "u", "v"):
                if idx is None:
                    res[k] = cur[k]
                else:
                    res[k][idx] = cur[k]
            keep = torch.nonzero(active)[:, 0]
            cur = {k: x[keep] for k, x in cur.items()}
            idx = keep if idx is None else idx[keep]
    for k in ("best_t", "slot", "u", "v"):
        if idx is None:
            res[k] = cur[k]
        else:
            res[k][idx] = cur[k]
    return (res["best_t"], res["slot"], res["u"], res["v"],
            SweepStats(live, n_active > 0))


@dataclasses.dataclass(frozen=True)
class SweepIntersector(TensorDataclass):
    """Drop-in intersector over the cluster sweep (+ dense sphere merge).

    Kernel G or its plain version is chosen by the tensors' device, as for
    the other kernels.  ``log``, where given, collects each query's
    :class:`SweepStats`."""
    clusters: ClusterSet
    log: list | None = None

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                  t_max=INF) -> Hit:
        shape = o.shape[:-1]
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        n = o2.shape[0]
        dev = o2.device
        t_min_a = ray_bound(t_min, n, dev)
        t_max_a = ray_bound(t_max, n, dev)

        # pad to whole blocks with dead rays (d = +z, t_min 1, t_max 0)
        pad = (-n) % BLOCK_RAYS
        dead_d = torch.zeros((pad, 3), device=dev)
        dead_d[:, 2] = 1.0
        o_p = torch.cat([o2, torch.zeros((pad, 3), device=dev)])
        d_p = torch.cat([d2, dead_d])
        tmin_p = torch.cat([t_min_a, torch.ones(pad, device=dev)])
        tmax_p = torch.cat([t_max_a, torch.zeros(pad, device=dev)])
        # nothing is traced in PyTorch: always the compacting host route
        t, slot, u, v, stats = sweep_intersect_host(
            self.clusters, o_p, d_p, tmin_p, tmax_p)
        if self.log is not None:
            self.log.append(stats)
        t, slot, u, v = t[:n], slot[:n], u[:n], v[:n]
        missed = slot < 0
        prim_id = self.clusters.prim_index[torch.clamp(slot, min=0).long()]
        zero = torch.zeros_like(u)
        hit = Hit(
            t=torch.where(missed, torch.full_like(t, INF), t),
            prim_type=torch.where(missed, PRIM_NONE, PRIM_TRIANGLE
                                  ).to(torch.int32),
            prim_id=torch.where(missed, 0, prim_id).to(torch.int32),
            u=torch.where(missed, zero, u),
            v=torch.where(missed, zero, v))
        if scene.sphere_count > 0:
            from optix_ray_tracer_tpu_torch.ops.raysort import (
                sphere_bruteforce_merge,
            )
            hit = sphere_bruteforce_merge(scene, o2, d2, t_min_a, t_max_a,
                                          hit)
        return hit.reshape(shape)

    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                 t_max=INF) -> Hit:
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self.intersect(scene, o, d, t_min, t_max).is_hit


def make_sweep_intersector(scene: Scene, log: list | None = None
                           ) -> SweepIntersector:
    """Build the ClusterSet of ``scene``'s triangles on the host and the
    intersector on the scene's device."""
    tv = scene.triangles.vertices
    return SweepIntersector(
        clusters=build_clusters(tv.cpu().numpy(), device=tv.device), log=log)
