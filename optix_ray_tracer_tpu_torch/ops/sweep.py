"""Cluster acceleration structure (port of the host build in
``optix_ray_tracer_tpu/ops/sweep.py``).

Triangles are partitioned by a leaf-aligned sweep-SAH on the host (numpy,
float64 cost) into clusters of ``CHUNK`` consecutive triangles, each cut
into ``SUBS_PER_CLUSTER`` sub boxes.  The arrays and their layouts are the
JAX package's, bit for bit: ``woop`` (n_pad, 12), ``woop_t`` (C, 16,
CHUNK), and NaN boxes for pure-padding clusters and sub boxes.  The device
refit/rebuild and the sweep intersector wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.bvh import morton_codes
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass

CHUNK = 256             # triangles per cluster
SUBS_PER_CLUSTER = 4    # sub boxes per cluster
SUB_TRIS = CHUNK // SUBS_PER_CLUSTER

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


def build_clusters(tri_vertices, method: str = "sah") -> ClusterSet:
    """Partition + chunk on the host; returns a ClusterSet of CPU tensors
    (``.to(device)`` moves it).

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
    return ClusterSet(
        woop=torch.as_tensor(woop), woop_t=torch.as_tensor(
            _transpose_woop(woop)),
        prim_index=torch.as_tensor(prim_index),
        cluster_min=torch.as_tensor(cmin), cluster_max=torch.as_tensor(cmax),
        sub_min=torch.as_tensor(smin), sub_max=torch.as_tensor(smax))
