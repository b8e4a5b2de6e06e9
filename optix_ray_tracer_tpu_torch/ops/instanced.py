"""Instance-level two-level traversal (TLAS): object-space library clusters
and per-(instance, cluster) pair marching (port of
``optix_ray_tracer_tpu/ops/instanced.py``).

The reference's IAS is a two-level structure: a GAS per STL shape built
once (``src/Global/RendererTime.cu:176-182``) and an instance AS of
transforms refit per frame (``src/Global/RendererImpl.cu:174-242``).
Here:

* the LIBRARY is clustered once in OBJECT space (geometry stored once per
  shape, on the host, with the same build as the flat scenes);
* each cull row of kernel E is an (instance, library cluster) PAIR whose
  world box is refit per frame from the instance pose;
* a visit stages the pair's object-space cluster and moves the rays into
  the instance's space (rigid + uniform scale, so t is the same parameter
  in both spaces).

Limits: pairs <= ``block_march.MAX_CLUSTERS`` (8,192: kernel E has no
deep variant; flattened scenes go past it through F2 and C2); transforms
rigid + uniform scale (the Time frontend's pose model).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.intersect import (
    DEFAULT_T_MIN, PRIM_NONE, PRIM_TRIANGLE, Hit, ray_bound,
)
from optix_ray_tracer_tpu_torch.ops.kernels.block_march import (
    CLUSTER_TRIS, block_march_instanced,
)
from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
from optix_ray_tracer_tpu_torch.ops.sweep import (
    SUBS_PER_CLUSTER, build_clusters,
)
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot


@dataclasses.dataclass(frozen=True)
class InstancedLibrary(TensorDataclass):
    """Object-space cluster data for a shape library, built once.

    woop_t (SC, 16, CHUNK), woop (SC * CHUNK, 12), prim_index (SC * CHUNK,)
    sorted slot -> LIBRARY triangle id, obj_* object-space cluster and sub
    boxes; shape_cluster_offset: (S + 1,) host ints, shape s owns library
    clusters [off[s], off[s + 1])."""
    woop_t: torch.Tensor
    woop: torch.Tensor
    prim_index: torch.Tensor
    obj_cmin: torch.Tensor
    obj_cmax: torch.Tensor
    obj_smin: torch.Tensor
    obj_smax: torch.Tensor
    shape_cluster_offset: tuple


def build_instanced_library(lib_vertices, offsets, counts, device=None
                            ) -> InstancedLibrary:
    """Cluster each shape of a packed library in object space (host build,
    tensors on ``device``)."""
    dev = resolve_device(device)
    lv = np.asarray(lib_vertices, np.float32)
    parts = []
    sco = [0]
    for s in range(len(counts)):
        lo = int(offsets[s])
        cs = build_clusters(lv[lo:lo + int(counts[s])], device=dev)
        parts.append((cs, lo))
        sco.append(sco[-1] + cs.num_clusters)
    if not parts:
        raise ValueError("empty shape library")

    def cat(name, shift=False):
        return torch.cat([getattr(c, name) + (lo if shift else 0)
                          for c, lo in parts], 0)

    return InstancedLibrary(
        woop_t=cat("woop_t"), woop=cat("woop"),
        prim_index=cat("prim_index", shift=True),
        obj_cmin=cat("cluster_min"), obj_cmax=cat("cluster_max"),
        obj_smin=cat("sub_min"), obj_smax=cat("sub_max"),
        shape_cluster_offset=tuple(sco))


def make_pairs(library: InstancedLibrary, shape_ids):
    """(pair_shape, pair_inst) int32 tensors on the library's device for
    instances with the given shape ids: one pair per (instance, library
    cluster), instance major, clusters ascending."""
    sco = np.asarray(library.shape_cluster_offset, np.int64)
    sid = np.asarray(shape_ids, np.int64).reshape(-1)
    first, n = sco[sid], sco[sid + 1] - sco[sid]
    pair_inst = np.repeat(np.arange(sid.shape[0]), n)
    starts = np.cumsum(n) - n
    pair_shape = np.repeat(first, n) + np.arange(pair_inst.shape[0]) \
        - np.repeat(starts, n)
    dev = library.woop_t.device
    return (torch.as_tensor(pair_shape.astype(np.int32), device=dev),
            torch.as_tensor(pair_inst.astype(np.int32), device=dev))


def _matvec(m, x):
    """Rows of (..., 3, 3) ``m`` times (..., 3) ``x``, summed left to
    right."""
    return torch.stack([(m[..., i, 0] * x[..., 0] + m[..., i, 1] * x[..., 1])
                        + m[..., i, 2] * x[..., 2] for i in range(3)], -1)


def refit_instanced(library: InstancedLibrary, pair_shape, pair_inst, rot,
                    shift, scale, valid):
    """Per-frame TLAS refit (the updateIAS analog): world pair and sub
    boxes plus the packed world->object affine rows.

    rot: (P, 3, 3) object->world rotations; shift: (P, 3); scale: scalar
    uniform scale; valid: (P,) bool (invalid instances get NaN boxes,
    which are never entered).  Returns (pair_min, pair_max, sub_min,
    sub_max, inst_rows (P, 128) rows [A(9), b(3), 0...], A = R^T / s)."""
    dev = library.woop_t.device
    rot = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    pair_shape = pair_shape.to(dev).long()
    pair_inst = pair_inst.to(dev).long()
    P = rot.shape[0]
    A = rot.transpose(1, 2) / scale
    inst_rows = torch.cat([A.reshape(P, 9), shift,
                           torch.zeros((P, 128 - 12), device=dev)], 1)

    def world_boxes(omin, omax, rows_per_shape):
        idx = (pair_shape[:, None] * rows_per_shape
               + torch.arange(rows_per_shape, device=dev)).reshape(-1)
        pinst = torch.repeat_interleave(pair_inst, rows_per_shape)
        co = (omin[idx] + omax[idx]) * 0.5 * scale
        eo = (omax[idx] - omin[idx]) * 0.5 * scale
        r = rot[pinst]
        cw = _matvec(r, co) + shift[pinst]
        ew = _matvec(torch.abs(r), eo)
        ok = valid[pinst, None]
        nan = torch.full_like(cw, float("nan"))
        return torch.where(ok, cw - ew, nan), torch.where(ok, cw + ew, nan)

    pair_min, pair_max = world_boxes(library.obj_cmin, library.obj_cmax, 1)
    sub_min, sub_max = world_boxes(library.obj_smin, library.obj_smax,
                                   SUBS_PER_CLUSTER)
    return pair_min, pair_max, sub_min, sub_max, inst_rows


def scene_bounds(pair_min, pair_max):
    """(lo, hi) over the finite pair boxes (the Morton frame)."""
    return (torch.nan_to_num(pair_min, nan=float("inf")).amin(0),
            torch.nan_to_num(pair_max, nan=float("-inf")).amax(0))


@dataclasses.dataclass(frozen=True)
class InstancedMarchIntersector(TensorDataclass):
    """TLAS query object: library clusters + one frame's pair state.

    ``intersect`` returns (Hit, instance_id): Hit.prim_id is the LIBRARY
    triangle id; instance_id the instance hit (-1 on a miss)."""
    library: InstancedLibrary
    pair_shape: torch.Tensor
    pair_inst: torch.Tensor
    pair_min: torch.Tensor
    pair_max: torch.Tensor
    sub_min: torch.Tensor
    sub_max: torch.Tensor
    inst_rows: torch.Tensor
    scene_lo: torch.Tensor
    scene_hi: torch.Tensor

    def _march_raw(self, o2, d2, t_min_a, t_max_a, any_hit: bool):
        """Morton-sorted instanced march -> (t, slot, u, v) in caller
        order."""
        key = ray_sort_keys(o2, d2, self.scene_lo, self.scene_hi)
        perm = torch.argsort(key, stable=True)
        packed = torch.cat([o2, d2, t_min_a[:, None], t_max_a[:, None]],
                           1)[perm]
        t, slot, u, v = block_march_instanced(
            self.pair_min, self.pair_max, self.sub_min, self.sub_max,
            self.pair_shape, self.pair_inst, self.inst_rows,
            self.library.woop_t, self.library.woop, packed[:, 0:3],
            packed[:, 3:6], packed[:, 6], packed[:, 7], any_hit=any_hit)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        return t[inv], slot[inv], u[inv], v[inv]

    def _to_hit(self, t, slot, u, v):
        """(t, slot, u, v) -> (Hit with LIBRARY prim ids, instance_id)."""
        missed = slot < 0
        pos = torch.clamp(slot, min=0).long()
        pair = pos // CLUSTER_TRIS
        lib_slot = self.pair_shape.long()[pair] * CLUSTER_TRIS \
            + pos % CLUSTER_TRIS
        prim_id = self.library.prim_index[lib_slot]
        inst_id = torch.where(missed, -1, self.pair_inst[pair])
        zero = torch.zeros_like(u)
        hit = Hit(
            t=torch.where(missed, torch.full_like(t, INF), t),
            prim_type=torch.where(missed, PRIM_NONE, PRIM_TRIANGLE
                                  ).to(torch.int32),
            prim_id=torch.where(missed, 0, prim_id).to(torch.int32),
            u=torch.where(missed, zero, u), v=torch.where(missed, zero, v))
        return hit, inst_id.to(torch.int32)

    def _bounds(self, o2, t_min, t_max):
        n = o2.shape[0]
        return ray_bound(t_min, n, o2.device), ray_bound(t_max, n, o2.device)

    def intersect(self, o, d, t_min=DEFAULT_T_MIN, t_max=INF,
                  _any_hit: bool = False):
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        t_min_a, t_max_a = self._bounds(o2, t_min, t_max)
        return self._to_hit(*self._march_raw(o2, d2, t_min_a, t_max_a,
                                             _any_hit))

    def intersect_from(self, o, d, mode: str = "origin", point=None,
                       t_min=DEFAULT_T_MIN, t_max=INF,
                       any_hit: bool = False, block_rays: int = 1024,
                       pc_max: int | None = None):
        """Common-point TLAS wave through the pair-binned raster
        (``ops/raster_instanced.py``, kernel D); rays in a screen-tile
        layout.  Exact at any pair count: when the schedule overflows
        ``pc_max``, the whole wave goes to the sorted marcher (one host
        read of the overflow flag; the JAX package selects on the device).

        Occlusion waves in "target" mode are re-traced FROM the common
        point (segment reversal, as ``MarchIntersector.intersect_from``);
        only ``is_hit`` is meaningful then.  Returns (Hit, instance_id)."""
        from optix_ray_tracer_tpu_torch.ops.raster_instanced import (
            instanced_raster_query,
        )

        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        t_min_a, t_max_a = self._bounds(o2, t_min, t_max)
        if any_hit and mode == "target":
            p = torch.as_tensor(point, dtype=torch.float32, device=o2.device)
            dist = dot(p[None, :] - o2, d2)
            o2 = p.expand(o2.shape)
            d2 = -d2
            t_min_a, t_max_a = dist - t_max_a, dist - t_min_a
            mode = "origin"
        t, slot, u, v, ok = instanced_raster_query(
            self, o2, d2, t_min_a, t_max_a, mode=mode, point=point,
            any_hit=any_hit, block_rays=block_rays, pc_max=pc_max)
        if not ok:
            t, slot, u, v = self._march_raw(o2, d2, t_min_a, t_max_a,
                                            any_hit)
        return self._to_hit(t, slot, u, v)

    def any_hit_from(self, o, d, mode: str = "target", point=None,
                     t_min=DEFAULT_T_MIN, t_max=INF,
                     block_rays: int = 1024, pc_max: int | None = None):
        """Occlusion variant of :meth:`intersect_from`."""
        hit, _ = self.intersect_from(
            o, d, mode=mode, point=point, t_min=t_min, t_max=t_max,
            any_hit=True, block_rays=block_rays, pc_max=pc_max)
        return hit.is_hit

    def any_hit(self, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        hit, _ = self.intersect(o, d, t_min, t_max, _any_hit=True)
        return hit.is_hit


def make_instanced_intersector(library: InstancedLibrary, shape_ids, rot,
                               shift, scale=1.0, valid=None
                               ) -> InstancedMarchIntersector:
    """The frame's TLAS intersector from instance poses, on the library's
    device."""
    dev = library.woop_t.device
    pair_shape, pair_inst = make_pairs(library, shape_ids)
    P = np.asarray(shape_ids).reshape(-1).shape[0]
    if valid is None:
        valid = torch.ones((P,), dtype=torch.bool, device=dev)
    pmin, pmax, smin, smax, inst_rows = refit_instanced(
        library, pair_shape, pair_inst, rot, shift, scale, valid)
    lo, hi = scene_bounds(pmin, pmax)
    return InstancedMarchIntersector(
        library=library, pair_shape=pair_shape, pair_inst=pair_inst,
        pair_min=pmin, pair_max=pmax, sub_min=smin, sub_max=smax,
        inst_rows=inst_rows, scene_lo=lo, scene_hi=hi)
