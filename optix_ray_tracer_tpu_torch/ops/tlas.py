"""Integrator-facing TLAS scene intersector (port of
``optix_ray_tracer_tpu/ops/tlas.py``).

Adapts the two-level engine (``ops/instanced.py``: the pair-binned TLAS
raster for camera and point-light waves, kernel D; the sorted TLAS
marcher for everything else, kernel E) to the ``MarchIntersector`` API
that ``render/wavefront.py`` consumes:

* hits map to a VIRTUAL flattened prim-id space, the id each triangle
  would have in the Time frontend's packed flatten layout, so the
  integrators see the flatten route's id contract while no flattened
  geometry exists;
* shading gathers lazily: two int32 tables recover (library triangle,
  instance) from a virtual id, and the shading normal is the object-space
  library normal rotated by the instance pose at gather time;
* static extras (ground planes, spheres) stay a small real ``Scene``,
  traced by the brute-force oracle and merged by nearest t; their virtual
  ids follow the dynamic block, as in the flatten route's layout.

``ops.intersect.shading_frame_fn`` picks ``shading_frame`` below.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops import intersect as isect
from optix_ray_tracer_tpu_torch.ops.instanced import (
    InstancedMarchIntersector,
)
from optix_ray_tracer_tpu_torch.ops.intersect import (
    DEFAULT_T_MIN, PRIM_TRIANGLE, Hit,
)
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot


def _merge_nearest(hd: Hit, hs: Hit) -> Hit:
    """Nearest-t merge of the dynamic (TLAS) and static (brute) hits; on a
    tie the static hit wins."""
    take_d = hd.t < hs.t
    return Hit(*(torch.where(take_d, a, b) for a, b in (
        (hd.t, hs.t), (hd.prim_type, hs.prim_type),
        (hd.prim_id, hs.prim_id), (hd.u, hs.u), (hd.v, hs.v))))


@dataclasses.dataclass(frozen=True)
class TLASSceneIntersector(TensorDataclass):
    """TLAS intersector + lazy instanced shading.

    tlas:         the frame's two-level engine (refit per frame)
    tri_lib:      (T_pack,) int32 virtual slot -> library triangle id
    tri_inst:     (T_pack,) int32 virtual slot -> instance id
    inst_base:    (P,) int32 instance -> first virtual slot
    inst_tri_off: (P,) int32 instance -> its shape's library tri offset
    lib_normals:  (L, 3, 3) object-space library vertex normals
    rot:          (P, 3, 3) instance object->world rotations
    pmat:         (P,) int32 instance material ids
    pc_max:       schedule capacity of common-point waves whose caller
                  passes none (None: the binning's heuristic); a frame
                  builder sets it from a measured pair count

    The ``scene`` argument of every query and shading call is the STATIC
    extras scene only.  Virtual ids: the dynamic block [0, T_pack) first,
    static triangles after."""
    tlas: InstancedMarchIntersector
    tri_lib: torch.Tensor
    tri_inst: torch.Tensor
    inst_base: torch.Tensor
    inst_tri_off: torch.Tensor
    lib_normals: torch.Tensor
    rot: torch.Tensor
    pmat: torch.Tensor
    pc_max: int | None = None

    @property
    def n_dynamic(self) -> int:
        return self.tri_lib.shape[0]

    @property
    def raster(self):
        """Non-None marks camera waves raster-routable
        (``ops.raster.camera_tile_layout``)."""
        return self.tlas

    def for_incoherent(self):
        """Bounce waves: the TLAS marcher sorts rays itself."""
        return self

    # -- hit-space mapping ------------------------------------------------
    def _to_virtual(self, hit: Hit, inst_id) -> Hit:
        """(library prim, instance) -> virtual flattened prim id."""
        ii = torch.clamp(inst_id, min=0).long()
        virt = self.inst_base[ii] + (hit.prim_id - self.inst_tri_off[ii])
        return dataclasses.replace(hit, prim_id=torch.where(
            inst_id >= 0, virt, 0).to(torch.int32))

    def _static_shift(self, hs: Hit) -> Hit:
        """Static triangle ids follow the dynamic block."""
        is_tri = hs.prim_type == PRIM_TRIANGLE
        return dataclasses.replace(hs, prim_id=torch.where(
            is_tri, hs.prim_id + self.n_dynamic, hs.prim_id
        ).to(torch.int32))

    # -- queries (the MarchIntersector API) -------------------------------
    def intersect(self, scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF,
                  _any_hit: bool = False) -> Hit:
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        hd = self._to_virtual(*self.tlas.intersect(o2, d2, t_min, t_max,
                                                   _any_hit))
        hs = self._static_shift(isect.intersect_scene_bruteforce(
            scene, o2, d2, t_min, t_max))
        return _merge_nearest(hd, hs).reshape(o.shape[:-1])

    def __call__(self, scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        occ = (self.tlas.any_hit(o2, d2, t_min, t_max)
               | isect.intersect_any_bruteforce(scene, o2, d2, t_min, t_max))
        return occ.reshape(o.shape[:-1])

    def intersect_from(self, scene, o, d, mode: str = "origin",
                       point=None, t_min=DEFAULT_T_MIN, t_max=INF,
                       any_hit: bool = False, block_rays: int = 1024,
                       pc_max: int | None = None) -> Hit:
        """Common-point wave via the pair-binned TLAS raster (falling back
        to the exact TLAS marcher on a schedule overflow), merged with the
        static extras."""
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        hd = self._to_virtual(*self.tlas.intersect_from(
            o2, d2, mode=mode, point=point, t_min=t_min, t_max=t_max,
            any_hit=any_hit, block_rays=block_rays,
            pc_max=pc_max or self.pc_max))
        if any_hit:
            # the any-hit contract: only is_hit is meaningful
            occ = isect.intersect_any_bruteforce(scene, o2, d2, t_min, t_max)
            zero = torch.zeros_like(hd.u)
            hs = Hit(t=torch.where(occ, zero, torch.full_like(zero, INF)),
                     prim_type=torch.where(occ, PRIM_TRIANGLE,
                                           isect.PRIM_NONE).to(torch.int32),
                     prim_id=torch.zeros_like(hd.prim_id), u=zero, v=zero)
        else:
            hs = self._static_shift(isect.intersect_scene_bruteforce(
                scene, o2, d2, t_min, t_max))
        return _merge_nearest(hd, hs).reshape(o.shape[:-1])

    def any_hit_from(self, scene, o, d, mode: str = "target", point=None,
                     t_min=DEFAULT_T_MIN, t_max=INF,
                     block_rays: int = 1024, pc_max: int | None = None):
        return self.intersect_from(
            scene, o, d, mode=mode, point=point, t_min=t_min, t_max=t_max,
            any_hit=True, block_rays=block_rays, pc_max=pc_max).is_hit

    # -- lazy instanced shading -------------------------------------------
    def shading_frame(self, scene, o, d, hit: Hit):
        """``ops.intersect.shading_frame``'s contract (point, normal,
        front_face, material_id), dynamic hits shaded from the LIBRARY:
        object-space normals gathered and rotated by the instance pose."""
        nd = self.n_dynamic
        is_tri = hit.prim_type == PRIM_TRIANGLE
        dynamic = is_tri & (hit.prim_id < nd)

        # static lanes through the plain scene tables (ids shifted back)
        hs = dataclasses.replace(hit, prim_id=torch.where(
            is_tri, torch.clamp(hit.prim_id - nd, min=0), hit.prim_id))
        point, n_s, ff_s, m_s = isect.shading_frame(scene, o, d, hs)

        # dynamic lanes: lazy (library, instance) gather + pose rotation
        slot = torch.clamp(hit.prim_id, 0, max(nd - 1, 0)).long()
        ii = self.tri_inst[slot].long()
        n123 = self.lib_normals[self.tri_lib[slot].long()]     # (R, 3, 3)
        r = self.rot[ii][..., None, :, :]                     # (R, 1, 3, 3)
        n123w = torch.stack([(r[..., i, 0] * n123[..., 0]
                              + r[..., i, 1] * n123[..., 1])
                             + r[..., i, 2] * n123[..., 2]
                             for i in range(3)], -1)
        w = (1.0 - hit.u - hit.v)[..., None]
        n_d = (w * n123w[..., 0, :] + hit.u[..., None] * n123w[..., 1, :]
               + hit.v[..., None] * n123w[..., 2, :])
        m_d = self.pmat[ii]
        # two-sided flip for the dynamic lanes only (the static path has
        # flipped its own, and its front_face feeds dielectrics)
        ff_d = dot(d, n_d) < 0.0
        n_d = torch.where(ff_d[..., None], n_d, -n_d)
        return (point, torch.where(dynamic[..., None], n_d, n_s),
                torch.where(dynamic, ff_d, ff_s),
                torch.where(dynamic, m_d, m_s))
