"""Area lights for next-event estimation (port of
``optix_ray_tracer_tpu/scene/lights.py``).

The reference's Whitted tracer is lit by its miss color alone; the path
tracer samples emissive triangles, collected from the scene's material
table on the host at commit, by a power-weighted CDF, with solid-angle
pdfs for multiple importance sampling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.scene.materials import (
    EMISSIVE, MaterialTable,
)
from optix_ray_tracer_tpu_torch.utils import rng
from optix_ray_tracer_tpu_torch.utils.color import luminance
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass
from optix_ray_tracer_tpu_torch.utils.vecmath import dot, length_squared


@dataclasses.dataclass(frozen=True)
class AreaLights(TensorDataclass):
    """Emissive-triangle table (SoA).

    v0, e1, e2: (L, 3) triangle base and edges; normal: (L, 3) unit
    geometric normals; emission: (L, 3); area: (L,); cdf: (L,) selection
    CDF (power-weighted by default, last entry 1); tri_id: (L,) source
    triangle; total_area: () ; pdf_scale: (L,) area-measure pdf of a point
    on light i, P(select i) / area_i; tri_light_idx: (T,) scene triangle ->
    light row (-1 for non-emissive triangles), the MIS lookup for
    BSDF-sampled emitter hits."""
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor
    area: torch.Tensor
    cdf: torch.Tensor
    tri_id: torch.Tensor
    total_area: torch.Tensor
    pdf_scale: torch.Tensor
    tri_light_idx: torch.Tensor

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def collect_area_lights(scene: Scene, materials: MaterialTable,
                        power_weighted: bool = True) -> AreaLights | None:
    """Gather every emissive triangle on the host (at scene commit) into
    an :class:`AreaLights` on the scene's device; None without any.
    ``power_weighted`` selects lights by area x luminance instead of by
    area (the same when all emitters share one radiance)."""
    if scene.triangle_count == 0:
        return None
    dev = scene.triangles.vertices.device
    mtypes = materials.mtype.cpu().numpy()
    mids = scene.triangles.material_id.cpu().numpy()
    emissive = mtypes[np.clip(mids, 0, len(mtypes) - 1)] == EMISSIVE
    ids = np.where(emissive)[0]
    if len(ids) == 0:
        return None
    verts = scene.triangles.vertices.cpu().numpy()[ids]
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=-1)
    normal = n / np.maximum(area2[:, None], 1e-30)
    area = 0.5 * area2
    emission = materials.emission.cpu().numpy()[mids[ids]]
    total = float(area.sum())
    lum = luminance(emission.astype(np.float32))
    weight = area * lum if power_weighted and float(lum.max()) > 0.0 else area
    total_weight = float(weight.sum())
    cdf = np.cumsum(weight) / max(total_weight, 1e-30)
    pdf_scale = weight / np.maximum(total_weight * area, 1e-30)
    tri_light_idx = np.full(scene.triangle_count, -1, np.int32)
    tri_light_idx[ids] = np.arange(len(ids), dtype=np.int32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return AreaLights(
        v0=f32(v0), e1=f32(e1), e2=f32(e2), normal=f32(normal),
        emission=f32(emission), area=f32(area), cdf=f32(cdf),
        tri_id=torch.as_tensor(ids.astype(np.int32), device=dev),
        total_area=f32(total), pdf_scale=f32(pdf_scale),
        tri_light_idx=torch.as_tensor(tri_light_idx, device=dev))


def sample_lights(lights: AreaLights, shading_point, pixel_id, sample,
                  bounce, seed, mode: str = "pcg"):
    """One point on the light set per shading point (``mode``: the
    sampler, ``utils/rng.uniform4``).

    Returns (direction (R, 3) unit, distance (R,), pdf_solid_angle (R,),
    emitted (R, 3), cosine at the light (R,)); the pdf is 0 where the
    light is seen edge-on.  Emitters are two-sided."""
    u1, u2, u3, _ = rng.uniform4(pixel_id, sample, bounce, seed, mode)
    if mode == "sobol":
        # the barycentric pair takes the strict (0, 2)-sequence dimensions
        # (components 0, 1); the discrete CDF pick rides dimension 2
        u1, u2, u3 = u3, u1, u2
    # searchsorted's left side, as jnp.searchsorted's default
    li = torch.clamp(torch.searchsorted(lights.cdf, u1), 0,
                     lights.count - 1)
    v0, e1, e2 = lights.v0[li], lights.e1[li], lights.e2[li]
    # uniform barycentrics (square-root warp)
    su = torch.sqrt(torch.clamp(u2, min=1e-12))[..., None]
    b1 = 1.0 - su
    b2 = u3[..., None] * su
    point = v0 + b1 * e1 + b2 * e2

    to_light = point - shading_point
    dist2 = length_squared(to_light)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    w = to_light / dist[..., None]
    cos_light = torch.abs(-dot(w, lights.normal[li]))
    # area pdf pdf_scale[li] -> solid angle: dist^2 * scale / cos
    pdf = dist2 * lights.pdf_scale[li] / torch.clamp(cos_light, min=1e-12)
    pdf = torch.where(cos_light > 1e-6, pdf, 0.0)
    return w, dist, pdf, lights.emission[li], cos_light


def light_pdf_solid_angle(lights: AreaLights, hit_tri_id, is_triangle,
                          direction, hit_t):
    """The solid-angle pdf with which :func:`sample_lights` would have
    produced this BSDF-sampled hit on an emissive triangle (0 for hits
    outside the light table).  The cosine uses the table's geometric
    normal, the one :func:`sample_lights` uses, so the two strategies'
    balance-heuristic weights sum to 1."""
    n_tris = lights.tri_light_idx.shape[0]
    tid = torch.clamp(hit_tri_id, 0, max(n_tris - 1, 0)).long()
    li = lights.tri_light_idx[tid]
    is_light = is_triangle & (li >= 0)
    lc = torch.clamp(li, min=0).long()
    scale = torch.where(is_light, lights.pdf_scale[lc], 0.0)
    cos_light = torch.abs(dot(direction, lights.normal[lc]))
    pdf = hit_t * hit_t * scale / torch.clamp(cos_light, min=1e-12)
    return torch.where(cos_light > 1e-6, pdf, 0.0)
