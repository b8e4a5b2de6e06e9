"""Wavefront coherence keys and the sphere merge (port of
``optix_ray_tracer_tpu/ops/raysort.py``)."""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops.bvh import morton_codes
from optix_ray_tracer_tpu_torch.ops.intersect import (
    PRIM_SPHERE, Hit, ray_sphere_block,
)
from optix_ray_tracer_tpu_torch.scene.geometry import Scene


def ray_sort_keys(o, d, scene_lo, scene_hi):
    """Coarse origin Morton (high bits) + direction Morton (low bits), as
    int64 holding the JAX package's uint32 keys."""
    o_morton = morton_codes(o, scene_lo, scene_hi)
    unit = torch.ones(3, device=d.device)
    d_morton = morton_codes(d, -unit, unit)
    return ((o_morton >> 18) << 20) | (d_morton >> 10)


def probe_sort_keys(cid, d):
    """(first-cluster id << 18) | direction Morton >> 12, as int64 holding
    the JAX package's uint32 keys; ``cid`` is kernel C's answer."""
    unit = torch.ones(3, device=d.device)
    return (cid.to(torch.int64) << 18) | (morton_codes(d, -unit, unit) >> 12)


def sphere_bruteforce_merge(scene: Scene, o, d, t_min, t_max,
                            hit: Hit) -> Hit:
    """Fold the (few) analytic spheres in with a dense test; ``t_min`` and
    ``t_max`` are (R,) tensors."""
    ts = ray_sphere_block(o, d, scene.spheres.centers, scene.spheres.radii,
                          t_min, t_max)
    si = torch.argmin(ts, dim=-1)
    st = torch.gather(ts, 1, si[:, None])[:, 0]
    closer = st < hit.t
    zero = torch.zeros_like(hit.u)
    return Hit(
        t=torch.where(closer, st, hit.t),
        prim_type=torch.where(closer, torch.full_like(hit.prim_type,
                                                      PRIM_SPHERE),
                              hit.prim_type),
        prim_id=torch.where(closer, si.to(torch.int32), hit.prim_id),
        u=torch.where(closer, zero, hit.u),
        v=torch.where(closer, zero, hit.v))
