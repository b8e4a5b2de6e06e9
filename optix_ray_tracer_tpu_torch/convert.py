"""State conversion: the JAX package's state, handed over as numpy arrays,
into this package's tensors.

``state_arrays`` flattens any dataclass (a JAX pytree dataclass included)
into a dict of numpy arrays keyed by field name, nested dataclasses into
nested dicts; it touches no JAX API.  The other functions build the
port's counterparts from such dicts, so tests can give both packages the
very same acceleration structure (flat or two-level, with one frame's
refit state), scene, materials and camera.  Each builds on ``device``
(None: the card, see ``utils.tensors.resolve_device``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.instanced import (
    InstancedLibrary, InstancedMarchIntersector,
)
from optix_ray_tracer_tpu_torch.ops.intersect import Hit
from optix_ray_tracer_tpu_torch.ops.march import (
    MarchIntersector, march_intersector_from_clusters,
)
from optix_ray_tracer_tpu_torch.ops.sweep import ClusterSet, SweepIntersector
from optix_ray_tracer_tpu_torch.ops.tlas import TLASSceneIntersector
from optix_ray_tracer_tpu_torch.render.film import Film
from optix_ray_tracer_tpu_torch.render.neural_denoise import KPCN
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialTable
from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device

#: the seven arrays of a ClusterSet
CLUSTER_FIELDS = tuple(f.name for f in dataclasses.fields(ClusterSet))


def state_arrays(obj) -> dict:
    """Field name -> numpy array (or nested dict, or the plain value) for
    any dataclass instance."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if dataclasses.is_dataclass(val):
            out[f.name] = state_arrays(val)
        elif val is None or isinstance(val, (bool, int, float, str)):
            out[f.name] = val
        else:
            out[f.name] = np.asarray(val)
    return out


def _t(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=dev)


def clusters(arrays: dict, device=None) -> ClusterSet:
    """ClusterSet from its seven arrays (``CLUSTER_FIELDS``)."""
    dev = resolve_device(device)
    return ClusterSet(**{k: _t(arrays[k], dev) for k in CLUSTER_FIELDS})


def scene(arrays: dict, device=None) -> Scene:
    """Scene from {"spheres": {...}, "triangles": {...}} arrays."""
    dev = resolve_device(device)
    s, t = arrays["spheres"], arrays["triangles"]
    uvs = t.get("uvs")
    return Scene(
        spheres=Spheres(_t(s["centers"], dev).float(),
                        _t(s["radii"], dev).float(),
                        _t(s["material_id"], dev).to(torch.int32)),
        triangles=Triangles(_t(t["vertices"], dev).float(),
                            _t(t["normals"], dev).float(),
                            _t(t["material_id"], dev).to(torch.int32),
                            None if uvs is None else _t(uvs, dev).float()))


def hit(arrays: dict, device=None) -> Hit:
    """Hit from its arrays (prim_type, prim_id as int32)."""
    return _tensors(arrays, Hit, resolve_device(device))


def materials(arrays: dict, device=None) -> MaterialTable:
    dev = resolve_device(device)
    return MaterialTable(mtype=_t(arrays["mtype"], dev).to(torch.int32),
                         albedo=_t(arrays["albedo"], dev).float(),
                         param=_t(arrays["param"], dev).float(),
                         emission=_t(arrays["emission"], dev).float())


def camera(arrays: dict, device=None) -> Camera:
    dev = resolve_device(device)
    return Camera(**{k: _t(arrays[k], dev).float()
                     for k in ("center", "u", "v", "w", "up", "target")},
                  aperture=float(arrays.get("aperture", 0.0)),
                  focus_dist=float(arrays.get("focus_dist", -1.0)))


def march_intersector(cluster_arrays: dict, scene_: Scene,
                      raster: bool = True, device=None) -> MarchIntersector:
    """A MarchIntersector over the given ClusterSet arrays (built by either
    package) for ``scene_``, with raster tables when ``raster``."""
    return march_intersector_from_clusters(clusters(cluster_arrays, device),
                                           scene_, raster=raster)


def sweep_intersector(arrays: dict, device=None) -> SweepIntersector:
    """SweepIntersector from a JAX ``SweepIntersector``'s arrays (its
    ``use_pallas`` flag has no counterpart: the device decides)."""
    return SweepIntersector(clusters=clusters(arrays["clusters"], device))


def film(arrays: dict, device=None) -> Film:
    """Film from a JAX ``Film``'s arrays (the sample count as an int)."""
    dev = resolve_device(device)
    return Film(**{k: _t(arrays[k], dev).float()
                   for k in ("accum", "albedo_accum", "normal_accum")},
                spp=int(arrays["spp"]))


def kpcn(params: dict, device=None) -> KPCN:
    """The KPCN module from the JAX package's HWIO parameter arrays."""
    return KPCN.from_arrays({k: np.asarray(v) for k, v in params.items()},
                            device)


def _tensors(arrays: dict, cls, dev: torch.device, **nested):
    """``cls`` from its fields' arrays on ``dev``; ``nested`` converts
    dataclass fields (given the arrays and ``dev``), integer arrays stay
    integer (int32)."""
    out = {}
    for f in dataclasses.fields(cls):
        val = arrays[f.name]
        if f.name in nested:
            out[f.name] = nested[f.name](val, dev)
        elif isinstance(val, np.ndarray) and val.dtype.kind in "iu":
            out[f.name] = _t(val, dev).to(torch.int32)
        else:
            out[f.name] = _t(val, dev).float()
    return cls(**out)


def _keep(val, dev):
    return val


def instanced_library(arrays: dict, device=None) -> InstancedLibrary:
    """InstancedLibrary from its arrays (``shape_cluster_offset`` comes
    back as the host tuple)."""
    sco = tuple(int(x) for x in np.asarray(arrays["shape_cluster_offset"]))
    return _tensors(dict(arrays, shape_cluster_offset=sco), InstancedLibrary,
                    resolve_device(device), shape_cluster_offset=_keep)


def instanced_intersector(arrays: dict,
                          device=None) -> InstancedMarchIntersector:
    """InstancedMarchIntersector (library, pair arrays and one frame's
    refit state) from its arrays."""
    return _tensors(arrays, InstancedMarchIntersector,
                    resolve_device(device), library=instanced_library)


def tlas_intersector(arrays: dict, device=None) -> TLASSceneIntersector:
    """TLASSceneIntersector from its arrays (the JAX one has no
    ``pc_max``: the heuristic, as there)."""
    return _tensors(dict(arrays, pc_max=arrays.get("pc_max")),
                    TLASSceneIntersector, resolve_device(device),
                    tlas=instanced_intersector, pc_max=_keep)
