"""State conversion: the JAX package's state, handed over as numpy arrays,
into this package's tensors.

``state_arrays`` flattens any dataclass (a JAX pytree dataclass included)
into a dict of numpy arrays keyed by field name, nested dataclasses into
nested dicts; it touches no JAX API.  The other functions build the
port's counterparts from such dicts, so tests can give both packages the
very same acceleration structure (flat or two-level, with one frame's
refit state), scene, materials and camera.
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
from optix_ray_tracer_tpu_torch.ops.sweep import ClusterSet
from optix_ray_tracer_tpu_torch.ops.tlas import TLASSceneIntersector
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialTable

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


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True))


def clusters(arrays: dict) -> ClusterSet:
    """ClusterSet from its seven arrays (``CLUSTER_FIELDS``)."""
    return ClusterSet(**{k: _t(arrays[k]) for k in CLUSTER_FIELDS})


def scene(arrays: dict) -> Scene:
    """Scene from {"spheres": {...}, "triangles": {...}} arrays."""
    s, t = arrays["spheres"], arrays["triangles"]
    uvs = t.get("uvs")
    return Scene(
        spheres=Spheres(_t(s["centers"]).float(), _t(s["radii"]).float(),
                        _t(s["material_id"]).to(torch.int32)),
        triangles=Triangles(_t(t["vertices"]).float(),
                            _t(t["normals"]).float(),
                            _t(t["material_id"]).to(torch.int32),
                            None if uvs is None else _t(uvs).float()))


def hit(arrays: dict) -> Hit:
    """Hit from its arrays (prim_type, prim_id as int32)."""
    return _tensors(arrays, Hit)


def materials(arrays: dict) -> MaterialTable:
    return MaterialTable(mtype=_t(arrays["mtype"]).to(torch.int32),
                         albedo=_t(arrays["albedo"]).float(),
                         param=_t(arrays["param"]).float(),
                         emission=_t(arrays["emission"]).float())


def camera(arrays: dict) -> Camera:
    return Camera(**{k: _t(arrays[k]).float()
                     for k in ("center", "u", "v", "w", "up", "target")},
                  aperture=float(arrays.get("aperture", 0.0)),
                  focus_dist=float(arrays.get("focus_dist", -1.0)))


def march_intersector(cluster_arrays: dict, scene_: Scene,
                      raster: bool = True) -> MarchIntersector:
    """A MarchIntersector over the given ClusterSet arrays (built by either
    package) for ``scene_``, with raster tables when ``raster``."""
    return march_intersector_from_clusters(clusters(cluster_arrays), scene_,
                                           raster=raster)


def _tensors(arrays: dict, cls, **nested):
    """``cls`` from its fields' arrays; ``nested`` converts dataclass
    fields, integer arrays stay integer (int32)."""
    out = {}
    for f in dataclasses.fields(cls):
        val = arrays[f.name]
        if f.name in nested:
            out[f.name] = nested[f.name](val)
        elif isinstance(val, np.ndarray) and val.dtype.kind in "iu":
            out[f.name] = _t(val).to(torch.int32)
        else:
            out[f.name] = _t(val).float()
    return cls(**out)


def instanced_library(arrays: dict) -> InstancedLibrary:
    """InstancedLibrary from its arrays (``shape_cluster_offset`` comes
    back as the host tuple)."""
    sco = tuple(int(x) for x in np.asarray(arrays["shape_cluster_offset"]))
    return _tensors(dict(arrays, shape_cluster_offset=sco), InstancedLibrary,
                    shape_cluster_offset=lambda x: x)


def instanced_intersector(arrays: dict) -> InstancedMarchIntersector:
    """InstancedMarchIntersector (library, pair arrays and one frame's
    refit state) from its arrays."""
    return _tensors(arrays, InstancedMarchIntersector,
                    library=instanced_library)


def tlas_intersector(arrays: dict) -> TLASSceneIntersector:
    """TLASSceneIntersector from its arrays (the JAX one has no
    ``pc_max``: the heuristic, as there)."""
    return _tensors(dict(arrays, pc_max=arrays.get("pc_max")),
                    TLASSceneIntersector, tlas=instanced_intersector,
                    pc_max=lambda x: x)
