"""Scene geometry as SoA tensors (port of
``optix_ray_tracer_tpu/scene/geometry.py``: flat scenes and the
``ShapeLibrary`` of the Time frontend; ``Instances`` and baked
instancing wait for the frontends slice).

Triangle vertices and normals are packed (T, 3, 3) float32.  Constructors
build their tensors on ``device`` (None: the card, see
``utils.tensors.resolve_device``); ``.to(device)`` moves a whole scene.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)


@dataclasses.dataclass(frozen=True)
class Spheres(TensorDataclass):
    """centers (S, 3), radii (S,), material_id (S,) int32."""
    centers: torch.Tensor
    radii: torch.Tensor
    material_id: torch.Tensor

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    @staticmethod
    def empty(device=None) -> "Spheres":
        dev = resolve_device(device)
        return Spheres(torch.zeros((0, 3), device=dev),
                       torch.zeros((0,), device=dev),
                       torch.zeros((0,), dtype=torch.int32, device=dev))

    @staticmethod
    def from_list(spheres: list[tuple], device=None) -> "Spheres":
        """spheres: [(center, radius, material_id), ...]."""
        dev = resolve_device(device)
        if not spheres:
            return Spheres.empty(dev)
        return Spheres(
            torch.as_tensor(np.asarray([s[0] for s in spheres], np.float32),
                            device=dev),
            torch.as_tensor(np.asarray([s[1] for s in spheres], np.float32),
                            device=dev),
            torch.as_tensor(np.asarray([s[2] for s in spheres], np.int32),
                            device=dev))


@dataclasses.dataclass(frozen=True)
class Triangles(TensorDataclass):
    """vertices (T, 3, 3), normals (T, 3, 3) per-vertex shading normals,
    material_id (T,) int32, uvs (T, 3, 2) or None."""
    vertices: torch.Tensor
    normals: torch.Tensor
    material_id: torch.Tensor
    uvs: torch.Tensor | None = None

    @property
    def count(self) -> int:
        return self.vertices.shape[0]

    @staticmethod
    def empty(device=None) -> "Triangles":
        dev = resolve_device(device)
        z = torch.zeros((0, 3, 3), device=dev)
        return Triangles(z, z, torch.zeros((0,), dtype=torch.int32,
                                           device=dev))

    @staticmethod
    def from_arrays(vertices, normals=None, material_id=0, uvs=None,
                    device=None) -> "Triangles":
        """Triangles from host arrays on ``device``; a vertex tensor given
        with no ``device`` keeps its own."""
        if device is None and isinstance(vertices, torch.Tensor):
            device = vertices.device
        vertices = torch.as_tensor(vertices, dtype=torch.float32,
                                   device=resolve_device(device)
                                   ).reshape(-1, 3, 3)
        if normals is None:
            normals = face_normals_as_vertex_normals(vertices)
        else:
            normals = torch.as_tensor(normals, dtype=torch.float32,
                                      device=vertices.device
                                      ).reshape(-1, 3, 3)
        mid = torch.as_tensor(material_id, dtype=torch.int32,
                              device=vertices.device
                              ).expand(vertices.shape[0]).contiguous()
        if uvs is not None:
            uvs = torch.as_tensor(uvs, dtype=torch.float32,
                                  device=vertices.device).reshape(-1, 3, 2)
        return Triangles(vertices, normals, mid, uvs)

    def concat(self, other: "Triangles") -> "Triangles":
        if self.uvs is None and other.uvs is None:
            uvs = None
        else:
            def _uv(t):
                return (t.uvs if t.uvs is not None else torch.zeros(
                    (t.count, 3, 2), device=t.vertices.device))
            uvs = torch.cat([_uv(self), _uv(other)], 0)
        return Triangles(
            torch.cat([self.vertices, other.vertices], 0),
            torch.cat([self.normals, other.normals], 0),
            torch.cat([self.material_id, other.material_id], 0), uvs)


def face_normals_as_vertex_normals(vertices):
    """Per-face geometric normals replicated to the 3 vertices."""
    e1 = vertices[:, 1] - vertices[:, 0]
    e2 = vertices[:, 2] - vertices[:, 0]
    n = torch.linalg.cross(e1, e2, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-30)
    return n[:, None, :].expand(vertices.shape).contiguous()


@dataclasses.dataclass(frozen=True)
class Scene(TensorDataclass):
    """A renderable world: spheres + triangles."""
    spheres: Spheres
    triangles: Triangles

    @property
    def sphere_count(self) -> int:
        return self.spheres.count

    @property
    def triangle_count(self) -> int:
        return self.triangles.count


@dataclasses.dataclass(frozen=True)
class ShapeLibrary(TensorDataclass):
    """Triangle meshes sharing one packed buffer: shape i owns rows
    [offsets[i], offsets[i] + counts[i]) of ``vertices``/``normals``
    (T, 3, 3).  ``offsets``/``counts`` are host int64 arrays."""
    vertices: torch.Tensor
    normals: torch.Tensor
    offsets: np.ndarray
    counts: np.ndarray

    @staticmethod
    def from_meshes(meshes: list[tuple[np.ndarray, np.ndarray]],
                    device=None) -> "ShapeLibrary":
        """meshes: list of (vertices (t, 3, 3), normals (t, 3, 3))."""
        dev = resolve_device(device)
        if not meshes:
            z = torch.zeros((0, 3, 3), device=dev)
            return ShapeLibrary(z, z, np.zeros(0, np.int64),
                                np.zeros(0, np.int64))
        counts = np.asarray([m[0].shape[0] for m in meshes], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        return ShapeLibrary(
            torch.as_tensor(np.concatenate(
                [np.asarray(m[0], np.float32) for m in meshes], 0),
                device=dev),
            torch.as_tensor(np.concatenate(
                [np.asarray(m[1], np.float32) for m in meshes], 0),
                device=dev),
            offsets, counts)

    @property
    def num_shapes(self) -> int:
        return len(self.counts)

    def shape(self, i: int) -> Triangles:
        lo = int(self.offsets[i])
        hi = lo + int(self.counts[i])
        return Triangles(self.vertices[lo:hi], self.normals[lo:hi],
                         torch.zeros((hi - lo,), dtype=torch.int32,
                                     device=self.vertices.device))
