"""Material table (port of ``optix_ray_tracer_tpu/scene/materials.py``).

Materials live in one SoA table; shading gathers rows by material id and
blends the BSDF branches with masks."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)

ROUGH = 0       # Lambertian
METAL = 1       # mirror + fuzz
DIELECTRIC = 2  # glass, Schlick fresnel
EMISSIVE = 3    # diffuse emitter


@dataclasses.dataclass(frozen=True)
class MaterialTable(TensorDataclass):
    """mtype (M,) int32, albedo (M, 3), param (M,) (fuzz or ior),
    emission (M, 3)."""
    mtype: torch.Tensor
    albedo: torch.Tensor
    param: torch.Tensor
    emission: torch.Tensor

    @property
    def count(self) -> int:
        return self.mtype.shape[0]

    def gather(self, material_id):
        """(mtype, albedo, param, emission) rows for a batch of hits."""
        mid = torch.clamp(material_id, 0, self.count - 1).long()
        return (self.mtype[mid], self.albedo[mid], self.param[mid],
                self.emission[mid])


class MaterialBuilder:
    """Host-side accumulation of materials into one table."""

    def __init__(self) -> None:
        self._rows: list[tuple[int, tuple, float, tuple]] = []

    def __len__(self) -> int:
        return len(self._rows)

    def add(self, mtype: int, albedo, param: float = 0.0,
            emission=(0.0, 0.0, 0.0)) -> int:
        self._rows.append((mtype, tuple(albedo), float(param),
                           tuple(emission)))
        return len(self._rows) - 1

    def add_rough(self, albedo) -> int:
        return self.add(ROUGH, albedo)

    def add_metal(self, albedo, fuzz: float = 0.0) -> int:
        return self.add(METAL, albedo, fuzz)

    def add_dielectric(self, ior: float = 1.5) -> int:
        return self.add(DIELECTRIC, (1.0, 1.0, 1.0), ior)

    def add_emissive(self, emission) -> int:
        return self.add(EMISSIVE, (0.0, 0.0, 0.0), 0.0, emission)

    def build(self, device=None) -> MaterialTable:
        if not self._rows:
            self.add_rough((0.5, 0.5, 0.5))
        rows = self._rows
        dev = resolve_device(device)

        def col(k, dtype):
            return torch.as_tensor(np.asarray([r[k] for r in rows], dtype),
                                   device=dev)
        return MaterialTable(mtype=col(0, np.int32), albedo=col(1, np.float32),
                             param=col(2, np.float32),
                             emission=col(3, np.float32))
