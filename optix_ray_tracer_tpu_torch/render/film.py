"""Film: the accumulation buffer on the device, image output and
checkpointing (port of ``optix_ray_tracer_tpu/render/film.py``).

A frame is a device tensor that accumulates radiance across samples;
the host fetches it once per flush and writes PNG or PPM files.  A
checkpoint (npz with the keys ``accum``, ``albedo``, ``normal``, ``spp``
plus an optional JSON sidecar) is the JAX package's format, so either
package restores the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.color import (
    color_to_uint8, write_png, write_ppm,
)
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)


def _save(path: str, img) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, img)
    else:
        write_png(path, img)


def _inv_spp(spp: int) -> np.float32:
    """1 / max(spp, 1) rounded as float32 division rounds it."""
    return np.float32(1.0) / np.float32(max(spp, 1))


def save_aov_images(prefix: str, albedo_mean, normal_mean) -> list[str]:
    """Write the denoiser guides as ``<prefix>_albedo.png`` (sRGB-encoded
    mean albedo) and ``<prefix>_normal.png`` (normals mapped to
    ``(n + 1) / 2``, stored linearly)."""
    alb_path, nrm_path = prefix + "_albedo.png", prefix + "_normal.png"
    write_png(alb_path, color_to_uint8(albedo_mean))
    n01 = torch.clamp(normal_mean * 0.5 + 0.5, 0.0, 1.0)
    write_png(nrm_path, torch.clamp((n01 * 256.0).to(torch.int64), max=255
                                    ).to(torch.uint8))
    return [alb_path, nrm_path]


@dataclasses.dataclass(frozen=True)
class U8Frame:
    """A frame quantized to sRGB uint8 on the device before the host
    fetch: (H, W, 4) uint8 on the host."""
    rgba: np.ndarray
    spp: int = 1

    def to_uint8(self) -> np.ndarray:
        return np.asarray(self.rgba)

    def save(self, path: str) -> None:
        _save(path, self.to_uint8())


@dataclasses.dataclass(frozen=True)
class Film(TensorDataclass):
    """Accumulated radiance (H, W, 3), albedo and normal guide sums, and
    the host count of samples accumulated so far."""
    accum: torch.Tensor
    albedo_accum: torch.Tensor
    normal_accum: torch.Tensor
    spp: int = 0

    @staticmethod
    def create(width: int, height: int, device=None) -> "Film":
        z = torch.zeros((height, width, 3), device=resolve_device(device))
        return Film(accum=z, albedo_accum=z, normal_accum=z, spp=0)

    def add(self, radiance, albedo=None, normal=None,
            samples: int = 1) -> "Film":
        """Accumulate a (H, W, 3) per-sample-mean estimate computed from
        ``samples`` samples."""
        s = int(samples)
        zero = torch.zeros_like(self.accum)
        return Film(
            accum=self.accum + radiance * s,
            albedo_accum=self.albedo_accum + (albedo * s if albedo is not None
                                              else zero),
            normal_accum=self.normal_accum + (normal * s if normal is not None
                                              else zero),
            spp=self.spp + s)

    def mean(self):
        return self.accum * _inv_spp(self.spp)

    def to_uint8(self) -> np.ndarray:
        """sRGB-encoded RGBA uint8 frame (host)."""
        return color_to_uint8(self.mean()).cpu().numpy()

    def save(self, path: str) -> None:
        _save(path, self.to_uint8())

    def save_aovs(self, prefix: str) -> list[str]:
        """Write this film's guides via :func:`save_aov_images` (zero
        unless the render path carried them)."""
        inv = _inv_spp(self.spp)
        return save_aov_images(prefix, self.albedo_accum * inv,
                               self.normal_accum * inv)

    def checkpoint(self, path: str, meta: dict | None = None) -> None:
        """Persist the accumulation state (npz + optional JSON sidecar)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, accum=self.accum.cpu().numpy(),
                 albedo=self.albedo_accum.cpu().numpy(),
                 normal=self.normal_accum.cpu().numpy(), spp=int(self.spp))
        if meta is not None:
            with open(path + ".json", "w") as f:
                json.dump(meta, f)

    @staticmethod
    def restore(path: str, device=None) -> "Film":
        dev = resolve_device(device)
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            return Film(accum=torch.as_tensor(z["accum"], device=dev),
                        albedo_accum=torch.as_tensor(z["albedo"], device=dev),
                        normal_accum=torch.as_tensor(z["normal"], device=dev),
                        spp=int(z["spp"]))
