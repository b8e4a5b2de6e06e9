"""UVW pinhole / thin-lens camera (port of
``optix_ray_tracer_tpu/scene/camera.py``; the fly-camera controller waits).

``W = target - center`` (not normalized: |W| sets the field of view),
``U = normalize(cross(W, up))``, ``V = normalize(cross(U, W))``; pixel
directions ``normalize(ndc_x*aspect*U + ndc_y*V + W)`` with image row 0 at
the top.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import (
    cross, dot, length, normalize,
)


@dataclasses.dataclass(frozen=True)
class Camera(TensorDataclass):
    """center, u, v, w, up, target: (3,) float32 tensors.  ``aperture`` is
    the lens radius (0 = pinhole); ``focus_dist`` <= 0 focuses at |w|."""
    center: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    up: torch.Tensor
    target: torch.Tensor
    aperture: float = 0.0
    focus_dist: float = -1.0

    @staticmethod
    def look_at(center, target, up, aperture: float = 0.0,
                focus_dist: float = -1.0, device=None) -> "Camera":
        dev = resolve_device(device)
        center = torch.as_tensor(center, dtype=torch.float32, device=dev)
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        up = normalize(torch.as_tensor(up, dtype=torch.float32, device=dev))
        w = target - center
        u = normalize(cross(w, up))
        v = normalize(cross(u, w))
        return Camera(center=center, u=u, v=v, w=w, up=up, target=target,
                      aperture=float(aperture), focus_dist=float(focus_dist))

    def generate_rays(self, width: int, height: int, jitter=None,
                      lens_uv=None):
        """Primary rays for every pixel; ``jitter`` optional (..., H, W, 2)
        subpixel offsets, ``lens_uv`` optional (..., 2) unit-disk samples.
        Returns (origins, directions) of shape (..., H, W, 3)."""
        dev = self.center.device
        iy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
        ix = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        if jitter is None:
            ox = oy = 0.5
        else:
            ox = jitter[..., 0]
            oy = jitter[..., 1]
        ndc_x = ((ix + ox) / width) * 2.0 - 1.0
        ndc_y = 1.0 - ((iy + oy) / height) * 2.0
        ndc_x, ndc_y = torch.broadcast_tensors(ndc_x, ndc_y)
        aspect = width / height
        d = (ndc_x[..., None] * aspect * self.u
             + ndc_y[..., None] * self.v + self.w)
        directions = normalize(d)
        origins = self.center.expand(directions.shape)
        if lens_uv is not None:
            origins, directions = self.apply_lens(origins, directions,
                                                  lens_uv)
        return origins, directions

    def apply_lens(self, origins, directions, lens_uv):
        """Thin lens: jitter origins on the aperture disk and re-aim at the
        focus plane; a pinhole camera returns its inputs untouched."""
        if self.aperture <= 0.0:
            return origins, directions
        f = (self.focus_dist if self.focus_dist > 0.0
             else float(length(self.w)))
        w_unit = normalize(self.w)
        cos_w = torch.clamp(dot(directions, w_unit, keepdims=True), min=1e-6)
        p_focus = origins + directions * (f / cos_w)
        offset = self.aperture * (lens_uv[..., 0:1] * self.u
                                  + lens_uv[..., 1:2] * self.v)
        o2 = origins + offset
        return o2, normalize(p_focus - o2)
