"""Batched 3-vector math (port of ``optix_ray_tracer_tpu/utils/vecmath.py``).

Every function works over tensors whose last axis is the component axis.
Dot products are written out component by component so that their
summation order is fixed and matches the JAX package's.
"""

from __future__ import annotations

import torch

EPS = 1e-6
INF = 1e16      # the miss sentinel: a finite float, not float inf
PI = 3.1415926  # the reference's truncated constant


def vec3(x, y, z, dtype=torch.float32):
    """Stack three scalars or tensors, broadcast together, into a (..., 3)
    vector on the device of the first tensor among them."""
    dev = next((a.device for a in (x, y, z)
                if isinstance(a, torch.Tensor)), None)
    return torch.stack(torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y, z))),
        dim=-1)


def dot(a, b, keepdims: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdims else r


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v, keepdims: bool = False):
    return dot(v, v, keepdims)


def length(v, keepdims: bool = False):
    return torch.sqrt(length_squared(v, keepdims))


def normalize(v, eps: float = 0.0):
    """Safe normalize: exact zero vectors map to zero."""
    n2 = length_squared(v, keepdims=True)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-30)),
                      torch.zeros_like(n2))
    return v * inv


def reflect(v, n):
    return v - 2.0 * dot(v, n, keepdims=True) * n


def refract(uv, n, eta_ratio):
    """Snell refraction; ``uv`` unit, ``n`` the unit normal facing it."""
    cos_theta = torch.clamp(-dot(uv, n, keepdims=True), max=1.0)
    r_perp = eta_ratio * (uv + cos_theta * n)
    r_par = -torch.sqrt(torch.abs(1.0 - length_squared(r_perp, True))) * n
    return r_perp + r_par


def rotate_about_axis(v, axis, radians: float):
    """Rodrigues rotation of ``v`` about ``axis`` by ``radians`` (a host
    float, its cosine and sine taken in float32)."""
    axis = normalize(axis)
    r = torch.tensor(radians, dtype=torch.float32)
    c, s = float(torch.cos(r)), float(torch.sin(r))
    return v * c + cross(axis, v) * s + axis * dot(axis, v, True) * (1.0 - c)


def is_finite(v):
    """True where every component of the (..., 3) vector is finite."""
    return torch.all(torch.isfinite(v), dim=-1)


def degrees_to_radians(deg):
    return deg * (PI / 180.0)


def radians_to_degrees(rad):
    return rad * (180.0 / PI)


def schlick_fresnel(cosine, ref_idx):
    r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5
