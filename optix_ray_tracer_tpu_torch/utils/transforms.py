"""SRT transforms and quaternion utilities (port of
``optix_ray_tracer_tpu/utils/transforms.py``).

Transforms are ``(..., 3, 4)`` float32 row-major affines (the reference's
``shift * rotate(X)*rotate(Y)*rotate(Z) * scale`` truncated to three
rows); quaternions are ``(..., 4)`` in (w, x, y, z) order.  Every function
is batched and runs on the device of its inputs.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.utils.vecmath import (
    PI, degrees_to_radians, radians_to_degrees,
)


def _f32(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def rotation_matrix_euler_xyz_degrees(rotate_deg):
    """3x3 rotation from Euler angles in degrees, composed Rx @ Ry @ Rz."""
    rotate_deg = _f32(rotate_deg)
    rx, ry, rz = (degrees_to_radians(rotate_deg[..., i]) for i in range(3))
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    mx = mat([(one, zero, zero), (zero, cx, -sx), (zero, sx, cx)])
    my = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    mz = mat([(cz, -sz, zero), (sz, cz, zero), (zero, zero, one)])
    return mx @ my @ mz


def srt_transform(shift, rotate_deg, scale):
    """Row-major 3x4 affine = translate(shift) @ rotate(deg XYZ) @ scale;
    ``shift``/``rotate_deg``/``scale`` are (..., 3)."""
    shift = _f32(shift)
    scale = _f32(scale, shift)
    rot = rotation_matrix_euler_xyz_degrees(_f32(rotate_deg, shift))
    linear = rot * scale[..., None, :]
    return torch.cat([linear, shift[..., :, None]], -1)


def identity_transform(batch_shape=()):
    eye = torch.cat([torch.eye(3), torch.zeros((3, 1))], -1)
    return eye.expand(*batch_shape, 3, 4)


def apply_transform_point(t, p):
    """Apply (..., 3, 4) affine to (..., 3) points."""
    return torch.einsum('...ij,...j->...i', t[..., :, :3], p) + t[..., :, 3]


def apply_transform_vector(t, v):
    """Apply only the linear part (directions don't translate)."""
    return torch.einsum('...ij,...j->...i', t[..., :, :3], v)


def invert_transform(t):
    """Invert a (..., 3, 4) affine transform."""
    inv_linear = torch.linalg.inv(t[..., :, :3])
    inv_shift = -torch.einsum('...ij,...j->...i', inv_linear, t[..., :, 3])
    return torch.cat([inv_linear, inv_shift[..., :, None]], -1)


def compose_transforms(a, b):
    """a @ b for 3x4 affines (apply b first)."""
    linear = a[..., :, :3] @ b[..., :, :3]
    shift = (torch.einsum('...ij,...j->...i', a[..., :, :3], b[..., :, 3])
             + a[..., :, 3])
    return torch.cat([linear, shift[..., :, None]], -1)


# ---------------------------------------------------------------------------
# Quaternions, (w, x, y, z) order.
# ---------------------------------------------------------------------------

def quat_slerp(q1, q2, t):
    """Spherical linear interpolation: shortest-path sign flip, nlerp
    fallback when the quaternions are nearly parallel (dot > 0.9995)."""
    q1 = _f32(q1)
    q2 = _f32(q2, q1)
    t = _f32(t, q1)

    d = torch.sum(q1 * q2, -1, keepdim=True)
    q2 = torch.where(d < 0.0, -q2, q2)
    d = torch.abs(d)

    lin = q1 + t[..., None] * (q2 - q1)
    mag = torch.sqrt(torch.sum(lin * lin, -1, keepdim=True))
    nlerp = torch.where(mag > 0.0, lin / torch.clamp(mag, min=1e-30), lin)

    d_c = torch.clamp(d, -1.0, 1.0)
    theta0 = torch.arccos(d_c)
    theta = theta0 * t[..., None]
    sin_theta0 = torch.sin(theta0)
    safe_sin0 = torch.where(torch.abs(sin_theta0) < 1e-12,
                            torch.ones_like(sin_theta0), sin_theta0)
    s0 = torch.cos(theta) - d_c * torch.sin(theta) / safe_sin0
    s1 = torch.sin(theta) / safe_sin0
    slerped = s0 * q1 + s1 * q2
    return torch.where(d > 0.9995, nlerp, slerped)


def quat_to_euler_degrees(q):
    """Quaternion -> Euler XYZ (roll, pitch, yaw) in degrees, with the
    +-90-degree pitch clamp when |sinp| >= 1."""
    w, x, y, z = (q[..., i] for i in range(4))
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = 2.0 * (w * y - z * x)
    pitch = torch.where(torch.abs(sinp) >= 1.0,
                        torch.sign(sinp) * (PI / 2.0),
                        torch.arcsin(torch.clamp(sinp, -1.0, 1.0)))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return radians_to_degrees(torch.stack([roll, pitch, yaw], -1))


def quat_to_rotation_matrix(q):
    """Direct quaternion -> 3x3 rotation (normalized first)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-30)
    w, x, y, z = (q[..., i] for i in range(4))
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)
