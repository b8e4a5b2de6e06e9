"""Morton codes (the part of ``optix_ray_tracer_tpu/ops/bvh.py`` the ported
path uses; the LBVH build and traversal wait for a later slice)."""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _expand_bits_10(v):
    """Spread the low 10 bits of v (int64) so consecutive bits are 3 apart
    (uint32 arithmetic, wrapped in int64)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v & _MASK


def morton_codes(points, lo, hi):
    """30-bit Morton codes (int64) of (N, 3) points inside the box [lo, hi]."""
    extent = torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((points - lo) / extent, 0.0, 1.0)
    grid = torch.clamp((q * 1024.0).to(torch.int64), max=1023)
    return ((_expand_bits_10(grid[..., 0]) << 2)
            | (_expand_bits_10(grid[..., 1]) << 1)
            | _expand_bits_10(grid[..., 2]))
