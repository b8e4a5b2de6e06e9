"""Color transforms (port of ``optix_ray_tracer_tpu/utils/color.py``):
linear <-> sRGB with the reference's constants, luminance, uint8
quantization and dependency-free PPM and PNG writers."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

#: Rec.709 luma weights
LUMA_709 = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def luminance(rgb):
    """Rec.709 luminance of (..., 3) linear RGB (numpy array or tensor)."""
    if isinstance(rgb, torch.Tensor):
        return rgb @ torch.as_tensor(LUMA_709, device=rgb.device)
    return rgb @ LUMA_709


def luminance_fma(rgb):
    """Rec.709 luminance of a (..., 3) tensor as a chain of fused
    multiply-adds, fma(b, L2, fma(g, L1, r * L0)), each step rounded once
    to float32: the rounding of the JAX package's ``rgb @ LUMA_709`` on
    XLA's CPU backend.  The reservoir weights and adaptive priorities use
    it, where a 1-ulp change can flip a pick."""
    lum = torch.as_tensor(LUMA_709, device=rgb.device).double()
    c = rgb.double()
    acc = (c[..., 0] * lum[0]).float().double()
    acc = (c[..., 1] * lum[1] + acc).float().double()
    return (c[..., 2] * lum[2] + acc).float()


def linear_to_srgb(c):
    """Per-channel linear -> sRGB; clips to [0, 1]."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp(c, min=1e-30), 1.0 / 2.4) - 0.055
    return torch.clamp(torch.where(c < 0.0031308, lo, hi), 0.0, 1.0)


def srgb_to_linear(s):
    s = torch.clamp(s, 0.0, 1.0)
    lo = s / 12.92
    hi = torch.pow((s + 0.055) / 1.055, 2.4)
    return torch.where(s <= 0.04045, lo, hi)


def color_to_float4(rgb):
    """sRGB-encode an (..., 3) linear color and append alpha = 1."""
    srgb = linear_to_srgb(rgb[..., :3])
    return torch.cat([srgb, torch.ones_like(srgb[..., :1])], dim=-1)


def color_to_uint8(rgb):
    """sRGB-encode and quantize to uint8 RGBA: ``min(uint(srgb*256), 255)``."""
    srgb = linear_to_srgb(rgb[..., :3])
    q = torch.clamp((srgb * 256.0).to(torch.int64), max=255).to(torch.uint8)
    alpha = torch.full_like(q[..., :1], 255)
    return torch.cat([q, alpha], dim=-1)


def write_ppm(path, rgb_uint8) -> None:
    """Write an (H, W, >=3) uint8 image (numpy array or tensor) as binary
    PPM."""
    if isinstance(rgb_uint8, torch.Tensor):
        rgb_uint8 = rgb_uint8.cpu().numpy()
    arr = np.asarray(rgb_uint8)[..., :3]
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.astype(np.uint8).tobytes())


def png_bytes(rgba_uint8: np.ndarray) -> bytes:
    """Encode an (H, W, 3|4) uint8 image as PNG (zlib + struct only)."""
    arr = np.asarray(rgba_uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), 255, np.uint8)], -1)
        c = 4
    color_type = {1: 0, 2: 4, 4: 6}.get(c, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path, rgba_uint8) -> None:
    """Write an image (numpy array or tensor on any device) as a PNG."""
    if isinstance(rgba_uint8, torch.Tensor):
        rgba_uint8 = rgba_uint8.cpu().numpy()
    with open(path, "wb") as f:
        f.write(png_bytes(rgba_uint8))
