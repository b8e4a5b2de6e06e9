"""HDR environment map, equirectangular (port of
``optix_ray_tracer_tpu/render/envmap.py``).

On a miss the ray direction looks up a latitude-longitude radiance image
with bilinear filtering (the reference's constant miss color,
generalised).  Maps with contrast carry importance-sampling tables for
the path tracer's environment NEE: a two-level CDF (blocks of 128 texels,
then texels within the block) over 3x3-max-filtered luminance x
sin(theta), and the per-texel pdf in (u, v) space.  Also a Radiance .hdr
reader and a procedural sky (host numpy copies of the JAX package's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.color import luminance
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import PI


@dataclasses.dataclass(frozen=True)
class EnvMap(TensorDataclass):
    """image: (H, W, 3) float32 radiance, +z up, phi = atan2(y, x) along
    u.  block_cdf (NB,), cond_cdf (NB, BLOCK) and pdf_tex (H, W): the
    sampling tables, None for a map without them (environment NEE then
    stays off)."""
    image: torch.Tensor
    block_cdf: torch.Tensor | None = None
    cond_cdf: torch.Tensor | None = None
    pdf_tex: torch.Tensor | None = None

    BLOCK = 128  # texels per CDF block

    @property
    def can_sample(self) -> bool:
        return self.block_cdf is not None

    def sample_direction(self, u_block, u_texel, u_jit, v_jit):
        """Importance-sample directions from the two-level CDF: ``u_block``
        picks the block (a left-sided searchsorted), ``u_texel`` the texel
        in it (a 7-step branchless lower bound on the block's CDF row),
        ``u_jit``/``v_jit`` jitter inside the texel.  Returns (dir (..., 3)
        unit, pdf_solid_angle (...,))."""
        h, w = self.image.shape[0], self.image.shape[1]
        k = self.BLOCK
        nb = self.block_cdf.shape[0]
        blk = torch.clamp(torch.searchsorted(self.block_cdf, u_block), 0,
                          nb - 1)
        cond = self.cond_cdf.reshape(-1)
        j = torch.zeros_like(blk)
        step = k // 2
        while step >= 1:
            t = j + step
            j = torch.where(cond[blk * k + (t - 1)] < u_texel, t, j)
            step //= 2
        idx = torch.clamp(blk * k + j, 0, h * w - 1)
        y = idx // w
        x = idx - y * w
        u = (x.to(torch.float32) + u_jit) / w
        v = (y.to(torch.float32) + v_jit) / h
        theta = v * PI
        phi = (u - 0.5) * (2.0 * PI)
        st = torch.sin(theta)
        direction = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                                 torch.cos(theta)], dim=-1)
        pdf = self.pdf_tex.reshape(-1)[idx] / (
            2.0 * PI * PI * torch.clamp(st, min=1e-6))
        return direction, pdf

    def pdf_solid_angle(self, directions):
        """The pdf with which :meth:`sample_direction` produces these unit
        directions: the MIS counterpart for BSDF rays that escape."""
        h, w = self.image.shape[0], self.image.shape[1]
        phi = torch.atan2(directions[..., 1], directions[..., 0])
        theta = torch.acos(torch.clamp(directions[..., 2], -1.0, 1.0))
        u = phi / (2.0 * PI) + 0.5
        v = theta / PI
        xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        return self.pdf_tex[yi, xi] / (
            2.0 * PI * PI * torch.clamp(torch.sin(theta), min=1e-6))

    def sample(self, directions):
        """Bilinear lookup: (..., 3) unit directions -> (..., 3)
        radiance."""
        img = self.image
        h, w = img.shape[0], img.shape[1]
        phi = torch.atan2(directions[..., 1], directions[..., 0])
        theta = torch.acos(torch.clamp(directions[..., 2], -1.0, 1.0))
        u = (phi / (2.0 * PI) + 0.5) * w - 0.5
        v = (theta / PI) * h - 0.5
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        fu = (u - u0)[..., None]
        fv = (v - v0)[..., None]
        u0i = torch.remainder(u0.to(torch.int64), w)
        u1i = torch.remainder(u0i + 1, w)
        v0i = torch.clamp(v0.to(torch.int64), 0, h - 1)
        v1i = torch.clamp(v0i + 1, 0, h - 1)
        top = img[v0i, u0i] * (1 - fu) + img[v0i, u1i] * fu
        bot = img[v1i, u0i] * (1 - fu) + img[v1i, u1i] * fu
        return top * (1 - fv) + bot * fv


def _with_tables(img: np.ndarray, device=None) -> EnvMap:
    """An EnvMap of the (H, W, 3) radiance image, on ``device`` (None: the
    card), with its sampling tables built on the host.  Texel weights are
    3x3-max-filtered luminance (wrapping in phi, clamped in theta) times
    sin(theta).  Near-constant maps (max luminance <= 1.05x the mean) get
    no tables: their importance sample would be uniform over the sphere,
    worse than the cosine lobe it is weighed against."""
    dev = resolve_device(device)
    img = np.array(img, np.float32)
    h, w = img.shape[:2]
    lum = luminance(img)
    if not float(lum.max()) > 1.05 * float(lum.mean()):
        return EnvMap(image=torch.as_tensor(img, device=dev))
    pad = np.concatenate([lum[:, -1:], lum, lum[:, :1]], axis=1)
    pad = np.concatenate([pad[:1], pad, pad[-1:]], axis=0)
    mx = np.max(np.stack([pad[dy:dy + h, dx:dx + w]
                          for dy in range(3) for dx in range(3)]), axis=0)
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    wgt = mx.astype(np.float64) * sin_t[:, None] + 1e-30
    total = wgt.sum()
    pdf_tex = (wgt * (h * w) / total).astype(np.float32)
    # the flat weights padded to whole blocks with zero-probability texels
    k = EnvMap.BLOCK
    flat = wgt.reshape(-1)
    n_pad = (-len(flat)) % k
    if n_pad:
        flat = np.concatenate([flat, np.zeros(n_pad)])
    blocks = flat.reshape(-1, k)
    block_w = blocks.sum(axis=1)
    block_cdf = np.cumsum(block_w) / total
    block_cdf[-1] = 1.0
    cond_cdf = np.cumsum(blocks, axis=1) / np.maximum(block_w[:, None],
                                                      1e-300)
    cond_cdf[:, -1] = 1.0

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return EnvMap(image=f32(img), block_cdf=f32(block_cdf),
                  cond_cdf=f32(cond_cdf), pdf_tex=f32(pdf_tex))


def constant_env(color, device=None) -> EnvMap:
    return _with_tables(np.broadcast_to(np.asarray(color, np.float32),
                                        (2, 4, 3)), device)


def gradient_sky(zenith=(0.35, 0.55, 0.95), horizon=(0.9, 0.9, 0.95),
                 ground=(0.35, 0.30, 0.25), height: int = 64,
                 width: int = 128, sun_dir=None, sun_radiance=(80, 76, 70),
                 sun_cos: float = 0.9995, device=None) -> EnvMap:
    """Procedural sky with an optional sun disk (no assets needed)."""
    theta = (np.arange(height) + 0.5) / height * np.pi
    z = np.cos(theta)
    t = np.clip(z, 0.0, 1.0)[:, None]
    sky = np.asarray(horizon) * (1 - t) + np.asarray(zenith) * t
    img = np.where(z[:, None] >= 0, sky, np.asarray(ground))
    img = np.repeat(img[:, None, :], width, axis=1).astype(np.float32)
    if sun_dir is not None:
        sd = np.asarray(sun_dir, np.float64)
        sd /= np.linalg.norm(sd)
        phi = (np.arange(width) + 0.5) / width * 2 * np.pi - np.pi
        dirs = np.stack(np.broadcast_arrays(
            np.sin(theta)[:, None] * np.cos(phi)[None, :],
            np.sin(theta)[:, None] * np.sin(phi)[None, :],
            np.cos(theta)[:, None] * np.ones_like(phi)[None, :]), -1)
        img[(dirs @ sd) > sun_cos] = sun_radiance
    return _with_tables(img, device)


def read_hdr(path: str, device=None) -> EnvMap:
    """A Radiance RGBE (.hdr) file, RLE or flat scanlines, "-Y h +X w"."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    head_end = data.find(b"\n\n")
    if head_end < 0:
        raise ValueError("bad HDR header")
    rest = data[head_end + 2:]
    nl = rest.find(b"\n")
    res = rest[:nl].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR layout: {res}")
    h, w = int(res[1]), int(res[3])
    payload = rest[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (pos + 4 <= len(payload) and payload[pos] == 2
                and payload[pos + 1] == 2
                and (payload[pos + 2] << 8 | payload[pos + 3]) == w):
            pos += 4                       # new-style RLE scanline
            for ch in range(4):
                x = 0
                while x < w:
                    count = payload[pos]
                    pos += 1
                    if count > 128:        # a run
                        rgbe[y, x:x + count - 128, ch] = payload[pos]
                        pos += 1
                        x += count - 128
                    else:                  # literals
                        rgbe[y, x:x + count, ch] = np.frombuffer(
                            payload, np.uint8, count, pos)
                        pos += count
                        x += count
        else:                              # a flat scanline
            rgbe[y] = np.frombuffer(payload, np.uint8, w * 4,
                                    pos).reshape(w, 4)
            pos += w * 4
    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent > 0, np.ldexp(1.0, exponent - 136),
                     0.0).astype(np.float32)
    return _with_tables(mantissa * scale[..., None], device)
