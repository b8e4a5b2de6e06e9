"""Guided a-trous denoiser (port of
``optix_ray_tracer_tpu/render/denoise.py``), the stand-in for the OptiX
AI denoiser that the reference invokes with color, albedo and normal
guides (``src/Global/RendererImpl.cu:584-734``).

An edge-avoiding a-trous wavelet filter (Dammertz et al. 2010) on
demodulated irradiance: colour and normal similarity weights, albedo
divided out before and multiplied back after.  Plain PyTorch (the JAX
package leaves it to XLA, no Pallas kernel); ``torch.roll`` is cyclic as
``jnp.roll`` is.
"""

from __future__ import annotations

import numpy as np
import torch

# 5-tap B3-spline kernel of the a-trous construction (host constants)
_KERNEL_1D = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _atrous_pass(img, normal, step: int, sigma_color, sigma_normal: float):
    """One a-trous iteration with edge-stopping weights; img, normal
    (H, W, 3)."""
    offsets = [-2 * step, -step, 0, step, 2 * step]
    acc = torch.zeros_like(img)
    wsum = torch.zeros(img.shape[:2] + (1,), dtype=img.dtype,
                       device=img.device)
    for iy, dy in enumerate(offsets):
        for ix, dx in enumerate(offsets):
            k = float(_KERNEL_1D[iy] * _KERNEL_1D[ix])
            sample = torch.roll(img, (-dy, -dx), dims=(0, 1))
            sample_n = torch.roll(normal, (-dy, -dx), dims=(0, 1))
            # color similarity (on demodulated radiance)
            dc = torch.sum((sample - img) ** 2, -1, keepdim=True)
            w_c = torch.exp(-dc / (sigma_color ** 2 + 1e-8))
            # normal similarity
            dn = torch.clamp(torch.sum(sample_n * normal, -1, keepdim=True),
                             min=0.0)
            w_n = dn ** sigma_normal
            wgt = k * w_c * w_n
            acc = acc + sample * wgt
            wsum = wsum + wgt
    # pixels whose weights all vanish (sky pixels have zero-normal guides)
    # pass through unfiltered
    return torch.where(wsum > 1e-8, acc / torch.clamp(wsum, min=1e-8), img)


def filter_irradiance(irradiance, normal, iterations: int = 4,
                      sigma_color=1.0, sigma_normal: float = 32.0):
    """The spatial a-trous cascade on demodulated irradiance.
    ``sigma_color``: a scalar or a per-pixel (H, W, 1) map."""
    out = irradiance
    for i in range(iterations):
        out = _atrous_pass(out, normal, 1 << i, sigma_color / (1.3 ** i),
                           sigma_normal)
    return out


def denoise(color, albedo, normal, iterations: int = 4,
            sigma_color: float = 1.0, sigma_normal: float = 32.0):
    """Denoise linear radiance with guide buffers; color, albedo, normal
    (H, W, 3).  Returns the filtered (H, W, 3) linear radiance."""
    safe_albedo = torch.clamp(albedo, min=1e-3)
    out = filter_irradiance(color / safe_albedo, normal, iterations,
                            sigma_color, sigma_normal)
    return out * safe_albedo


def skip_denoise(color, albedo=None, normal=None):
    """Bypass, parity with ``skipDenoise`` (RendererImpl.cu:736-745)."""
    return color
