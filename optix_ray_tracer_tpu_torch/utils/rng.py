"""Stateless counter-based RNG (port of ``optix_ray_tracer_tpu/utils/rng.py``).

Every random number is a pure function of (pixel, sample, bounce, seed):
PCG4D (Jarzynski & Olano, JCGT 2020), or with ``mode="sobol"`` an
Owen-scrambled Sobol pad over the sample index (``utils/qmc.py``).  The
port reproduces the JAX package's uint32 streams bit for bit.  PyTorch's
uint32 arithmetic is incomplete, so the lanes live in int64 and wrap with
``& 0xFFFFFFFF``; products of two 32-bit lanes are split into 16-bit
halves so that no intermediate leaves int64.  No ``torch.Generator`` is
involved.

:func:`pcg4d` and :func:`uniform4` send CUDA tensors to kernel H
(``ops/kernels/bounce.pcg4d_call``, native uint32, the same bits) and
everything else to their plain versions :func:`pcg4d_plain` and
:func:`uniform4_plain`.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops.kernels import bounce as bounce_kernels
from optix_ray_tracer_tpu_torch.utils.vecmath import PI

_MASK = 0xFFFFFFFF
_INV_2_24 = float(1.0 / (1 << 24))


def _mul32(a, b):
    """(a * b) mod 2**32 for int64 tensors holding uint32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _u32(v, like):
    if isinstance(v, int):
        return torch.tensor(v & _MASK, dtype=torch.int64, device=like)
    return v.to(torch.int64) & _MASK


def on_cuda(*args) -> bool:
    """True when the first tensor among ``args`` lies on a CUDA device:
    the dispatch rule of the RNG's public names."""
    t = next((a for a in args if isinstance(a, torch.Tensor)), None)
    return t is not None and t.is_cuda


def pcg4d(a, b, c, d):
    """PCG4D hash of four broadcastable int tensors (or Python ints, wrapped
    mod 2**32).  Returns four int64 tensors holding uint32 values.  CUDA
    tensors launch kernel H; others take :func:`pcg4d_plain`."""
    if on_cuda(a, b, c, d):
        return bounce_kernels.pcg4d_call(a, b, c, d, as_int=True)
    return pcg4d_plain(a, b, c, d)


def pcg4d_plain(a, b, c, d):
    """Plain version of :func:`pcg4d` (kernel H's twin)."""
    device = next((v.device for v in (a, b, c, d)
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))
    x, y, z, w = (_u32(v, device) for v in (a, b, c, d))
    x, y, z, w = torch.broadcast_tensors(x, y, z, w)

    x = (_mul32(x, 1664525) + 1013904223) & _MASK
    y = (_mul32(y, 1664525) + 1013904223) & _MASK
    z = (_mul32(z, 1664525) + 1013904223) & _MASK
    w = (_mul32(w, 1664525) + 1013904223) & _MASK

    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return x, y, z, w


def _to_unit_float(u):
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (u >> 8).to(torch.float32) * _INV_2_24


def uniform4(pixel_id, sample, bounce, seed, mode: str = "pcg"):
    """Four U[0,1) float32 tensors per (pixel, sample, bounce, seed).
    ``mode``: "pcg" (PCG4D, the default) or "sobol" (``utils/qmc``).
    CUDA tensors launch kernel H (I for "sobol"); others take
    :func:`uniform4_plain`."""
    if mode == "sobol":
        from optix_ray_tracer_tpu_torch.utils.qmc import sobol_owen4
        return sobol_owen4(pixel_id, sample, bounce, seed)
    if on_cuda(pixel_id, sample, bounce, seed):
        return bounce_kernels.pcg4d_call(pixel_id, sample, bounce, seed)
    return uniform4_plain(pixel_id, sample, bounce, seed)


def uniform4_plain(pixel_id, sample, bounce, seed, mode: str = "pcg"):
    """Plain version of :func:`uniform4` on any device (kernel H's twin;
    with "sobol", ``qmc.sobol_owen4_plain``, kernel I's)."""
    if mode == "sobol":
        from optix_ray_tracer_tpu_torch.utils.qmc import sobol_owen4_plain
        return sobol_owen4_plain(pixel_id, sample, bounce, seed)
    return tuple(_to_unit_float(v) for v in pcg4d_plain(pixel_id, sample,
                                                        bounce, seed))


def uniform_in_range(u, lo, hi):
    """Map U[0, 1) to [lo, hi)."""
    return lo + (hi - lo) * u


def _cos_sin(phi):
    """cos and sin of float32 angles, evaluated in float64 and rounded:
    the same bits on every device.  (float32 libm cos/sin differ between
    libraries by an ulp: XLA's and numpy's disagree on ~17% of angles, so
    no port can match both bit for bit.)"""
    p = phi.to(torch.float64)
    return torch.cos(p).to(torch.float32), torch.sin(p).to(torch.float32)


def random_unit_vector(pixel_id, sample, bounce, seed,
                       mode: str = "pcg"):
    """Uniform direction on the unit sphere (z/phi parameterization)."""
    u1, u2, _, _ = uniform4(pixel_id, sample, bounce, seed, mode)
    return unit_vector_from(u1, u2)


def unit_vector_from(u1, u2):
    """The unit-sphere point of two uniforms: z = 1 - 2 u1, phi = 2 pi u2.
    Returns (..., 3)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    c, s = _cos_sin((2.0 * PI) * u2)
    return torch.stack([r * c, r * s, z], dim=-1)


def random_cosine_direction(pixel_id, sample, bounce, seed,
                            mode: str = "pcg"):
    """Cosine-weighted hemisphere sample about +z (the path tracer's
    diffuse lobe).  Returns (..., 3)."""
    u1, u2, _, _ = uniform4(pixel_id, sample, bounce, seed, mode)
    return cosine_direction_from(u1, u2)


def cosine_direction_from(u1, u2):
    """The cosine-weighted hemisphere point about +z of two uniforms: phi
    = 2 pi u1, radius sqrt(u2).  Returns (..., 3)."""
    c, s = _cos_sin((2.0 * PI) * u1)
    sq = torch.sqrt(u2)
    return torch.stack([c * sq, s * sq,
                        torch.sqrt(torch.clamp(1.0 - u2, min=0.0))], dim=-1)


def random_in_unit_disk(pixel_id, sample, bounce, seed,
                        mode: str = "pcg"):
    """Uniform point in the unit disk (polar method).  Returns (..., 2)."""
    u1, u2, _, _ = uniform4(pixel_id, sample, bounce, seed, mode)
    r = torch.sqrt(u1)
    c, s = _cos_sin((2.0 * PI) * u2)
    return torch.stack([r * c, r * s], dim=-1)


def stratified_jitter(pixel_id, sample, seed, mode: str = "pcg"):
    """Pixel-filter jitter stratified over a 4x4 subpixel grid cycled by
    the global sample index (bounce slot -1 of the stream).  Sobol's joint
    2-D (0, 1) property is itself that stratification at every power-of-two
    prefix, so ``mode="sobol"`` draws the pad of bounce -1 with no grid."""
    if mode == "sobol":
        u1, u2, _, _ = uniform4(pixel_id, sample, -1, seed, mode)
        return u1, u2
    u1, u2, _, _ = uniform4(pixel_id, sample, -1, seed)
    cell = sample % 16
    cx = (cell % 4).to(torch.float32)
    cy = (cell // 4).to(torch.float32)
    return (cx + u1) * 0.25, (cy + u2) * 0.25
