"""Owen-scrambled Sobol points (port of ``optix_ray_tracer_tpu/utils/qmc.py``).

Padded 2-D Sobol sequences with hash-based Owen scrambling (Burley,
"Practical Hash-Based Owen Scrambling", JCGT 2020): each (pixel, bounce,
purpose) gets its own randomised sequence, indexed by the sample counter.
The first 2^k points of each pad stratify every elementary interval, and
the scramble keeps that while decorrelating pixels and pads; everything
is a pure function of (pixel_id, sample, bounce, seed), like the PCG4D
stream of ``utils/rng.py``.  The uint32 lanes live in int64 tensors
masked to 32 bits, as in ``utils/rng.py``; the streams are the JAX
package's bit for bit.  On CUDA tensors :func:`sobol_owen4` launches
kernel I (``ops/kernels/bounce.sobol_owen4_call``), which computes the
same bits on native uint32.

Integrators opt in with ``sampler="sobol"`` (config key ``sampler``).
"""

from __future__ import annotations

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.kernels import bounce as bounce_kernels
from optix_ray_tracer_tpu_torch.utils.rng import (
    _MASK, _mul32, _to_unit_float, _u32, on_cuda, pcg4d_plain,
)


def _joe_kuo_directions() -> np.ndarray:
    """Direction numbers (32, D) of the first D Sobol dimensions:
    dimension 0 is van der Corput, the rest follow the Joe-Kuo
    recurrence."""
    # (s, a, m) rows of new-joe-kuo-6 for dimensions 2..6 (1-indexed)
    params = [
        (1, 0, [1]),
        (2, 1, [1, 3]),
        (3, 1, [1, 3, 1]),
        (3, 2, [1, 1, 1]),
        (4, 1, [1, 1, 3, 3]),
    ]
    dims = [np.array([1 << (31 - j) for j in range(32)], np.uint64)]
    for s, a, m in params:
        v = np.zeros(32, np.uint64)
        for j in range(s):
            v[j] = np.uint64(m[j]) << np.uint64(31 - j)
        for j in range(s, 32):
            v[j] = v[j - s] ^ (v[j - s] >> np.uint64(s))
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v[j] ^= v[j - k]
        dims.append(v)
    return np.stack(dims, axis=1).astype(np.uint32)   # (32, D)


_DIRECTIONS = _joe_kuo_directions()                    # (32, 6)


def sobol_byte_tables(dims: int = 4) -> np.ndarray:
    """Per-byte Sobol tables (1024, ``dims``) uint32: row 256 k + v is the
    XOR of the direction rows 8 k + j of the set bits j of v, so the raw
    Sobol point of an index is the XOR of the rows its four bytes select
    (kernel I's lookups, ``csrc/rng.cuh``)."""
    values = np.arange(256)
    out = np.zeros((4, 256, dims), np.uint32)
    for k in range(4):
        for j in range(8):
            out[k, (values >> j) & 1 == 1] ^= _DIRECTIONS[8 * k + j, :dims]
    return out.reshape(1024, dims)


def reverse_bits32(x):
    """Bit-reverse each uint32 lane (an int64 tensor or a Python int)."""
    x = _u32(x, "cpu") if isinstance(x, int) else x.to(torch.int64) & _MASK
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _MASK) | (x >> 16)


def _laine_karras(x, seed):
    """Laine-Karras-style hash: for a fixed seed a bijection on uint32 in
    which bit i depends only on bits <= i (an Owen scramble in the
    reversed-bit domain, Burley 2020, listing 4)."""
    x = (x + seed) & _MASK
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(x, seed):
    """Nested uniform (Owen) scramble of [0, 1) values held as uint32."""
    x = _u32(x, "cpu") if isinstance(x, int) else x.to(torch.int64) & _MASK
    seed = _u32(seed, x.device)
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed))


def _sobol(index, dims):
    """Raw Sobol points (uint32 radical-inverse bits) of ``index`` in the
    dimensions ``dims`` (static, each < 6): (..., len(dims)) int64."""
    idx = index.to(torch.int64) & _MASK
    dirs = torch.as_tensor(_DIRECTIONS[:, list(dims)].astype(np.int64),
                           device=idx.device)
    acc = torch.zeros(idx.shape + (len(dims),), dtype=torch.int64,
                      device=idx.device)
    for j in range(32):
        acc = acc ^ (((idx >> j) & 1)[..., None] * dirs[j])
    return acc


def sobol_u32(index, dim: int):
    """Raw Sobol point (uint32 bits) of ``index`` in dimension ``dim``."""
    return _sobol(index, (dim,))[..., 0]


def sobol_owen4(pixel_id, sample, bounce, seed):
    """Four U[0, 1) float32 tensors: two Owen-scrambled 2-D Sobol pads
    over the SAMPLE index, decorrelated per (pixel, bounce, seed).
    Components (0, 1) form one (0, 1)-sequence pad, (2, 3) a second.
    ``utils/rng.uniform4``'s signature and purity contract.  CUDA tensors
    launch kernel I; others take :func:`sobol_owen4_plain`."""
    if on_cuda(pixel_id, sample, bounce, seed):
        return bounce_kernels.sobol_owen4_call(pixel_id, sample, bounce,
                                               seed)
    return sobol_owen4_plain(pixel_id, sample, bounce, seed)


def sobol_owen4_plain(pixel_id, sample, bounce, seed):
    """Plain version of :func:`sobol_owen4` on any device (kernel I's
    twin)."""
    s_shuf, s0, s1, s2 = pcg4d_plain(pixel_id, bounce, seed, 0x9E3779B9)
    # one index shuffle for every dimension of the pad set (a per-dim
    # shuffle would break the joint 2-D stratification), then an
    # independent scramble per dimension
    if isinstance(sample, int):
        sample = torch.tensor(sample, device=s_shuf.device)
    idx = owen_scramble(sample, s_shuf)
    raw = _sobol(idx, (0, 1, 2, 3))
    seeds = (s0, s1, s2, s0 ^ s1)
    return tuple(_to_unit_float(owen_scramble(raw[..., i], s))
                 for i, s in enumerate(seeds))
