"""The port's counter-based RNG against the JAX package's
(optix_ray_tracer_tpu.utils.rng) and the numpy mirror of
tests/test_render_golden.py: the integer streams and the uniforms are bit
exact; directions are bit exact in everything but float32 cos/sin, which
each math library rounds its own way (XLA's and numpy's disagree by an
ulp on ~17% of angles), so there they agree to 2 ulp of 1.0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optix_ray_tracer_tpu.utils import rng as jrng
from optix_ray_tracer_tpu_torch.utils import rng as trng
from test_render_golden import np_pcg4d, np_uniform4, np_unit_vector

torch.set_num_threads(1)

SEEDS = (0, 11, 0x1E3779B9 ^ 7, 2 ** 31 - 1)


def _inputs(seed):
    r = np.random.default_rng(seed)
    pix = r.integers(0, 1 << 22, 4096).astype(np.int32)
    sample = r.integers(0, 64, 4096).astype(np.int32)
    return pix, sample


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounce", [-1, 0, 4])
def test_pcg4d_bit_exact(seed, bounce):
    pix, sample = _inputs(seed)
    got = trng.pcg4d(torch.as_tensor(pix), torch.as_tensor(sample), bounce,
                     seed)
    ref = jrng.pcg4d(jnp.asarray(pix), jnp.asarray(sample),
                     jnp.int32(bounce), jnp.int32(seed))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(r))
    # the numpy mirror, lane by lane on a few rays
    for i in range(0, 4096, 512):
        mirror = np_pcg4d(int(pix[i]), int(sample[i]), bounce, seed)
        assert tuple(int(g[i]) for g in got) == tuple(int(m) for m in mirror)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform4_bit_exact(seed):
    pix, sample = _inputs(seed + 1)
    got = trng.uniform4(torch.as_tensor(pix), torch.as_tensor(sample), 2,
                        seed)
    ref = jrng.uniform4(jnp.asarray(pix), jnp.asarray(sample),
                        jnp.int32(2), jnp.int32(seed))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for i in range(0, 4096, 512):
        mirror = np_uniform4(int(pix[i]), int(sample[i]), 2, seed)
        assert tuple(float(g[i]) for g in got) == tuple(float(m)
                                                        for m in mirror)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_unit_vector_bit_exact(seed):
    pix, sample = _inputs(seed + 2)
    got = trng.random_unit_vector(torch.as_tensor(pix),
                                  torch.as_tensor(sample), 1, seed).numpy()
    ref = np.asarray(jrng.random_unit_vector(
        jnp.asarray(pix), jnp.asarray(sample), jnp.int32(1),
        jnp.int32(seed)))
    np.testing.assert_array_equal(got[:, 2], ref[:, 2])
    # one ulp of cos/sin, then one rounding of r * cos: <= 2 ulp of 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.4e-7)
    for i in range(0, 4096, 512):
        mirror = np_unit_vector(int(pix[i]), int(sample[i]), 1, seed)
        assert got[i, 2] == mirror[2]
        np.testing.assert_allclose(got[i], mirror, rtol=0, atol=2.4e-7)


def test_stratified_jitter_and_disk_match():
    pix, sample = _inputs(5)
    tp, ts = torch.as_tensor(pix), torch.as_tensor(sample)
    for g, r in zip(trng.stratified_jitter(tp, ts, 9),
                    jrng.stratified_jitter(jnp.asarray(pix),
                                           jnp.asarray(sample),
                                           jnp.int32(9))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got = trng.random_in_unit_disk(tp, ts, -2, 9).numpy()
    ref = np.asarray(jrng.random_in_unit_disk(
        jnp.asarray(pix), jnp.asarray(sample), jnp.int32(-2), jnp.int32(9)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)
