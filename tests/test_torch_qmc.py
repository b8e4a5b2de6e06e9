"""The Sobol sampler of the port (utils/qmc.py and the ``mode="sobol"``
branches of utils/rng.py) against the JAX package on the same numpy
inputs, and the sampler and ``sample_offset`` of ``wavefront.render`` and
``render_path``.

Tolerances, each with its reason:
- integer streams (bit reversal, Owen scrambles, Sobol points, the four
  uint32 pads behind ``sobol_owen4``) and the uniforms made from them:
  equal, on edge words, negative pixel ids, negative bounces (-1 jitter,
  -2 lens) and seeds XORed with the salts;
- ``random_unit_vector`` / ``random_in_unit_disk``: 2.4e-7 (2 ulp of
  cos/sin, the RNG contract of tests/test_torch_rng.py); the cosine
  direction's z to 1 ulp (XLA's CPU sqrt, tests/test_torch_pathtracer.py);
- frames: tests/test_torch_wavefront.py's, mean |diff| <= 1e-5 and >= 99%
  of pixels within 1e-4 (fp order only), Russian roulette off;
- two ``sample_offset`` batches against one run: the port's own result,
  to float32 accumulation order (1e-6): the sum of two batch means
  divides by a different count than one mean."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.render import pathtracer as jpt
from optix_ray_tracer_tpu.render import wavefront as jwf
from optix_ray_tracer_tpu.scene import lights as jlights
from optix_ray_tracer_tpu.scene.cornell import build_cornell_box as jcornell
from optix_ray_tracer_tpu.utils import qmc as jqmc
from optix_ray_tracer_tpu.utils import rng as jrng
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.render import pathtracer as tpt
from optix_ray_tracer_tpu_torch.render import wavefront as twf
from optix_ray_tracer_tpu_torch.scene import lights as tlights
from optix_ray_tracer_tpu_torch.utils import qmc as tqmc
from optix_ray_tracer_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

CPU = "cpu"
# the port's salts the callers fold into the seed
SALTS = (0, 0x5851F42D, 0x68E31DA4, 0x2545F491)
EDGE_WORDS = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
              0x55555555, 0xAAAAAAAA, 0x0F0F0F0F]


def _words(seed: int, n: int = 4096) -> np.ndarray:
    r = np.random.default_rng(seed)
    w = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[:len(EDGE_WORDS)] = EDGE_WORDS
    return w


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _j(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverse_bits32(seed):
    w = _words(seed)
    np.testing.assert_array_equal(tqmc.reverse_bits32(_t(w)).numpy(),
                                  _j(jqmc.reverse_bits32(jnp.asarray(w))))


@pytest.mark.parametrize("scramble", [0, 1, 0x9E3779B9, 0xFFFFFFFF,
                                      0x80000000])
def test_owen_scramble(scramble):
    w = _words(scramble & 0xFF)
    got = tqmc.owen_scramble(_t(w), scramble).numpy()
    ref = _j(jqmc.owen_scramble(jnp.asarray(w), jnp.uint32(scramble)))
    np.testing.assert_array_equal(got, ref)
    # per-lane seeds too
    seeds = _words(7)
    got = tqmc.owen_scramble(_t(w), _t(seeds)).numpy()
    ref = _j(jqmc.owen_scramble(jnp.asarray(w), jnp.asarray(seeds)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dim", range(6))
def test_sobol_u32(dim):
    w = _words(dim)
    np.testing.assert_array_equal(tqmc.sobol_u32(_t(w), dim).numpy(),
                                  _j(jqmc.sobol_u32(jnp.asarray(w), dim)))
    np.testing.assert_array_equal(
        tqmc._DIRECTIONS, jqmc._DIRECTIONS)


def _pads(n=4096, seed=0):
    r = np.random.default_rng(seed)
    pix = r.integers(-(1 << 20), 1 << 22, n).astype(np.int32)
    samp = r.integers(0, 1 << 20, n).astype(np.int32)
    samp[:4] = [0, 1, 65535, 65536]            # past 2^16 included
    return pix, samp


@pytest.mark.parametrize("bounce", [-2, -1, 0, 1, 7, 64])
@pytest.mark.parametrize("seed", [0, 3, -123456, 2 ** 31 - 1])
def test_sobol_owen4(bounce, seed):
    pix, samp = _pads(seed=bounce & 0xF)
    for salt in SALTS:
        s = seed ^ salt
        ref = jqmc.sobol_owen4(jnp.asarray(pix), jnp.asarray(samp),
                               jnp.int32(bounce), jnp.int32(s))
        got = tqmc.sobol_owen4(_t(pix), _t(samp), bounce, s)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            assert (g >= 0).all() and (g < 1).all()


def test_sobol_owen4_scalar_sample():
    """A Python int sample (ReSTIR's frame index) broadcasts like JAX's."""
    pix, _ = _pads(512)
    ref = jqmc.sobol_owen4(jnp.asarray(pix), jnp.int32(70000), jnp.int32(5),
                           jnp.int32(9))
    got = tqmc.sobol_owen4(_t(pix), 70000, 5, 9)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sobol_pads_stratify():
    """The first 2^k samples of one pad put one point in each of the 2^k
    strata of both axes (the (0, 1)-sequence property the scramble
    keeps)."""
    samp = np.arange(64)
    u0, u1, _, _ = tqmc.sobol_owen4(torch.full((64,), 77), _t(samp), 2, 5)
    for u in (u0, u1):
        assert sorted((u.numpy() * 64).astype(int).tolist()) == list(
            range(64))


@pytest.mark.parametrize("seed", [0, 11])
def test_rng_sobol_branches(seed):
    pix, samp = _pads(2048, seed)
    jp, js = jnp.asarray(pix), jnp.asarray(samp)
    for b in (-1, 0, 3):
        ref = jrng.uniform4(jp, js, jnp.int32(b), jnp.int32(seed), "sobol")
        got = trng.uniform4(_t(pix), _t(samp), b, seed, "sobol")
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        ref = jrng.random_unit_vector(jp, js, jnp.int32(b), jnp.int32(seed),
                                      "sobol")
        got = trng.random_unit_vector(_t(pix), _t(samp), b, seed, "sobol")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2.4e-7)
        ref = jrng.random_cosine_direction(jp, js, jnp.int32(b),
                                           jnp.int32(seed), "sobol")
        got = trng.random_cosine_direction(_t(pix), _t(samp), b, seed,
                                           "sobol")
        np.testing.assert_allclose(got.numpy()[:, 2], np.asarray(ref)[:, 2],
                                   rtol=0, atol=6e-8)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2.4e-7)
    ref = jrng.random_in_unit_disk(jp, js, jnp.int32(-2),
                                   jnp.int32(seed ^ 0x68E31DA4), "sobol")
    got = trng.random_in_unit_disk(_t(pix), _t(samp), -2, seed ^ 0x68E31DA4,
                                   "sobol")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2.4e-7)
    for mode in ("pcg", "sobol"):
        ref = jrng.stratified_jitter(jp, js, jnp.int32(seed), mode)
        got = trng.stratified_jitter(_t(pix), _t(samp), seed, mode)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sample_lights_sobol():
    """The Sobol branch of sample_lights swaps the dimensions: the
    barycentric pair takes components 0 and 1."""
    js, jm, _ = jcornell()
    jl = jlights.collect_area_lights(js, jm)
    tl = convert.area_lights(convert.state_arrays(jl), CPU)
    r = np.random.default_rng(4)
    pts = r.uniform(100, 400, (1024, 3)).astype(np.float32)
    pix = np.arange(1024, dtype=np.int32)
    ref = jlights.sample_lights(jl, jnp.asarray(pts), jnp.asarray(pix),
                                jnp.int32(3), jnp.int32(1), jnp.int32(9),
                                mode="sobol")
    got = tlights.sample_lights(tl, torch.as_tensor(pts), _t(pix), 3, 1, 9,
                                "sobol")
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=1e-5,
                                   atol=1e-6)


def _image_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-5, diff.mean()
    assert (diff.reshape(-1, 3).max(-1) <= 1e-4).mean() >= 0.99


@pytest.fixture(scope="module")
def cornell():
    js, jm, jc = jcornell()
    jl = jlights.collect_area_lights(js, jm)
    return (js, jm, jc, jl, convert.scene(convert.state_arrays(js), CPU),
            convert.materials(convert.state_arrays(jm), CPU),
            convert.camera(convert.state_arrays(jc), CPU),
            convert.area_lights(convert.state_arrays(jl), CPU))


@pytest.mark.parametrize("offset", [0, 5])
def test_wavefront_sobol_matches_jax(cornell, offset):
    js, jm, jc, _, ts, tm, tc, _ = cornell
    kw = dict(spp=2, seed=4, max_depth=3, sampler="sobol",
              sample_offset=offset, want_aux=True)
    ref = jwf.render(js, jm, jc, 16, 16, **kw)
    got = twf.render(ts, tm, tc, 16, 16, **kw)
    for g, r in zip(got[:3], ref[:3]):
        _image_close(g.numpy(), r)
    for g, r in zip(got[3], ref[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


@pytest.mark.parametrize("offset", [0, 3])
def test_render_path_sobol_matches_jax(cornell, offset):
    js, jm, jc, jl, ts, tm, tc, tl = cornell
    kw = dict(spp=2, seed=2, max_depth=4, rr_start=8, sampler="sobol",
              sample_offset=offset)
    ref = jpt.render_path(js, jm, jl, jc, 16, 16, **kw)
    got = tpt.render_path(ts, tm, tl, tc, 16, 16, **kw)
    for g, r in zip(got, ref):
        _image_close(g.numpy(), r)
    assert float(got[0].mean()) > 0.05


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
@pytest.mark.parametrize("integrator", ["whitted", "path"])
def test_two_offset_batches_equal_one_run(cornell, sampler, integrator):
    """Batches of 2 and 2 samples at sample_offset 0 and 2 average to the
    4-sample run: one global sample counter."""
    *_, ts, tm, tc, tl = cornell
    if integrator == "path":
        def run(**kw):
            return tpt.render_path(ts, tm, tl, tc, 12, 12, seed=1,
                                   max_depth=3, sampler=sampler,
                                   samples_per_wave=2, **kw)
    else:
        def run(**kw):
            return twf.render(ts, tm, tc, 12, 12, seed=1, max_depth=3,
                              sampler=sampler, samples_per_wave=2, **kw)
    one = run(spp=4)
    a, b = run(spp=2), run(spp=2, sample_offset=2)
    for o, x, y in zip(one, a, b):
        np.testing.assert_allclose(o.numpy(), ((x + y) * 0.5).numpy(),
                                   rtol=1e-6, atol=1e-6)
