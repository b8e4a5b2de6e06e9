"""The TLAS route as the integrators use it: the port's
``TLASSceneIntersector`` (virtual ids, static merge, lazy instanced
shading, occlusion, the raster route) against the JAX one on
tests/test_tlas_product.py's setup (10 instances and a static ground
triangle), and the port's frame builder ``tlas_frame_intersector``
against the JAX package's per-frame body.

Hit rule (bench.py) on the virtual ids; normals to 1e-5 (the rotation of
library normals is the same float32 arithmetic in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.ops import intersect as jisect
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from test_tlas_product import _rays, _setup

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def adapters():
    jad, jflat, jstatic, n_dyn = _setup()
    tad = convert.tlas_intersector(convert.state_arrays(jad), device="cpu")
    tstatic = convert.scene(convert.state_arrays(jstatic), device="cpu")
    return jad, jstatic, tad, tstatic, n_dyn, jflat


def _assert_hits(got, ref, min_hits=50):
    np.testing.assert_array_equal(got.is_hit.numpy(), np.asarray(ref.is_hit))
    assert hit_mismatches(got.prim_id, got.t, _t(ref.prim_id),
                          _t(ref.t)) == 0
    assert int(got.is_hit.sum()) > min_hits


def test_intersect_matches_jax(adapters):
    """Virtual ids (dynamic block first, the static triangle after)."""
    jad, jstatic, tad, tstatic, n_dyn, _ = adapters
    o, d = _rays()
    ref = jad.intersect(jstatic, o, d)
    got = tad.intersect(tstatic, _t(o), _t(d))
    _assert_hits(got, ref)
    assert (got.prim_id[got.is_hit] < n_dyn).any()
    assert (got.prim_id == n_dyn).any()                   # the static tri


def test_static_merge(adapters):
    """Rays that only see the ground get its post-dynamic virtual id."""
    _, _, tad, tstatic, n_dyn, _ = adapters
    o = torch.tensor([[25.0, -25.0, 0.0]]).expand(8, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(8, 3)
    h = tad.intersect(tstatic, o, d)
    assert bool(h.is_hit.all())
    assert (h.prim_id == n_dyn).all()


def test_shading_matches_jax(adapters):
    """Lazy instanced shading on the same hits: point, normal, front
    face and material."""
    jad, jstatic, tad, tstatic, _, _ = adapters
    o, d = _rays(seed=12)
    ref_hit = jad.intersect(jstatic, o, d)
    hit = convert.hit(convert.state_arrays(ref_hit), device="cpu")
    ref = jad.shading_frame(jstatic, o, d, ref_hit)
    got = tad.shading_frame(tstatic, _t(o), _t(d), hit)
    m = np.asarray(ref_hit.is_hit)
    np.testing.assert_allclose(got[0].numpy()[m], np.asarray(ref[0])[m],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy()[m], np.asarray(ref[1])[m],
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy()[m], np.asarray(r)[m])


def test_any_hit_matches_jax(adapters):
    jad, jstatic, tad, tstatic, _, _ = adapters
    o, d = _rays(seed=13)
    ref = np.asarray(jad.any_hit(jstatic, o, d, t_max=12.0))
    got = tad.any_hit(tstatic, _t(o), _t(d), t_max=12.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < ref.size
    # and the flipped point-light wave through the raster route
    light = np.asarray([14.0, 2.0, 3.0], np.float32)
    tmax = np.linalg.norm(light - np.asarray(o), axis=-1) - 1e-3
    dl = (light - np.asarray(o)) / (tmax + 1e-3)[:, None]
    ref = np.asarray(jad.any_hit_from(jstatic, o, jnp.asarray(dl),
                                      point=jnp.asarray(light),
                                      t_max=jnp.asarray(tmax),
                                      block_rays=256))
    got = tad.any_hit_from(tstatic, _t(o), _t(dl), point=_t(light),
                           t_max=_t(tmax), block_rays=256)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_intersect_from_matches_jax(adapters):
    """The raster route (a shared-origin wave), merged with the static
    triangle."""
    jad, jstatic, tad, tstatic, _, _ = adapters
    center = np.asarray([14.0, 2.0, 3.0], np.float32)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(d[:, 0:1] > 0, -d, d)
    o = np.broadcast_to(center, (256, 3))
    ref = jad.intersect_from(jstatic, jnp.asarray(o), jnp.asarray(d),
                             mode="origin", point=jnp.asarray(center),
                             block_rays=256)
    got = tad.intersect_from(tstatic, _t(o), _t(d), mode="origin",
                             point=_t(center), block_rays=256)
    _assert_hits(got, ref, min_hits=20)
    # the brute-force oracle on the flattened scene agrees too
    flat = adapters[5]
    oracle = jisect.intersect_scene_bruteforce(flat, jnp.asarray(o),
                                               jnp.asarray(d))
    _assert_hits(got, oracle, min_hits=20)
