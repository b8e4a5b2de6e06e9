"""Adaptive sampling of the port (render/adaptive.py and
``Camera.generate_rays_for_pixels``) against the JAX package on the same
numpy inputs, brute force on the Cornell box.

Tolerances, each with its reason:
- rays for a pixel subset: equal to the port's own grid rays (the same
  float32 arithmetic, lane by lane), and to the JAX package's within
  tests/test_torch_scene.py's 2e-7 (1e-6 through a thin lens, whose
  focus-plane point adds a division and a product);
- the error map: equal to the jitted JAX function's, ties (+inf, 1e32)
  included.  The port rounds ``sumsq - n * mean * mean`` once and the
  luminance as a chain of fused multiply-adds, and divides the relative
  map by ``n * (|mean| + 0.05)``, as XLA's CPU backend computes them,
  and takes a correctly rounded sqrt;
- the pixels each batch selects and the per-pixel counts: equal, batch
  after batch (the selection is a stable argsort, as ``jnp.argsort``).
  With the path tracer a full pass (k = every pixel) is compared as a
  set: after one sample its keys are the rounding residue of sumsq -
  mean^2, and the path tracer's radiance is the JAX package's only to fp
  order (tests/test_torch_pathtracer.py), so the order of a pass that
  traces every pixel anyway is noise;
- the accumulated moments: those of the integrator's own tests (Whitted
  equal here; the path tracer to fp order, 1e-5);
- checkpoints written by either package: equal after a restore by the
  other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.render import adaptive as ja
from optix_ray_tracer_tpu.scene import lights as jlights
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.cornell import build_cornell_box as jcornell
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.render import adaptive as ta
from optix_ray_tracer_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(2)

CPU = "cpu"
W, H = 16, 12

_error_map = jax.jit(ja.error_map, static_argnums=1)


@pytest.fixture(scope="module")
def cornell():
    js, jm, jc = jcornell()
    jl = jlights.collect_area_lights(js, jm)
    return (js, jm, jc, jl, convert.scene(convert.state_arrays(js), CPU),
            convert.materials(convert.state_arrays(jm), CPU),
            convert.camera(convert.state_arrays(jc), CPU),
            convert.area_lights(convert.state_arrays(jl), CPU))


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_rays_for_pixels(aperture):
    args = ((4.0, 1.0, 2.0), (0.0, 0.0, 0.5), (0.0, 0.0, 1.0))
    jc = JCamera.look_at(*args, aperture=aperture, focus_dist=3.0)
    tc = TCamera.look_at(*args, aperture=aperture, focus_dist=3.0,
                         device=CPU)
    r = np.random.default_rng(3)
    ids = r.permutation(W * H)[:100].astype(np.int32)
    jit = r.random((100, 2)).astype(np.float32)
    lens = r.uniform(-0.7, 0.7, (100, 2)).astype(np.float32)
    ref = jc.generate_rays_for_pixels(jnp.asarray(ids), W, H,
                                      jnp.asarray(jit), jnp.asarray(lens))
    got = tc.generate_rays_for_pixels(torch.as_tensor(ids), W, H,
                                      torch.as_tensor(jit),
                                      torch.as_tensor(lens))
    # the camera's rays: tests/test_torch_scene.py's tolerance (2e-7)
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=0,
                                   atol=2e-7 if aperture == 0.0 else 1e-6)
    # every pixel in order: the grid's rays bit for bit
    o, d = tc.generate_rays(W, H)
    o2, d2 = tc.generate_rays_for_pixels(torch.arange(W * H), W, H)
    assert torch.equal(d.reshape(-1, 3), d2)
    assert torch.equal(o.reshape(-1, 3), o2)


def _film_pair(seed: int, zero_share: float):
    """The same random moments as a JAX and a port AdaptiveFilm: counts
    0-8 with a share of unsampled pixels and a share under half the mean
    (the two tie classes)."""
    r = np.random.default_rng(seed)
    n = W * H
    cnt = r.integers(1, 9, n).astype(np.int32)
    cnt[r.random(n) < zero_share] = 0
    acc = (r.random((n, 3)) * cnt[:, None]).astype(np.float32)
    ss = (r.random(n) * cnt * 1.3).astype(np.float32)
    alb = r.random((n, 3)).astype(np.float32)
    jf = ja.AdaptiveFilm(*(jnp.asarray(x) for x in (acc, ss, cnt, alb, alb)),
                         width=W, height=H)
    tf = convert.adaptive_film(convert.state_arrays(jf), CPU)
    return jf, tf


@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("seed,zero_share", [(0, 0.0), (1, 0.1), (2, 0.5)])
def test_error_map_bit_equal(relative, seed, zero_share):
    jf, tf = _film_pair(seed, zero_share)
    ref = np.asarray(_error_map(jf, relative))
    got = ta.error_map(tf, relative).numpy()
    np.testing.assert_array_equal(got, ref)
    k = W * H // 3
    np.testing.assert_array_equal(
        ta.select_pixels(tf, k, relative).numpy(),
        np.asarray(jnp.argsort(-_error_map(jf, relative))[:k]))


def test_selection_ties_are_stable():
    """An all-tied map selects pixels in id order (jnp.argsort's stable
    order), after the warm-up and for unsampled pixels alike."""
    _, tf = _film_pair(0, 0.0)
    for cnt in (0, 3):
        f = ta.AdaptiveFilm(tf.accum * 0, tf.sumsq * 0,
                            torch.full_like(tf.count, cnt), tf.accum,
                            tf.accum, W, H)
        assert ta.select_pixels(f, 40).tolist() == list(range(40))


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
@pytest.mark.parametrize("integrator", ["whitted", "path"])
def test_adaptive_batches_select_jax_pixels(cornell, sampler, integrator):
    js, jm, jc, jl, ts, tm, tc, tl = cornell
    jf, tf = ja.AdaptiveFilm.create(W, H), ta.AdaptiveFilm.create(W, H, CPU)
    kw = dict(seed=3, max_depth=3, sampler=sampler, integrator=integrator)
    npix = W * H
    for it, k in enumerate([npix, npix, 48, 48, 48, 17]):
        ref_ids = np.asarray(jnp.argsort(-_error_map(jf, False))[:k])
        got_ids = ta.select_pixels(tf, k).numpy()
        if k == npix and integrator == "path":
            # a full pass traces every pixel whatever the order; after one
            # sample the keys are rounding residues of sumsq - mean^2,
            # and the path tracer's radiance is the JAX package's only to
            # fp order
            got_ids, ref_ids = np.sort(got_ids), np.sort(ref_ids)
        np.testing.assert_array_equal(got_ids, ref_ids,
                                      err_msg=f"batch {it}")
        jf = ja.adaptive_batch(js, jm, jl, jc, jf, k=k, **kw)
        tf = ta.adaptive_batch(ts, tm, tl, tc, tf, k=k, **kw)
        np.testing.assert_array_equal(tf.count.numpy(), np.asarray(jf.count))
        np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tf.sumsq.numpy(), np.asarray(jf.sumsq),
                                   rtol=1e-5, atol=1e-5)
    assert tf.total_samples == jf.total_samples == 2 * npix + 161


def test_render_adaptive_matches_jax(cornell):
    js, jm, jc, jl, ts, tm, tc, tl = cornell
    kw = dict(total_spp=6, seed=1, max_depth=3, warmup_spp=2,
              batch_fraction=0.3)
    ref = ja.render_adaptive(js, jm, jl, jc, W, H, **kw)
    got = ta.render_adaptive(ts, tm, tl, tc, W, H, **kw)
    assert got.total_samples == ref.total_samples == 6 * W * H
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(got.mean().numpy(), np.asarray(ref.mean()),
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(got.guide_means(), ref.guide_means()):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_batch_checks_k(cornell):
    *_, ts, tm, tc, tl = cornell
    for k in (0, W * H + 1):
        with pytest.raises(ValueError, match="out of range"):
            ta.adaptive_batch(ts, tm, tl, tc, ta.AdaptiveFilm.create(
                W, H, CPU), k=k)


def test_checkpoint_across_packages(tmp_path):
    jf, tf = _film_pair(4, 0.2)
    jf.checkpoint(str(tmp_path / "j.npz"), meta={"seed": 1})
    got = ta.AdaptiveFilm.restore(str(tmp_path / "j.npz"), CPU)
    tf.checkpoint(str(tmp_path / "t.npz"), meta={"seed": 1})
    back = ja.AdaptiveFilm.restore(str(tmp_path / "t"))
    for name in ("accum", "sumsq", "count", "albedo_accum", "normal_accum"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jf, name)))
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(tf, name).numpy())
    assert got.count.dtype == torch.int32
    assert (got.width, got.height) == (back.width, back.height) == (W, H)
    assert (tmp_path / "t.npz.json").read_text() == \
        (tmp_path / "j.npz.json").read_text()
    np.testing.assert_array_equal(got.to_uint8(), jf.to_uint8())
