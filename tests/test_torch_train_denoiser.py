"""The port's denoiser trainer (render/train_denoiser.py) against the JAX
package's (optax Adam, the same crops), on synthetic images of
tests/test_denoiser_training.py at small sizes.

Tolerances, each with its reason:
- crops, batch indices, procedural scene arrays, the dataset cache and
  weight files: equal (numpy draws and host arrays on both sides);
- the learning rate against ``optax.cosine_decay_schedule``: relative
  1e-6 (optax evaluates it in float32, the port in float64);
- one Adam step from the same parameters on the same batch: the loss to
  relative 1e-5 and the updated parameters to 5e-6 absolute.  The first
  Adam step is lr * g / (|g| + eps) per entry: the convolutions' float
  rounding (XLA against oneDNN) moves entries whose |g| is near eps by up
  to 1.7e-6 (measured) of a 2e-3 step;
- ``_orbit``: 1e-6 relative (float64 on both sides, stored as float32);
- one view through ``_render_pair`` (config 1, brute force): equal to
  the port's own renders with the JAX package's seeds; against the JAX
  package's pair >= 99% of pixels within 1e-4 and image means to 1e-3
  relative.  Config 1's ground is a sphere of radius 1000, whose
  intersection cancels catastrophically: a 1-ulp t (XLA's fused
  multiply-adds) moves a bounce's origin and flips single pixels (1 of
  256 here), which the 99.9% rule of tests/test_torch_wavefront.py
  cannot absorb at 16x16."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optix_ray_tracer_tpu.models import benchmarks as jbench
from optix_ray_tracer_tpu.render import neural_denoise as jnd
from optix_ray_tracer_tpu.render import train_denoiser as jtd
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.models import benchmarks as tbench
from optix_ray_tracer_tpu_torch.render import neural_denoise as tnd
from optix_ray_tracer_tpu_torch.render import train_denoiser as ttd
from test_denoiser_training import _synthetic_imgs

torch.set_num_threads(2)


def test_crops_bit_exact():
    imgs = _synthetic_imgs(n=2, H=40, W=32)
    a = jtd._crops(imgs, 5, 16, np.random.default_rng(11))
    b = ttd._crops(imgs, 5, 16, np.random.default_rng(11))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.shape == (10, 16, 16, 3)
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("steps", [1, 60, 3000])
def test_lr_equals_optax_schedule(steps):
    sched = optax.cosine_decay_schedule(2e-3, steps, alpha=0.02)
    for i in (0, steps // 2, steps - 1, steps, steps + 5):
        np.testing.assert_allclose(ttd.cosine_lr(2e-3, steps, i),
                                   float(sched(i)), rtol=1e-6)


def test_adam_step_matches_optax():
    """One step from ``init_params(0)`` (the JAX package's arrays through
    ``convert.kpcn``) on one batch of crops."""
    imgs = _synthetic_imgs(n=2, H=32, W=32)
    batch = jtd._crops(imgs, 3, 16, np.random.default_rng(5))
    steps, lr = 10, 2e-3
    params = jax.tree.map(jnp.asarray, jnd.init_params(0))
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.02))

    def jloss(p, no, al, nr, cl):
        safe = jnd.demod_albedo(al)
        out = jnd.apply(p, no / safe, al, nr) * safe

        def tone(x):
            return x / (1.0 + jnp.abs(x))

        return jnp.abs(tone(out) - tone(cl)).mean()

    loss, grads = jax.value_and_grad(jloss)(params, *batch)
    updates, _ = opt.update(grads, opt.init(params))
    want = optax.apply_updates(params, updates)

    model = convert.kpcn(jnd.init_params(0), "cpu").train()
    topt = ttd.make_optimizer(model, lr)
    for group in topt.param_groups:
        group["lr"] = ttd.cosine_lr(lr, steps, 0)
    tloss = ttd.loss_fn(model, *(torch.as_tensor(a) for a in batch))
    tloss.backward()
    topt.step()
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=1e-5)
    got = model.arrays()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=5e-6,
                                   err_msg=k)


def test_train_runs_and_lowers_the_loss():
    """Three steps at batch 8 on 16x16 crops of three synthetic images:
    the loss over the whole crop set falls."""
    imgs = _synthetic_imgs(n=3, H=16, W=16)
    crops = [torch.as_tensor(a) for a in ttd._crops(
        imgs, 24, 16, np.random.default_rng(0))]
    start = tnd.KPCN.from_arrays(tnd.init_params(0), "cpu")
    model = ttd.train(imgs, steps=3, batch=8, crop=16, verbose=False,
                      device="cpu")
    assert isinstance(model, tnd.KPCN) and not model.training
    with torch.no_grad():
        before = float(ttd.loss_fn(start, *crops))
        after = float(ttd.loss_fn(model, *crops))
    assert after < before, (before, after)
    raw, atrous, neural = ttd.evaluate(model, imgs, verbose=False)
    assert np.isfinite([raw, atrous, neural]).all()


def test_weights_load_across_packages(tmp_path):
    """Weights the port saves load in the JAX package's ``load_params``
    and the other way round, array for array."""
    arrays = jnd.init_params(3)
    model = tnd.KPCN.from_arrays(arrays, "cpu")
    tnd.save_params(model, str(tmp_path / "port.npz"))
    back = jnd.load_params(str(tmp_path / "port.npz"))
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(back[k]), arrays[k])
    jnd.save_params(jax.tree.map(jnp.asarray, arrays),
                    str(tmp_path / "jax.npz"))
    loaded = tnd.load_params(str(tmp_path / "jax.npz"), "cpu").arrays()
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])


def test_dataset_cache_roundtrip(tmp_path):
    train_imgs = _synthetic_imgs(n=2, H=16, W=16)
    heldout = _synthetic_imgs(n=1, H=16, W=16, seed=5)
    p = str(tmp_path / "ds.npz")
    ttd._save_dataset(p, train_imgs, heldout)
    t2, h2 = ttd._load_dataset(p)
    assert len(t2) == 2 and len(h2) == 1
    for a, b in zip(train_imgs[0] + heldout[0], t2[0] + h2[0]):
        np.testing.assert_array_equal(a, b)
    # the JAX package reads the port's cache
    j2, _ = jtd._load_dataset(p)
    for a, b in zip(t2[1], j2[1]):
        np.testing.assert_array_equal(a, b)


def test_orbit_matches_jax():
    jc = JCamera.look_at((4.0, 1.0, 2.0), (0.5, -0.5, 0.0), (0, 0, 1))
    tc = convert.camera(convert.state_arrays(jc), "cpu")
    for angle, lift in ((0.7, 0.0), (0.45, -0.08)):
        j2 = jtd._orbit(jc, angle, lift)
        t2 = ttd._orbit(tc, angle, lift)
        np.testing.assert_allclose(t2.center.numpy(), np.asarray(j2.center),
                                   rtol=1e-6)
        np.testing.assert_allclose(t2.target.numpy(),
                                   np.asarray(tc.target), atol=1e-6)
    d1 = np.linalg.norm((tc.center - tc.target).numpy())
    t2 = ttd._orbit(tc, 0.7)
    np.testing.assert_allclose(np.linalg.norm((t2.center - t2.target)
                                              .numpy()), d1, rtol=1e-6)


@pytest.mark.parametrize("seed", [1000, 9001])
def test_procedural_cfg_matches_jax(seed):
    j = jtd._procedural_cfg(seed)
    t = ttd._procedural_cfg(seed, device="cpu")
    assert t["integrator"] == j["integrator"]
    assert t["background"] == pytest.approx(j["background"])
    for part in ("spheres", "triangles"):
        js, ts = getattr(j["scene"], part), getattr(t["scene"], part)
        np.testing.assert_array_equal(ts.material_id.numpy(),
                                      np.asarray(js.material_id))
    np.testing.assert_array_equal(t["scene"].triangles.vertices.numpy(),
                                  np.asarray(j["scene"].triangles.vertices))
    np.testing.assert_allclose(t["scene"].triangles.normals.numpy(),
                               np.asarray(j["scene"].triangles.normals),
                               atol=1e-6)
    np.testing.assert_allclose(t["materials"].albedo.numpy(),
                               np.asarray(j["materials"].albedo))
    np.testing.assert_allclose(t["camera"].center.numpy(),
                               np.asarray(j["camera"].center), rtol=1e-6)
    assert (t["env"] is None) == (j["env"] is None)
    assert (t["lights"] is None) == (j["lights"] is None)


def test_render_pair_matches_jax():
    """One 16x16 view of config 1 (brute force): noisy, guides and a
    4-spp clean frame are the port's own renders with the JAX package's
    seeds, and agree with the JAX package's pair."""
    from optix_ray_tracer_tpu_torch.render import wavefront

    jc = jbench.config1_sphere_ground()
    tc = tbench.config1_sphere_ground(device="cpu")
    got = ttd._render_pair(tc, tc["camera"], 16, seed=13, clean_spp=4)
    kw = dict(width=16, height=16, background=tc["background"],
              max_depth=5)
    noisy = wavefront.render(tc["scene"], tc["materials"], tc["camera"],
                             spp=1, seed=13, **kw)
    clean = wavefront.render(tc["scene"], tc["materials"], tc["camera"],
                             spp=4, seed=13 + 7919, samples_per_wave=4,
                             **kw)[0]
    for g, w in zip(got, tuple(noisy) + (clean,)):
        np.testing.assert_array_equal(g, w.numpy())
    want = jtd._render_pair(jc, jc["camera"], 16, seed=13, clean_spp=4)
    for g, w in zip(got, want):
        assert g.shape == (16, 16, 3) and g.dtype == np.float32
        diff = np.abs(g - np.asarray(w)).max(-1)
        assert (diff <= 1e-4).mean() >= 0.99
        np.testing.assert_allclose(g.mean(), np.asarray(w).mean(),
                                   rtol=1e-3)


def test_main_writes_only_under_tmp_path(tmp_path, monkeypatch):
    """``main --cpu --data ds.npz --out ...`` on a cached synthetic set:
    the weights and nothing else appear, under tmp_path, and the
    committed weights stay byte-identical."""
    def digest():
        with open(tnd.WEIGHTS_FILE, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    committed = digest()
    monkeypatch.chdir(tmp_path)
    ttd._save_dataset("ds.npz", _synthetic_imgs(n=2, H=64, W=64),
                      _synthetic_imgs(n=1, H=64, W=64, seed=5))
    ttd.main(["--cpu", "--data", "ds.npz", "--steps", "2",
              "--out", str(tmp_path / "w" / "weights.npz")])
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*")) == [
        "ds.npz", "w", "w/weights.npz"]
    assert set(jnd.load_params(str(tmp_path / "w" / "weights.npz"))) == \
        set(jnd.init_params(0))
    assert ttd.DEFAULT_OUT == "denoiser_weights.npz"
    assert digest() == committed
