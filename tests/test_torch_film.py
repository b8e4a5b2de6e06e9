"""The port's ``render/film.py`` and the rest of ``utils/color.py`` against
the JAX package on the CPU: accumulation, mean and the sRGB uint8 frame,
the written PNG/PPM and AOV files, and checkpoints written by either
package restored by the other.

Tolerance: none.  Film arithmetic is a multiply-add per sample count and
one float32 multiply by 1/spp on both sides, and the colour transforms
are the same elementwise formulas; measured equal bit for bit, so every
comparison here is exact except three held to 2 ulp (each measured
1 ulp): ``srgb_to_linear`` and ``color_to_float4``, whose ``pow`` rounds
its own way in XLA and PyTorch, and the tensor ``luminance``, a 3-term
dot that BLAS and XLA sum in their own order."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.render import film as jfilm
from optix_ray_tracer_tpu.utils import color as jcolor
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.render import film as tfilm
from optix_ray_tracer_tpu_torch.utils import color as tcolor

torch.set_num_threads(1)

W, H = 32, 24


def _images(seed):
    rng = np.random.default_rng(seed)
    rad = rng.gamma(1.0, 0.4, (H, W, 3)).astype(np.float32)
    alb = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return rad, alb, nrm


def _films():
    a, b = _images(1), _images(2)
    jf = jfilm.Film.create(W, H).add(*a, samples=3).add(b[0], samples=1)
    tf = tfilm.Film.create(W, H, device="cpu").add(
        *(torch.as_tensor(x) for x in a), samples=3).add(
        torch.as_tensor(b[0]), samples=1)
    return jf, tf


def test_accumulate_mean_uint8():
    jf, tf = _films()
    assert tf.spp == int(jf.spp) == 4
    for k in ("accum", "albedo_accum", "normal_accum"):
        np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                      np.asarray(getattr(jf, k)))
    np.testing.assert_array_equal(tf.mean().numpy(), np.asarray(jf.mean()))
    np.testing.assert_array_equal(tf.to_uint8(), jf.to_uint8())
    empty = tfilm.Film.create(4, 2, device="cpu")
    assert float(empty.mean().abs().max()) == 0.0


@pytest.mark.parametrize("ext", [".png", ".ppm"])
def test_save_matches_jax(tmp_path, ext):
    jf, tf = _films()
    jf.save(str(tmp_path / f"j{ext}"))
    tf.save(str(tmp_path / f"t{ext}"))
    assert (tmp_path / f"t{ext}").read_bytes() == \
        (tmp_path / f"j{ext}").read_bytes()
    jfilm.U8Frame(jf.to_uint8(), 4).save(str(tmp_path / f"ju{ext}"))
    tfilm.U8Frame(tf.to_uint8(), 4).save(str(tmp_path / f"tu{ext}"))
    assert (tmp_path / f"tu{ext}").read_bytes() == \
        (tmp_path / f"ju{ext}").read_bytes()


def test_save_aovs_matches_jax(tmp_path):
    jf, tf = _films()
    jp = jf.save_aovs(str(tmp_path / "j"))
    tp = tf.save_aovs(str(tmp_path / "t"))
    for a, b in zip(jp, tp):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint written by either package restores in the other:
    the same arrays, sample count and sidecar."""
    jf, tf = _films()
    path = str(tmp_path / "ckpt" / "film.npz")
    meta = {"seed": 5, "frame": 2}
    if writer == "jax":
        jf.checkpoint(path, meta)
        got = tfilm.Film.restore(path, device="cpu")
        ref = jf
    else:
        tf.checkpoint(path, meta)
        got = jfilm.Film.restore(path)
        ref = tf
    for k in ("accum", "albedo_accum", "normal_accum"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(ref, k)))
    assert int(got.spp) == int(ref.spp) == 4
    with open(path + ".json") as f:
        assert json.load(f) == meta


def test_convert_film():
    jf, tf = _films()
    cf = convert.film(convert.state_arrays(jf), device="cpu")
    assert cf.spp == tf.spp
    for k in ("accum", "albedo_accum", "normal_accum"):
        assert torch.equal(getattr(cf, k), getattr(tf, k))


def test_color_functions_match_jax(tmp_path):
    """luminance (2 ulp for tensors), srgb_to_linear and color_to_float4
    (2 ulp), and write_ppm against the JAX package."""
    rad, _, _ = _images(3)
    x = np.concatenate([rad, -rad[:2]], 0)           # negatives clip
    t = torch.as_tensor(x)
    got = tcolor.luminance(t).numpy()
    want = np.asarray(jcolor.luminance(jnp.asarray(x)))
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    np.testing.assert_array_equal(tcolor.luminance(x), jcolor.luminance(x))
    got = tcolor.color_to_float4(t).numpy()
    want = np.asarray(jcolor.color_to_float4(x))
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    s = np.clip(x, 0, 1)
    got = tcolor.srgb_to_linear(torch.as_tensor(s)).numpy()
    want = np.asarray(jcolor.srgb_to_linear(jnp.asarray(s)))
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    img = np.asarray(jcolor.color_to_uint8(rad))
    jcolor.write_ppm(str(tmp_path / "j.ppm"), img)
    tcolor.write_ppm(str(tmp_path / "t.ppm"), torch.as_tensor(img))
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()
