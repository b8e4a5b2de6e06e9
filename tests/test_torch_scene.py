"""The port's device math, scene, camera, colour, brute-force oracle and
scatter against the JAX package on the same numpy inputs.

Tolerances: exact where both sides do the same float32 operations
(camera basis, Morton keys, sRGB bytes); 2e-7 for normalized vectors
(XLA may turn 1/sqrt into rsqrt); the hit rule for the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import intersect as jisect
from optix_ray_tracer_tpu.ops import raysort as jraysort
from optix_ray_tracer_tpu.render import wavefront as jwave
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu.utils import color as jcolor
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.io import meshgen as tmeshgen
from optix_ray_tracer_tpu_torch.ops import intersect as tisect
from optix_ray_tracer_tpu_torch.ops import raysort as traysort
from optix_ray_tracer_tpu_torch.render import wavefront as twave
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.utils import color as tcolor

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_meshgen_copy_is_identical():
    for a, b in zip(sphere_with_n_triangles(700),
                    tmeshgen.sphere_with_n_triangles(700)):
        np.testing.assert_array_equal(a, b)
    q = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    for a, b in zip(quad(*q), tmeshgen.quad(*q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("jitter", [False, True])
def test_camera_rays_match(jitter):
    args = ((3.0, 0.2, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    jc, tc = JCamera.look_at(*args), Camera.look_at(*args, device="cpu")
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), rtol=0,
                                   atol=2e-7)
    jit = (np.random.default_rng(1).random((2, 24, 32, 2)).astype(np.float32)
           if jitter else None)
    jo, jd = jc.generate_rays(32, 24, None if jit is None else
                              jnp.asarray(jit))
    tcam = convert.camera(convert.state_arrays(jc), device="cpu")
    to, td = tcam.generate_rays(32, 24, None if jit is None else _t(jit))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=2e-7)


def test_color_bytes_match():
    x = np.random.default_rng(2).uniform(-0.1, 1.3, (64, 64, 3)
                                         ).astype(np.float32)
    np.testing.assert_array_equal(
        tcolor.color_to_uint8(_t(x)).numpy(),
        np.asarray(jcolor.color_to_uint8(jnp.asarray(x))))


def _scene():
    v, n = sphere_with_n_triangles(600)
    qv, qn = quad((-3, -3, -1), (3, -3, -1), (3, 3, -1), (-3, 3, -1))
    tris = JTriangles.from_arrays(v, n, 0).concat(
        JTriangles.from_arrays(qv, qn, 1))
    return JScene(spheres=JSpheres.from_list([((0.0, 1.5, -0.5), 0.5, 1),
                                              ((0.5, -1.5, 0.0), 0.3, 0)]),
                  triangles=tris)


def _rays(n=512, seed=4):
    r = np.random.default_rng(seed)
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_bruteforce_oracle_matches():
    js = _scene()
    ts = convert.scene(convert.state_arrays(js), device="cpu")
    o, d = _rays()
    jh = jisect.intersect_scene_bruteforce(js, jnp.asarray(o), jnp.asarray(d))
    th = tisect.intersect_scene_bruteforce(ts, _t(o), _t(d))
    np.testing.assert_array_equal(th.prim_type.numpy(),
                                  np.asarray(jh.prim_type))
    assert tisect.hit_mismatches(th.prim_id, th.t, _t(jh.prim_id),
                                 _t(jh.t)) == 0
    occ = tisect.intersect_any_bruteforce(ts, _t(o), _t(d), t_max=0.8)
    jocc = jisect.intersect_any_bruteforce(js, jnp.asarray(o),
                                           jnp.asarray(d), t_max=0.8)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_shading_and_scatter_match():
    js = _scene()
    ts = convert.scene(convert.state_arrays(js), device="cpu")
    mb = MaterialBuilder()
    mb.add_metal((0.8, 0.85, 0.88), 0.1)
    mb.add_rough((0.7, 0.6, 0.5))
    jm = mb.build()
    tm = convert.materials(convert.state_arrays(jm), device="cpu")
    o, d = _rays(seed=6)
    jh = jisect.intersect_scene_bruteforce(js, jnp.asarray(o), jnp.asarray(d))
    th = tisect.intersect_scene_bruteforce(ts, _t(o), _t(d))
    same = th.prim_id.numpy() == np.asarray(jh.prim_id)
    jp, jn, jf, jmid = jisect.shading_frame(js, jnp.asarray(o),
                                            jnp.asarray(d), jh)
    tp, tn, tf, tmid = tisect.shading_frame(ts, _t(o), _t(d), th)
    np.testing.assert_array_equal(tmid.numpy()[same], np.asarray(jmid)[same])
    np.testing.assert_array_equal(tf.numpy()[same], np.asarray(jf)[same])
    np.testing.assert_allclose(tn.numpy()[same], np.asarray(jn)[same],
                               rtol=0, atol=1e-5)
    pix = np.arange(o.shape[0], dtype=np.int32)
    jdir, jatt, _, _ = jwave.scatter(jm, jmid, jnp.asarray(d), jn, jf,
                                     jnp.asarray(pix), jnp.int32(3), 1,
                                     jnp.int32(5))
    tdir, tatt, _, _ = twave.scatter(tm, _t(jmid), _t(d), _t(jn), _t(jf),
                                     _t(pix), 3, 1, 5)
    np.testing.assert_array_equal(tatt.numpy(), np.asarray(jatt))
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir), rtol=0,
                               atol=2e-6)


def test_sort_keys_match():
    o, d = _rays(2048, seed=8)
    lo, hi = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32)
    ref = np.asarray(jraysort.ray_sort_keys(jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(lo), jnp.asarray(hi)))
    got = traysort.ray_sort_keys(_t(o), _t(d), _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
