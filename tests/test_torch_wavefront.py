"""The slice end to end: the port's ``wavefront.render`` against the JAX
``wavefront.render`` on the same scene, materials, camera and ClusterSet
(a raster-enabled MarchIntersector on both sides, built from the JAX
clusters through convert.py).

The scene takes every kernel of the path: a ~2500-triangle METAL sphere
(more than SORT_FREE_TRIS, so bounce waves are probe-sorted: kernel C,
then kernel B) and a ROUGH ground quad in the cluster set, one analytic
sphere, and camera waves on the raster engine (kernel A).  Differences
can come only from fp rounding order (XLA vs PyTorch) and the tie flips
it causes, so: mean |diff| <= 1e-5 and >= 99.9% of pixels within 1e-4,
for the image and both guide buffers; sky pixels are exactly the sRGB
background (218, 232, 244)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import march as jmarch
from optix_ray_tracer_tpu.render import wavefront as jwave
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu.utils.color import color_to_uint8 as jcolor_to_uint8
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops.march import SORT_FREE_TRIS
from optix_ray_tracer_tpu_torch.render import wavefront as twave
from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8

torch.set_num_threads(2)

W = H = 64
SPP = 4
SEED = 7


@pytest.fixture(scope="module")
def frames():
    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.70, 0.60, 0.50))
    red = mb.add_rough((0.65, 0.05, 0.05))
    v, n = sphere_with_n_triangles(2500)
    qv, qn = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
    tris = JTriangles.from_arrays(v, n, metal).concat(
        JTriangles.from_arrays(qv, qn, ground))
    jscene = JScene(spheres=JSpheres.from_list([((0.2, 1.5, -0.6), 0.4,
                                                 red)]),
                    triangles=tris)
    jmats = mb.build()
    jcam = JCamera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0),
                           (0.0, 0.0, 1.0))
    jinter = jmarch.make_march_intersector(jscene, raster=True)
    assert jinter.num_tris > SORT_FREE_TRIS
    ref = jwave.render(jscene, jmats, jcam, W, H, spp=SPP, seed=SEED,
                       intersector=jinter, want_aux=True)

    tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    tinter = convert.march_intersector(
        convert.state_arrays(jinter.clusters), tscene, raster=True,
        device="cpu")
    got = twave.render(tscene, convert.materials(convert.state_arrays(jmats),
                                                 device="cpu"),
                       convert.camera(convert.state_arrays(jcam),
                                      device="cpu"), W, H,
                       spp=SPP, seed=SEED, intersector=tinter, want_aux=True)
    return ([np.asarray(x) for x in ref[:3]] + [np.asarray(x) for x in ref[3]],
            [x.numpy() for x in got[:3]] + [x.numpy() for x in got[3]])


@pytest.mark.parametrize("buffer", [0, 1, 2], ids=["image", "albedo",
                                                   "normal"])
def test_render_matches_jax(frames, buffer):
    ref, got = frames
    diff = np.abs(got[buffer] - ref[buffer])
    assert np.isfinite(got[buffer]).all()
    print(f"buffer {buffer}: mean |diff| {diff.mean():.3g}, "
          f"max {diff.max():.3g}")
    assert diff.mean() <= 1e-5, diff.mean()
    within = (diff.max(-1) <= 1e-4).mean()
    assert within >= 0.999, within


def test_sky_pixels(frames):
    ref, got = frames
    img = color_to_uint8(torch.as_tensor(got[0])).numpy()[..., :3]
    sky = (img == (218, 232, 244)).all(-1)
    # the top-left corner looks above the horizon; the port's and the JAX
    # package's sky masks agree
    assert sky[0, 0] and sky.sum() > 50
    jimg = np.asarray(jcolor_to_uint8(jnp.asarray(ref[0])))[..., :3]
    np.testing.assert_array_equal(sky, (jimg == (218, 232, 244)).all(-1))


def test_aux_buffers_match(frames):
    """want_aux: sample 0's primary-hit depth and triangle id."""
    ref, got = frames
    t_ref, prim_ref = ref[3], ref[4]
    t_got, prim_got = got[3], got[4]
    tie = np.abs(t_got - t_ref) <= 1e-5 * np.abs(t_ref) + 1e-6
    assert ((prim_got == prim_ref) | tie).all()
    assert (prim_got >= 0).any() and (prim_got == -1).any()


def test_matches_numpy_golden():
    """The port against the independent NumPy oracle of
    tests/test_render_golden.py (spheres only, brute-force intersector),
    at the JAX package's own tolerance for that test."""
    from test_render_golden import BG, _test_scene, oracle_render

    jscene, jmats, jcam, spheres, omats = _test_scene()
    w, h, spp, seed = 24, 16, 2, 11
    img, _, _ = twave.render(
        convert.scene(convert.state_arrays(jscene), device="cpu"),
        convert.materials(convert.state_arrays(jmats), device="cpu"),
        convert.camera(convert.state_arrays(jcam), device="cpu"), w, h,
        spp=spp,
        seed=seed, background=tuple(BG))
    ref = oracle_render([s[0] for s in spheres], [s[1] for s in spheres],
                        [s[2] for s in spheres], omats, jcam, w, h, spp, seed)
    np.testing.assert_allclose(img.numpy(), ref, atol=5e-3)


def test_empty_scene_is_background():
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu_torch.scene.materials import (
        MaterialBuilder as TMaterialBuilder,
    )
    cam = Camera.look_at((0, 0, 0), (1, 0, 0), (0, 0, 1), device="cpu")
    img, _, _ = twave.render(Scene(Spheres.empty(device="cpu"),
                                   Triangles.empty(device="cpu")),
                             TMaterialBuilder().build(device="cpu"), cam, 8,
                             8, spp=1)
    np.testing.assert_allclose(
        img.numpy(), np.broadcast_to(np.float32([0.7, 0.8, 0.9]), (8, 8, 3)),
        atol=1e-6)
