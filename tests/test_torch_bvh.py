"""The port's LBVH (ops/bvh.py) and its traversal (ops/traverse.py)
against the JAX package's and against the brute-force oracle, the
flagship step of ``graft.entry``, and the API names the port took over
last (``Instances``, ``ShapeLibrary.flatten_instances``,
``Triangles.transformed``, ``rng.uniform_in_range``, ``vecmath.vec3``,
``vecmath.is_finite``).

Tolerances, each with its reason:
- the LBVH arrays (leaf order, children, boxes), Morton codes and
  primitive bounds: equal (integer work, a stable sort, min / max);
- hits against brute force: the hit rule of bench.py (prim ids equal, or
  |dt| <= 1e-5 |t| + 1e-6) with no exception; occlusion equal;
- a render through the LBVH against the brute-force render: 1e-4, the
  JAX package's own rule (tests/test_bvh.py: the traversal's sphere test
  takes unit directions, brute force divides by |d|^2);
- the straggler names against the JAX package: equal for integer and
  selection work, 1e-6 relative for float arithmetic (XLA's fused
  multiply-adds, jnp.linalg.inv against torch.linalg.inv)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.ops import bvh as jbvh
from optix_ray_tracer_tpu.ops import traverse as jtrav
from optix_ray_tracer_tpu.scene import geometry as jgeo
from optix_ray_tracer_tpu.utils import rng as jrng
from optix_ray_tracer_tpu.utils import vecmath as jvec
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import bvh as tbvh
from optix_ray_tracer_tpu_torch.ops import intersect as tisect
from optix_ray_tracer_tpu_torch.ops import traverse as ttrav
from optix_ray_tracer_tpu_torch.scene import geometry as tgeo
from optix_ray_tracer_tpu_torch.utils import rng as trng
from optix_ray_tracer_tpu_torch.utils import vecmath as tvec
from optix_ray_tracer_tpu_torch.utils.tensors import tree_map

torch.set_num_threads(2)

CPU = "cpu"
LBVH_FIELDS = ("node_min", "node_max", "left", "right", "prim_index")


def _random_scene(n_tri, n_sph, seed=0, spread=2.0):
    """tests/test_bvh.py's random soup, in both packages."""
    rng = np.random.default_rng(seed)
    tris, sph = jgeo.Triangles.empty(), jgeo.Spheres.empty()
    if n_tri:
        c = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
        tri = np.stack([c, c + rng.normal(0, 0.2, (n_tri, 3)),
                        c + rng.normal(0, 0.2, (n_tri, 3))], 1)
        tris = jgeo.Triangles.from_arrays(tri.astype(np.float32))
    if n_sph:
        sph = jgeo.Spheres.from_list([
            (tuple(rng.uniform(-spread, spread, 3)),
             float(rng.uniform(0.05, 0.3)), 0) for _ in range(n_sph)])
    js = jgeo.Scene(spheres=sph, triangles=tris)
    return js, convert.scene(convert.state_arrays(js), CPU)


def _random_rays(n, seed=1, spread=4.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o), torch.as_tensor(d)


def _assert_lbvh_equal(t, j):
    for f in LBVH_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("n", [2, 3, 7, 64, 1000])
def test_build_matches_jax_random(n):
    rng = np.random.default_rng(n)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    r = rng.uniform(0.01, 0.1, (n, 1)).astype(np.float32)
    t = tbvh.build_lbvh(*(torch.as_tensor(a) for a in (c - r, c + r, c)))
    _assert_lbvh_equal(t, jbvh.build_lbvh(jnp.asarray(c - r),
                                          jnp.asarray(c + r),
                                          jnp.asarray(c)))
    assert all(tbvh.validate_lbvh(t).values()), tbvh.validate_lbvh(t)
    np.testing.assert_array_equal(
        tbvh.morton_codes(torch.as_tensor(c), torch.full((3,), -1.0),
                          torch.ones(3)).numpy(),
        np.asarray(jbvh.morton_codes(jnp.asarray(c), jnp.full(3, -1.0),
                                     jnp.ones(3))))


def test_build_matches_jax_duplicate_positions():
    """33 primitives at one point: all Morton codes equal, the index
    breaks the ties."""
    c = np.zeros((33, 3), np.float32)
    r = np.full((33, 1), 0.1, np.float32)
    t = tbvh.build_lbvh(*(torch.as_tensor(a) for a in (c - r, c + r, c)))
    _assert_lbvh_equal(t, jbvh.build_lbvh(jnp.asarray(c - r),
                                          jnp.asarray(c + r),
                                          jnp.asarray(c)))
    assert all(tbvh.validate_lbvh(t).values())


@pytest.mark.parametrize("n_tri,n_sph", [(200, 20), (0, 50), (300, 0)])
def test_scene_lbvh_matches_jax(n_tri, n_sph):
    js, ts = _random_scene(n_tri, n_sph, seed=3)
    for a, b in zip(tbvh.scene_primitive_bounds(ts),
                    jbvh.scene_primitive_bounds(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t = tbvh.build_scene_lbvh(ts)
    _assert_lbvh_equal(t, jbvh.build_scene_lbvh(js))
    mins, maxs, _ = tbvh.scene_primitive_bounds(ts)
    np.testing.assert_array_equal(t.node_min[0].numpy(),
                                  mins.amin(0).numpy())
    np.testing.assert_array_equal(t.node_max[0].numpy(),
                                  maxs.amax(0).numpy())


def _hold(hit, ref):
    assert tisect.hit_mismatches(hit.prim_id, hit.t, ref.prim_id,
                                 ref.t) == 0
    np.testing.assert_array_equal(hit.prim_type.numpy(),
                                  ref.prim_type.numpy())


@pytest.mark.parametrize("n_tri,n_sph", [(100, 0), (0, 100), (300, 50)])
def test_traversal_matches_bruteforce(n_tri, n_sph):
    js, ts = _random_scene(n_tri, n_sph, seed=n_tri + n_sph)
    bi = ttrav.make_intersector(ts)
    assert isinstance(bi, ttrav.BVHIntersector) and bi.bvh is not None
    o, d = _random_rays(500)
    hit = bi(ts, o, d)
    _hold(hit, tisect.intersect_scene_bruteforce(ts, o, d))
    # and the JAX package's traversal: the same primitives
    jhit = jtrav.make_intersector(js)(js, jnp.asarray(o.numpy()),
                                      jnp.asarray(d.numpy()))
    assert tisect.hit_mismatches(
        hit.prim_id, hit.t, torch.tensor(np.asarray(jhit.prim_id)),
        torch.tensor(np.asarray(jhit.t))) == 0


def test_rays_from_inside_and_bounds():
    """Origins inside the cloud, per-ray t bounds, and a (4, 50) batch
    shape."""
    _, ts = _random_scene(200, 0, seed=9, spread=1.0)
    bi = ttrav.make_intersector(ts)
    o, d = _random_rays(200, seed=2, spread=0.5)
    t_max = torch.linspace(0.2, 3.0, 200)
    hit = bi.intersect(ts, o.reshape(4, 50, 3), d.reshape(4, 50, 3),
                       t_min=1e-3, t_max=t_max.reshape(4, 50))
    assert hit.t.shape == (4, 50)
    _hold(tree_map(lambda x: x.reshape(-1), hit),
          tisect.intersect_scene_bruteforce(ts, o, d, 1e-3, t_max))


def test_any_hit():
    _, ts = _random_scene(100, 10, seed=5)
    bi = ttrav.make_intersector(ts)
    o, d = _random_rays(300, seed=7)
    np.testing.assert_array_equal(
        bi.any_hit(ts, o, d).numpy(),
        tisect.intersect_scene_bruteforce(ts, o, d).is_hit.numpy())
    t_max = torch.full((300,), 0.5)
    np.testing.assert_array_equal(
        bi.any_hit(ts, o, d, t_max=t_max).numpy(),
        tisect.intersect_any_bruteforce(ts, o, d, t_max=t_max).numpy())


def test_tiny_scene_falls_back():
    _, ts = _random_scene(1, 0)
    bi = ttrav.make_intersector(ts)
    assert isinstance(bi, ttrav.BVHIntersector) and bi.bvh is None
    o, d = _random_rays(16)
    ref = tisect.intersect_scene_bruteforce(ts, o, d)
    np.testing.assert_array_equal(bi(ts, o, d).t.numpy(), ref.t.numpy())
    np.testing.assert_array_equal(bi.any_hit(ts, o, d).numpy(),
                                  ref.is_hit.numpy())
    _, ts2 = _random_scene(10, 0)
    assert isinstance(ttrav.make_intersector(ts2, use_bvh=False),
                      ttrav.BruteForceIntersector)


def test_bruteforce_reexport():
    """``BruteForceIntersector`` lives in ops/traverse.py, as in the JAX
    package; ops/intersect.py still names it."""
    assert tisect.BruteForceIntersector is ttrav.BruteForceIntersector
    with pytest.raises(AttributeError):
        tisect.NoSuchName  # noqa: B018


def test_render_with_bvh_matches_bruteforce_image():
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mb = MaterialBuilder()
    mb.add_rough((0.6, 0.4, 0.3))
    mats = mb.build(CPU)
    _, ts = _random_scene(200, 10, seed=13)
    cam = Camera.look_at((6.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=CPU)
    ref = wavefront.render(ts, mats, cam, 32, 32, spp=1, seed=5)[0]
    img = wavefront.render(ts, mats, cam, 32, 32, spp=1, seed=5,
                           intersector=ttrav.make_intersector(ts))[0]
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-4)


def test_graft_entry_flagship_step():
    """``graft.entry``: the 64x64, spp 1, depth 5 Whitted step through the
    LBVH, against the same step through brute force."""
    from optix_ray_tracer_tpu_torch.graft import entry
    from optix_ray_tracer_tpu_torch.render import wavefront

    fn, args = entry(device=CPU)
    assert isinstance(args[3], ttrav.BVHIntersector)
    img = fn(*args)
    assert img.shape == (64, 64, 3) and torch.isfinite(img).all()
    ref = wavefront.render(*args[:3], 64, 64, spp=1, seed=0)[0]
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-4)


def test_vecmath_and_rng_stragglers():
    x = np.float32([0.5, -1.0, 2.0])
    np.testing.assert_array_equal(
        tvec.vec3(torch.as_tensor(x), 2.0, torch.as_tensor(x[::-1].copy()))
        .numpy(), np.asarray(jvec.vec3(x, 2.0, x[::-1])))
    assert tvec.vec3(1, 2, 3).dtype == torch.float32
    v = np.float32([[1, 2, 3], [np.inf, 0, 0], [0, np.nan, 1], [0, 0, 0]])
    np.testing.assert_array_equal(tvec.is_finite(torch.as_tensor(v)).numpy(),
                                  np.asarray(jvec.is_finite(v)))
    u = np.random.default_rng(0).random(64).astype(np.float32)
    np.testing.assert_allclose(
        trng.uniform_in_range(torch.as_tensor(u), -0.3, 2.5).numpy(),
        np.asarray(jrng.uniform_in_range(jnp.asarray(u), -0.3, 2.5)),
        rtol=1e-6)


def _instances():
    rng = np.random.default_rng(4)
    args = (rng.normal(size=(5, 3)).astype(np.float32),
            rng.uniform(-180, 180, (5, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32),
            np.int32([0, 1, 2, 1, 0]), np.int32([3, 4, 5, 6, 7]))
    meshes = [(rng.normal(size=(k, 3, 3)).astype(np.float32),
               rng.normal(size=(k, 3, 3)).astype(np.float32))
              for k in (4, 7, 2)]
    return args, meshes


def test_instances_match_jax():
    args, _ = _instances()
    j = jgeo.Instances.from_srt(*args)
    t = tgeo.Instances.from_srt(*args, device=CPU)
    assert t.count == j.count == 5
    for f in ("transforms", "inv_transforms"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for f in ("shape_id", "material_id"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    assert t.transforms.dtype == torch.float32


@pytest.mark.parametrize("budget", [None, 9])
def test_flatten_instances_matches_jax(budget):
    args, meshes = _instances()
    jl = jgeo.ShapeLibrary.from_meshes(meshes)
    tl = tgeo.ShapeLibrary.from_meshes(meshes, device=CPU)
    ji = jgeo.Instances.from_srt(*args)
    ti = tgeo.Instances.from_srt(*args, device=CPU)
    jt, tt = jl.flatten_instances(ji, budget), tl.flatten_instances(ti,
                                                                   budget)
    assert tt.count == jt.count == 5 * (budget or 7)
    for f in ("vertices", "normals"):
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   np.asarray(getattr(jt, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tt.material_id.numpy(),
                                  np.asarray(jt.material_id))
    empty = tgeo.ShapeLibrary.from_meshes([], device=CPU)
    assert empty.flatten_instances(ti).count == 0


def test_triangles_transformed_matches_jax():
    args, meshes = _instances()
    jt = jgeo.Triangles.from_arrays(meshes[1][0], meshes[1][1], 2)
    tt = tgeo.Triangles.from_arrays(meshes[1][0], meshes[1][1], 2,
                                    device=CPU)
    ji = jgeo.Instances.from_srt(*args)
    ti = tgeo.Instances.from_srt(*args, device=CPU)
    a, b = jt.transformed(ji.transforms[2]), tt.transformed(ti.transforms[2])
    np.testing.assert_allclose(b.vertices.numpy(), np.asarray(a.vertices),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.normals.numpy(), np.asarray(a.normals),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(b.material_id.numpy(),
                                  np.asarray(a.material_id))
