"""The device refit and rebuild of the port (``ops/sweep.refit_clusters``,
``rebuild_clusters``, ``ops/march.refit_march_intersector``,
``rebuild_march_intersector``) and the frontends' intersector choice
(``models/common``) against the JAX package on the CPU, on the same numpy
triangles.

Tolerance: refit and rebuild ClusterSets bit for bit (Woop rows, boxes
with their NaN padding, slot orders, "median" and "morton", exact-tie
centroids included): the port rounds every operation as XLA's CPU
backend does, a fused multiply-add in each cross-product component.
Hits of the moved scene: the hit rule (prim ids equal, or |dt| <=
1e-5 |t| + 1e-6) with no exceptions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.models import common as jcommon
from optix_ray_tracer_tpu.ops import march as jmarch
from optix_ray_tracer_tpu.ops import sweep as jsweep
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.models import common as tcommon
from optix_ray_tracer_tpu_torch.ops import march as tmarch
from optix_ray_tracer_tpu_torch.ops import sweep as tsweep
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from optix_ray_tracer_tpu_torch.utils import debug as tdebug
from optix_ray_tracer_tpu_torch.utils.logging import RendererError

torch.set_num_threads(2)


def _tris(n: int, seed: int) -> np.ndarray:
    """n random triangles; a quarter of them on a coarse grid, so many
    centroids tie exactly (and some triangles are duplicates)."""
    rng = np.random.default_rng(seed)
    tv = rng.uniform(-1.0, 1.0, (n, 3, 3)).astype(np.float32)
    q = n // 4
    tv[:q] = np.round(tv[:q] * 2.0) / 2.0
    tv[q:2 * q:7] = tv[q + 1:2 * q + 1:7]
    return tv


def _assert_clusters_equal(jc, tc):
    for f in convert.CLUSTER_FIELDS:
        a = np.asarray(getattr(jc, f))
        b = getattr(tc, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# 700 leaves the last cluster's three last sub boxes pure padding (NaN)
@pytest.mark.parametrize("n", [700, 1024, 3000])
def test_refit_clusters_bit_equal(n):
    tv = _tris(n, n)
    jc = jsweep.build_clusters(tv)
    tc = convert.clusters(convert.state_arrays(jc), device="cpu")
    moved = (tv + np.random.default_rng(1).normal(0.0, 0.05, tv.shape)
             ).astype(np.float32)
    jr = jsweep.refit_clusters(jc, jnp.asarray(moved))
    tr = tsweep.refit_clusters(tc, torch.as_tensor(moved))
    _assert_clusters_equal(jr, tr)
    if n % tsweep.SUB_TRIS:
        assert torch.isnan(tr.sub_max[-1]).all()


def test_centroids_round_as_jnp_mean():
    tv = _tris(5000, 3)
    np.testing.assert_array_equal(
        tsweep.centroids(torch.as_tensor(tv)).numpy(),
        np.asarray(jnp.mean(jnp.asarray(tv), axis=1)))


@pytest.mark.parametrize("n", [300, 5000, 20000])
def test_median_levels(n):
    for a, b in zip(tsweep._median_levels(n), jsweep._median_levels(n),
                    strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["median", "morton"])
@pytest.mark.parametrize("n", [700, 3000])
def test_rebuild_clusters_bit_equal(method, n):
    tv = _tris(n, 10 + n)
    jc = jsweep.build_clusters(tv)
    tc = convert.clusters(convert.state_arrays(jc), device="cpu")
    moved = (tv * 1.3 + np.random.default_rng(2).normal(0.0, 0.2, tv.shape)
             ).astype(np.float32)
    # exact-tie centroids in the moved set too
    moved[:8] = moved[8:16]
    jr = jsweep.rebuild_clusters(jc, jnp.asarray(moved), method=method)
    tr = tsweep.rebuild_clusters(tc, torch.as_tensor(moved), method=method)
    _assert_clusters_equal(jr, tr)


def test_rebuild_rejects_unknown_method():
    tc = tsweep.build_clusters(_tris(300, 4), device="cpu")
    with pytest.raises(ValueError, match="unknown cluster rebuild"):
        tsweep.rebuild_clusters(tc, torch.as_tensor(_tris(300, 5)), "sah")


@pytest.fixture(scope="module")
def scenes():
    """A ~2450-triangle sphere and the same sphere deformed; the JAX and
    the port's raster-enabled intersectors over one ClusterSet."""
    v, n = sphere_with_n_triangles(2500)
    rng = np.random.default_rng(9)
    v2 = (v * np.float32(1.1) + rng.normal(0.0, 0.01, v.shape)
          + np.float32(0.05)).astype(np.float32)
    js = [JScene(spheres=JSpheres.empty(),
                 triangles=JTriangles.from_arrays(x, n, 0)) for x in (v, v2)]
    ts = [convert.scene(convert.state_arrays(s), device="cpu") for s in js]
    jinter = jmarch.make_march_intersector(js[0], raster=True)
    tinter = convert.march_intersector(convert.state_arrays(jinter.clusters),
                                       ts[0], raster=True, device="cpu")
    cam = JCamera.look_at((3.0, 0.2, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    oc, dc = (np.asarray(x).reshape(-1, 3) for x in cam.generate_rays(32, 32))
    oi = rng.uniform(-1.3, 1.3, (512, 3)).astype(np.float32)
    di = rng.normal(size=(512, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    return js, ts, jinter, tinter, (oc, dc), (oi, di)


_OPS = {
    "refit": (jmarch.refit_march_intersector, tmarch.refit_march_intersector),
    "rebuild-median": (jmarch.rebuild_march_intersector,
                       tmarch.rebuild_march_intersector),
    "rebuild-morton": (
        lambda p, s: jmarch.rebuild_march_intersector(p, s, method="morton"),
        lambda p, s: tmarch.rebuild_march_intersector(p, s, method="morton")),
}


@pytest.mark.parametrize("op", list(_OPS))
def test_march_intersector_moved(scenes, op):
    """Clusters and bounds equal to JAX's; the raster tables re-attached;
    the moved scene's hits equal under the hit rule, incoherent rays
    through the marcher and the camera wave through the raster engine."""
    js, ts, jinter, tinter, cam, inc = scenes
    jop, top = _OPS[op]
    jm = jop(jinter, js[1])
    tm = top(tinter, ts[1])
    _assert_clusters_equal(jm.clusters, tm.clusters)
    for f in ("scene_lo", "scene_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)),
                                      getattr(tm, f).numpy())
    assert tm.num_tris == tinter.num_tris and tm.sort_mode == "morton"
    assert tm.raster is not None
    expect = tmarch.attach_raster(
        tmarch.MarchIntersector(tm.clusters, tm.scene_lo, tm.scene_hi),
        ts[1]).raster
    for a, b in zip(convert.state_arrays(tm.raster).values(),
                    convert.state_arrays(expect).values()):
        np.testing.assert_array_equal(a, b)

    o, d = inc
    jh = jm.intersect(js[1], jnp.asarray(o), jnp.asarray(d))
    th = tm.intersect(ts[1], torch.as_tensor(o), torch.as_tensor(d))
    assert bool(th.is_hit.any()) and not bool(th.is_hit.all())
    assert hit_mismatches(th.prim_id, th.t, torch.as_tensor(
        np.array(jh.prim_id)), torch.as_tensor(np.array(jh.t))) == 0

    o, d = cam
    p = o[0]
    jh = jm.intersect_from(js[1], jnp.asarray(o), jnp.asarray(d),
                           mode="origin", point=jnp.asarray(p),
                           block_rays=256)
    th = tm.intersect_from(ts[1], torch.as_tensor(o), torch.as_tensor(d),
                           mode="origin", point=torch.as_tensor(p),
                           block_rays=256)
    assert bool(th.is_hit.any())
    assert hit_mismatches(th.prim_id, th.t, torch.as_tensor(
        np.array(jh.prim_id)), torch.as_tensor(np.array(jh.t))) == 0


@pytest.mark.parametrize("what", ["refit", "rebuild"])
def test_changed_count_raises(scenes, what):
    js, ts, jinter, tinter, _, _ = scenes
    tv = ts[0].triangles
    cut = type(ts[0])(spheres=ts[0].spheres, triangles=type(tv)(
        tv.vertices[:-1], tv.normals[:-1], tv.material_id[:-1]))
    fn = (tmarch.refit_march_intersector if what == "refit"
          else tmarch.rebuild_march_intersector)
    with pytest.raises(ValueError, match="triangle count"):
        fn(tinter, cut)


def _scene_pair(n_tris: int):
    """(JAX scene, port scene) of n_tris triangles (a sphere's, cut)."""
    v, n = sphere_with_n_triangles(2 * n_tris)
    v, n = v[:n_tris], n[:n_tris]
    js = JScene(spheres=JSpheres.empty(),
                triangles=JTriangles.from_arrays(v, n, 0))
    return js, convert.scene(convert.state_arrays(js), device="cpu")


@pytest.mark.parametrize("n_tris", [1023, 1024])
def test_choose_intersector_cpu_threshold(n_tris):
    """Brute force (None) under 1024 triangles on the CPU, as the JAX
    package chooses on its CPU backend; else a raster-enabled marcher."""
    js, ts = _scene_pair(n_tris)
    j = jcommon.choose_intersector(js)
    t = tcommon.choose_intersector(ts)
    assert (j is None) == (t is None) == (n_tris < 1024)
    if t is not None:
        assert isinstance(t, tmarch.MarchIntersector)
        assert t.raster is not None and t.num_tris == n_tris
        _assert_clusters_equal(j.clusters, t.clusters)


@pytest.mark.parametrize("fn", ["refit_or_choose", "rebuild_or_choose"])
def test_or_choose(scenes, fn):
    """Same count: the device refit / rebuild of ``prev``; a changed count
    or no ``prev``: a fresh host build, as the JAX package does."""
    js, ts, jinter, tinter, _, _ = scenes
    tfn, jfn = getattr(tcommon, fn), getattr(jcommon, fn)
    same = tfn(tinter, ts[1])
    _assert_clusters_equal(jfn(jinter, js[1]).clusters, same.clusters)
    if fn == "refit_or_choose":
        assert torch.equal(same.clusters.prim_index,
                           tinter.clusters.prim_index)
    js2, ts2 = _scene_pair(1500)
    fresh = tfn(tinter, ts2)
    assert fresh.num_tris == 1500
    _assert_clusters_equal(jfn(jinter, js2).clusters, fresh.clusters)
    assert tfn(None, ts[1]).num_tris == tinter.num_tris
    assert tfn(None, _scene_pair(100)[1]) is None


def test_debug_validation(scenes, monkeypatch):
    """Debug mode validates every build, refit and rebuild: a refit passes,
    a cluster box that no longer holds its triangles raises."""
    js, ts, jinter, tinter, _, _ = scenes
    monkeypatch.setattr(tdebug, "DEBUG_MODE", True)
    plain = tcommon.refit_or_choose(tinter, ts[1])
    assert plain.raster is not None   # refit keeps prev's tables
    assert tcommon.choose_intersector(ts[1]).raster is None
    bad = tsweep.ClusterSet(**{**{f: getattr(plain.clusters, f) for f in
                                  convert.CLUSTER_FIELDS},
                               "cluster_max": plain.clusters.cluster_max
                               - 0.5})
    with pytest.raises(RendererError, match="containment"):
        tdebug.validate_clusters(bad, ts[1].triangles.vertices,
                                 plain.num_tris)
    tdebug.validate_clusters(tsweep.refit_clusters(
        tinter.clusters, ts[0].triangles.vertices), ts[0].triangles.vertices,
        tinter.num_tris)
