"""Kernel A (tile raster) through ``raster_query`` / ``intersect_from``:
the port's plain PyTorch version against the JAX functions (Pallas
interpret mode on the CPU) over the very same ClusterSet, in origin mode
(nearest at g=4, any-hit at g=2), target mode and the flipped occlusion
wave, plus the overflow contract.

Hit rule (bench.py): prim ids equal, or |dt| <= 1e-5 |t| + 1e-6 at an
fp-equal t.  u and v agree to 1e-5 where prims agree, on top of the
hit rule's allowance on t (see test_torch_block_march.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import march as jmarch
from optix_ray_tracer_tpu.ops import raster as jraster
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import raster as traster
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from test_torch_block_march import assert_uv_close

torch.set_num_threads(2)

LIGHT = (3.0, 3.0, 3.0)


@pytest.fixture(scope="module")
def setup():
    v, n = sphere_with_n_triangles(1000)
    jscene = JScene(spheres=JSpheres.empty(),
                    triangles=JTriangles.from_arrays(v, n))
    jinter = jmarch.make_march_intersector(jscene, raster=True)
    tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    tinter = convert.march_intersector(
        convert.state_arrays(jinter.clusters), tscene, raster=True,
        device="cpu")
    cam = JCamera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = cam.generate_rays(48, 48)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    return jscene, jinter, tscene, tinter, o, d


def _t(x):
    return torch.as_tensor(np.array(x))


def _prims(prim_index, slot):
    slot = np.asarray(slot)
    return np.where(slot < 0, -1, np.asarray(prim_index)[np.maximum(slot, 0)])


def _query(jinter, tinter, o, d, tmin, tmax, **kw):
    jr = jraster.raster_query(jinter.raster, jinter.clusters, jnp.asarray(o),
                              jnp.asarray(d), jnp.asarray(tmin),
                              jnp.asarray(tmax), **kw)
    if "point" in kw:
        kw["point"] = _t(kw["point"])
    tr = traster.raster_query(tinter.raster, tinter.clusters, _t(o), _t(d),
                              _t(tmin), _t(tmax), **kw)
    return jr, tr


def _shadow_wave(tinter, tscene, o, d):
    """Shadow rays from the camera wave's hits toward LIGHT."""
    h = tinter.intersect(tscene, _t(o), _t(d))
    p = torch.where(h.is_hit[:, None], _t(o) + h.t[:, None] * _t(d), _t(o))
    to_l = torch.tensor(LIGHT) - p
    dist = torch.linalg.norm(to_l, dim=-1)
    wl = to_l / dist[:, None]
    return (p + wl * 1e-3).numpy(), wl.numpy(), (dist - 1e-3).numpy()


@pytest.mark.parametrize("granularity", [1, 4])
def test_origin_nearest_matches_jax(setup, granularity):
    _, jinter, _, tinter, o, d = setup
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::11] = 0.0                                  # dead rays
    (jt, js, ju, jv, jok), (tt, ts, tu, tv, tok) = _query(
        jinter, tinter, o, d, tmin, tmax, mode="origin", point=o[0],
        block_rays=128, granularity=granularity)
    assert bool(jok) and tok
    pj = _prims(jinter.clusters.prim_index, js)
    pt = _prims(jinter.clusters.prim_index, ts.numpy())
    assert hit_mismatches(_t(pt), tt, _t(pj), _t(jt)) == 0
    assert (pt[::11] == -1).all() and (pt >= 0).sum() > n // 4
    assert_uv_close(jinter.clusters.woop, ts.numpy(), d,
                    tt.numpy() - np.asarray(jt), pj == pt, (tu, tv), (ju, jv))


def test_origin_any_hit_matches_jax(setup):
    _, jinter, _, tinter, o, d = setup
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 2.2, np.float32)
    (_, js, _, _, jok), (_, ts, _, _, tok) = _query(
        jinter, tinter, o, d, tmin, tmax, mode="origin", point=o[0],
        any_hit=True, block_rays=128, granularity=2)
    assert bool(jok) and tok
    np.testing.assert_array_equal(ts.numpy() >= 0, np.asarray(js) >= 0)
    assert 0 < int((ts >= 0).sum()) < n


def test_target_mode_matches_jax(setup):
    jscene, jinter, tscene, tinter, o, d = setup
    so, wl, tmax = _shadow_wave(tinter, tscene, o, d)
    tmin = np.full(so.shape[0], 1e-4, np.float32)
    (jt, js, _, _, jok), (tt, ts, _, _, tok) = _query(
        jinter, tinter, so, wl, tmin, tmax, mode="target",
        point=np.asarray(LIGHT, np.float32), block_rays=128, granularity=4)
    assert bool(jok) and tok
    pj = _prims(jinter.clusters.prim_index, js)
    pt = _prims(jinter.clusters.prim_index, ts.numpy())
    assert hit_mismatches(_t(pt), tt, _t(pj), _t(jt)) == 0


def test_flipped_occlusion_wave_matches_jax(setup):
    """any_hit_from in target mode re-traces the shadow wave from the light
    (a common origin); only is_hit is meaningful."""
    jscene, jinter, tscene, tinter, o, d = setup
    so, wl, tmax = _shadow_wave(tinter, tscene, o, d)
    light = np.asarray(LIGHT, np.float32)
    ref = np.asarray(jinter.any_hit_from(
        jscene, jnp.asarray(so), jnp.asarray(wl), mode="target",
        point=jnp.asarray(light), t_max=jnp.asarray(tmax), block_rays=128))
    got = tinter.any_hit_from(tscene, _t(so), _t(wl), mode="target",
                              point=_t(light), t_max=_t(tmax),
                              block_rays=128)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < got.numel()
    # and the marcher agrees on the unflipped wave
    occ = tinter.any_hit(tscene, _t(so), _t(wl), t_max=_t(tmax))
    np.testing.assert_array_equal(got.numpy(), occ.numpy())


def test_pair_counts_match_jax(setup):
    _, jinter, _, tinter, o, d = setup
    n = o.shape[0]
    tmin, tmax = np.full(n, 1e-3, np.float32), np.full(n, 1e16, np.float32)
    for g in (1, 2, 4):
        ref = jraster.measure_pair_count(
            jinter.raster, jinter.clusters, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax), "origin", jnp.asarray(o[0]),
            block_rays=128, granularity=g)
        got = traster.measure_pair_count(
            tinter.raster, tinter.clusters, _t(o), _t(d), _t(tmin), _t(tmax),
            "origin", _t(o[0]), block_rays=128, granularity=g)
        assert got == ref


def test_overflow_falls_back_to_marcher(setup):
    """A tiny pc_max overflows (ok=False on both sides), and intersect_from
    then returns the marcher's result."""
    _, jinter, tscene, tinter, o, d = setup
    n = o.shape[0]
    tmin, tmax = np.full(n, 1e-3, np.float32), np.full(n, 1e16, np.float32)
    (*_, jok), (*_, tok) = _query(jinter, tinter, o, d, tmin, tmax,
                                  mode="origin", point=o[0], block_rays=128,
                                  pc_max=32)
    assert not bool(jok) and not tok
    h_f = tinter.intersect_from(tscene, _t(o), _t(d), mode="origin",
                                point=_t(o[0]), block_rays=128, pc_max=32)
    h_m = tinter.intersect(tscene, _t(o), _t(d))
    torch.testing.assert_close(h_f.prim_id, h_m.prim_id, rtol=0, atol=0)
    torch.testing.assert_close(h_f.t, h_m.t, rtol=0, atol=0)
    h_r = tinter.intersect_from(tscene, _t(o), _t(d), mode="origin",
                                point=_t(o[0]), block_rays=128)
    assert hit_mismatches(h_r.prim_id, h_r.t, h_m.prim_id, h_m.t) == 0
