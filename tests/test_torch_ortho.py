"""Ortho (common-direction) waves: ``raster_query(mode="ortho")`` and
kernels A's and D's ``common="dir"`` plain twins against the JAX queries
(Pallas interpret mode on the CPU) over the very same ClusterSet and TLAS
pairs, and against the marcher, mirroring tests/test_raster.py:106-122.

Hit rule (bench.py): prim ids equal, or |dt| <= 1e-5 |t| + 1e-6 at an
fp-equal t; occlusion waves compare ``is_hit`` exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import march as jmarch
from optix_ray_tracer_tpu.ops import raster as jraster
from optix_ray_tracer_tpu.ops import raster_instanced as jri
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import raster as traster
from optix_ray_tracer_tpu_torch.ops import raster_instanced as tri
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as ttr
from test_torch_instanced import _keys, _setup

torch.set_num_threads(2)

SUN = np.asarray([0.3, 0.2, 0.9], np.float32)
SUN /= np.linalg.norm(SUN)


def _t(x):
    return torch.as_tensor(np.array(x))


def _prims(prim_index, slot):
    slot = np.asarray(slot)
    return np.where(slot < 0, -1, np.asarray(prim_index)[np.maximum(slot, 0)])


@pytest.fixture(scope="module")
def flat():
    """The bench sphere of tests/test_raster.py and a sun wave from its
    camera wave's hit points (dead lanes where the camera ray missed)."""
    v, n = sphere_with_n_triangles(1000)
    jscene = JScene(spheres=JSpheres.empty(),
                    triangles=JTriangles.from_arrays(v, n))
    jinter = jmarch.make_march_intersector(jscene, raster=True)
    tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    tinter = convert.march_intersector(
        convert.state_arrays(jinter.clusters), tscene, raster=True,
        device="cpu")
    cam = JCamera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = (np.asarray(x).reshape(-1, 3) for x in cam.generate_rays(48, 48))
    h = tinter.intersect(tscene, _t(o), _t(d))
    p = torch.where(h.is_hit[:, None], _t(o) + h.t[:, None] * _t(d), _t(o))
    so = (p + _t(SUN) * 1e-3).numpy()
    sd = np.broadcast_to(SUN, so.shape).copy()
    tmax = np.where(h.is_hit.numpy(), 1e16, 0.0).astype(np.float32)
    return jscene, jinter, tscene, tinter, so, sd, tmax


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_ortho_matches_jax_and_marcher(flat, any_hit):
    """Kernel A's "dir" plain twin through raster_query(mode="ortho")
    against the JAX query (hit rule, or is_hit exactly) and the marcher."""
    jscene, jinter, tscene, tinter, so, sd, tmax = flat
    n = so.shape[0]
    tmin = np.full(n, 1e-4, np.float32)
    kw = dict(mode="ortho", any_hit=any_hit, block_rays=128)
    jt, js, _, _, jok = jraster.raster_query(
        jinter.raster, jinter.clusters, *(jnp.asarray(x) for x in
                                          (so, sd, tmin, tmax)), **kw)
    tt, ts, _, _, tok = traster.raster_query(
        tinter.raster, tinter.clusters, *(_t(x) for x in
                                          (so, sd, tmin, tmax)), **kw)
    assert bool(jok) and tok
    pj = _prims(tinter.clusters.prim_index, js)
    pt = _prims(tinter.clusters.prim_index, ts.numpy())
    ref = tinter.intersect(tscene, _t(so), _t(sd), t_min=_t(tmin),
                           t_max=_t(tmax))
    if any_hit:
        np.testing.assert_array_equal(pt >= 0, pj >= 0)
        np.testing.assert_array_equal(pt >= 0, ref.is_hit.numpy())
    else:
        assert hit_mismatches(_t(pt), tt, _t(pj), _t(jt)) == 0
        mp = torch.where(ref.is_hit, ref.prim_id, -1)
        assert hit_mismatches(_t(pt), tt, mp, ref.t) == 0
    assert 0 < (pt >= 0).sum() < (tmax > 0).sum()


def test_intersect_from_ortho(flat):
    """MarchIntersector.intersect_from / any_hit_from in ortho mode equal
    the marcher (and the JAX intersect_from) under the hit rule."""
    jscene, jinter, tscene, tinter, so, sd, tmax = flat
    got = tinter.intersect_from(tscene, _t(so), _t(sd), mode="ortho",
                                t_min=1e-4, t_max=_t(tmax), block_rays=128)
    ref = tinter.intersect(tscene, _t(so), _t(sd), t_min=1e-4,
                           t_max=_t(tmax))
    jh = jinter.intersect_from(jscene, jnp.asarray(so), jnp.asarray(sd),
                               mode="ortho", t_min=1e-4,
                               t_max=jnp.asarray(tmax), block_rays=128)

    def pid(h):
        return torch.where(h.is_hit, h.prim_id, -1)

    assert hit_mismatches(pid(got), got.t, pid(ref), ref.t) == 0
    jp = np.where(np.asarray(jh.t) < 1e15, np.asarray(jh.prim_id), -1)
    assert hit_mismatches(pid(got), got.t, _t(jp), _t(jh.t)) == 0
    occ = tinter.any_hit_from(tscene, _t(so), _t(sd), mode="ortho",
                              t_min=1e-4, t_max=_t(tmax), block_rays=128)
    assert torch.equal(occ, ref.is_hit)


def _dir_schedule(tinter, so, sd, tmax, W=128):
    n = so.shape[0]
    nb = -(-n // W)
    S = traster._coarse_stage(tinter.raster, tinter.clusters, _t(so), _t(sd),
                              torch.full((n,), 1e-4), _t(tmax), "ortho",
                              None, W, traster.default_pc_max(nb, 4, 2), 2)
    return traster.schedule_inputs(tinter.clusters, S, nb, 2), n


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_dir_twin_against_full_width(flat, any_hit):
    """The "dir" plain twin against the same schedule with full-width dots
    (common=None, the bundle walk): the same hits under the hit rule (only
    exact fp ties may flip); and the same Woop-tested rows per warp as the
    full-width dots in the warp walk of the "dir" variant (the gate does
    not change)."""
    _, _, _, tinter, so, sd, tmax = flat
    inp, n = _dir_schedule(tinter, so, sd, tmax)
    a = ttr.raster_cluster_call(**inp, w=128, any_hit=any_hit, common="dir",
                                visits=True)
    b = ttr.raster_cluster_call(**inp, w=128, any_hit=any_hit, common=None,
                                visits=True)
    pi = tinter.clusters.prim_index
    pa = _t(_prims(pi, a[1].reshape(-1)[:n].numpy()))
    pb = _t(_prims(pi, b[1].reshape(-1)[:n].numpy()))
    if any_hit:
        assert torch.equal(pa >= 0, pb >= 0)
    else:
        assert hit_mismatches(pa, a[0].reshape(-1)[:n], pb,
                              b[0].reshape(-1)[:n]) == 0
    walk = ttr._raster_plain(inp, 128, any_hit, None)
    assert torch.equal(a[4], walk[4]) and int(a[4].sum()) > 0


def test_common_code_refuses_unknown():
    assert [ttr.common_code(c) for c in ttr.COMMONS] == [0, 1, 2]
    with pytest.raises(ValueError):
        ttr.common_code("target")


@pytest.fixture(scope="module")
def tlas():
    """A TLAS of 10 instances (unit spheres spread over [-6, 6]^3) and an
    ortho wave: a 32 x 32 grid of parallel rays over 16 x 16 units of a
    plane 15 units out, every 13th ray dead."""
    s = _setup(10, 1.0, 11)
    d = -np.asarray([9.0, 0.5, 1.0], np.float32)
    d /= np.linalg.norm(d)
    u = np.cross(d, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(u, d)
    g = (np.arange(32) + 0.5) / 32 * 16.0 - 8.0
    gy, gx = np.meshgrid(g, g, indexing="ij")
    so = (-15.0 * d + gx.reshape(-1, 1) * u + gy.reshape(-1, 1) * v
          ).astype(np.float32)
    sd = np.broadcast_to(d, so.shape).astype(np.float32).copy()
    tmax = np.full(so.shape[0], 1e16, np.float32)
    tmax[::13] = 0.0
    return s, so, sd, tmax


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_instanced_ortho_matches_jax_and_marcher(tlas, any_hit):
    """Kernel D's "dir" plain twin through instanced_raster_query against
    the JAX query and the instanced marcher."""
    s, so, sd, tmax = tlas
    n = so.shape[0]
    tmin = np.full(n, 1e-4, np.float32)
    kw = dict(mode="ortho", any_hit=any_hit, block_rays=256)
    jt, js, _, _, jok = jri.instanced_raster_query(
        s["jinter"], *(jnp.asarray(x) for x in (so, sd, tmin, tmax)), **kw)
    tt, ts, _, _, tok = tri.instanced_raster_query(
        s["tinter"], *(_t(x) for x in (so, sd, tmin, tmax)), **kw)
    assert bool(jok) and tok
    kj, kt = _keys(s["jinter"], js), _keys(s["jinter"], ts.numpy())
    ref, _ = s["tinter"].intersect(_t(so), _t(sd), _t(tmin), _t(tmax),
                                   any_hit)
    if any_hit:
        np.testing.assert_array_equal(kt >= 0, kj >= 0)
        np.testing.assert_array_equal(kt >= 0, ref.is_hit.numpy())
    else:
        assert hit_mismatches(_t(kt), tt, _t(kj), _t(jt)) == 0
        got, _ = s["tinter"].intersect_from(
            _t(so), _t(sd), mode="ortho", t_min=_t(tmin), t_max=_t(tmax),
            block_rays=256)
        assert hit_mismatches(torch.where(got.is_hit, got.prim_id, -1),
                              got.t, torch.where(ref.is_hit, ref.prim_id,
                                                 -1), ref.t) == 0
    assert 0 < (kt >= 0).sum() < (tmax > 0).sum()


def test_instanced_dir_twin_against_full_width(tlas):
    """D's "dir" twin against full-width dots on the same schedule: the
    hit rule on the slots' t, equal Woop-tested rows per warp."""
    s, so, sd, tmax = tlas
    n = so.shape[0]
    S = tri.instanced_coarse_stage(
        s["tinter"].pair_min, s["tinter"].pair_max, _t(so), _t(sd),
        torch.full((n,), 1e-4), _t(tmax), "ortho", None, 256, 8192,
        s["tinter"].pair_shape, s["tinter"].pair_inst)
    inp = tri.instanced_schedule_inputs(s["tinter"], S)
    a = ttr.raster_instanced_call(**inp, w=256, common="dir", visits=True)
    b = ttr.raster_instanced_call(**inp, w=256, common=None, visits=True)
    ka = _keys(s["jinter"], a[1].reshape(-1)[:n].numpy())
    kb = _keys(s["jinter"], b[1].reshape(-1)[:n].numpy())
    assert hit_mismatches(_t(ka), a[0].reshape(-1)[:n], _t(kb),
                          b[0].reshape(-1)[:n]) == 0
    assert torch.equal(a[4], b[4]) and int(a[4].sum()) > 0
