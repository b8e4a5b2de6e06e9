"""The cluster-sweep intersector of the port (``ops/sweep.py``) and the
plain version of kernel G (``ops/kernels/leaf_sweep.window_sweep_plain``)
against the JAX package on the CPU: the leaf sweep against both
``_window_sweep_xla`` and ``window_sweep_pallas`` (Pallas interpret mode),
the dense per-pass reductions bit for bit, ``SweepIntersector`` against
the JAX one and the brute-force oracle (coherent and incoherent rays, with
a sphere), the port's two loops against each other, and a 24x16 Whitted
frame rendered through the sweep against the JAX frame
(tests/test_sweep.py's scene).

Tolerances.  Hit rule (bench.py): prim ids equal, or |dt| <= 1e-5 |t| +
1e-6.  The leaf sweep sums each Woop row left to right; XLA's einsum and
the interpret-mode matmuls sum in another order, so the leaf sweep's t is
held to 2e-6 |t| and its u/v to 3e-6 plus |dt| |r.d| (the shift that dt
makes in (r.o - c) + t (r.d)), each about 3x the measured worst case
given in the test."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import sweep as jsweep
from optix_ray_tracer_tpu.ops.pallas.leaf_sweep import window_sweep_pallas
from optix_ray_tracer_tpu.render import wavefront as jwave
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import (
    Scene as JScene, Spheres as JSpheres, Triangles as JTriangles,
)
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import sweep as tsweep
from optix_ray_tracer_tpu_torch.ops.intersect import (
    hit_mismatches, intersect_scene_bruteforce,
)
from optix_ray_tracer_tpu_torch.ops.kernels.leaf_sweep import (
    window_sweep_plain,
)
from optix_ray_tracer_tpu_torch.render import wavefront as twave

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _scene(n_tri, sphere=False):
    v, n = sphere_with_n_triangles(n_tri)
    sph = (JSpheres.from_list([((0.0, 1.2, 0.0), 0.4, 0)]) if sphere
           else JSpheres.empty())
    return JScene(spheres=sph, triangles=JTriangles.from_arrays(v, n))


def _camera_rays(w=32, h=24):
    cam = JCamera.look_at((3.0, 0.0, 0.3), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = cam.generate_rays(w, h)
    return np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def _random_rays(n, seed, spread=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def clusters():
    jc = jsweep.build_clusters(np.asarray(_scene(700).triangles.vertices))
    return jc, convert.clusters(convert.state_arrays(jc), device="cpu")


def _window_inputs(n_rows):
    """4 blocks of 128 rays (camera rays, then random ones) over windows
    of a 3-cluster table, incoming best t INF or finite."""
    oc, dc = _camera_rays(16, 16)
    oi, di = _random_rays(256, 5, 1.2)
    o = np.concatenate([oc, oi]).reshape(4, 128, 3)
    d = np.concatenate([dc, di]).reshape(4, 128, 3)
    rng = np.random.default_rng(3)
    starts = np.asarray([0, 256, n_rows - 256, 256], np.int32)
    t_min = np.full((4, 128), 1e-3, np.float32)
    bt = np.where(rng.uniform(size=(4, 128)) < 0.5, 1e16,
                  rng.uniform(0.5, 4.0, (4, 128))).astype(np.float32)
    best = (bt, np.full((4, 128), -1, np.int32),
            np.zeros((4, 128), np.float32), np.zeros((4, 128), np.float32))
    return starts, o, d, t_min, best


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_window_sweep_plain_matches_jax(clusters, ref):
    """Slots equal; t to 2e-6 |t|, u/v to 3e-6 + |dt| |r.d| (measured
    against both: 12 of 52 hit t differ, by 6.4e-7 |t| at most; |du|,
    |dv| <= 9.5e-7)."""
    jc, tc = clusters
    starts, o, d, t_min, best = _window_inputs(jc.woop.shape[0])
    fn = jsweep._window_sweep_xla if ref == "xla" else window_sweep_pallas
    want = [np.asarray(x) for x in fn(
        jc.woop, jnp.asarray(starts), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_min), tuple(jnp.asarray(b) for b in best))]
    got = [x.numpy() for x in window_sweep_plain(
        tc.woop, _t(starts), _t(o), _t(d), _t(t_min),
        tuple(_t(b) for b in best))]
    assert got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])
    hit = want[1] >= 0
    assert 40 < hit.sum() < hit.size
    dt = np.abs(got[0] - want[0])
    assert (dt <= 2e-6 * np.abs(want[0])).all()
    woop = np.asarray(jc.woop)
    rows = woop[np.maximum(want[1], 0)]
    rd = np.abs(np.einsum("...ij,...j->...i",
                          rows[..., :9].reshape(*rows.shape[:-1], 3, 3), d))
    for k in (2, 3):
        tol = 3e-6 + dt * rd[..., k - 2]
        assert (np.abs(got[k] - want[k]) <= tol).all()


def _pass_state(R, seed):
    """A mid-query frontier: half the rays fresh, half past some key."""
    rng = np.random.default_rng(seed)
    fresh = rng.uniform(size=R) < 0.5
    last_entry = np.where(fresh, -1e16, rng.uniform(0.5, 3.0, R)
                          ).astype(np.float32)
    last_cid = np.where(fresh, -1, rng.integers(0, 3, R)).astype(np.int32)
    best_t = np.where(rng.uniform(size=R) < 0.5, 1e16,
                      rng.uniform(1.0, 5.0, R)).astype(np.float32)
    return last_entry, last_cid, best_t


def test_candidate_and_frontier_match_jax(clusters):
    """_candidate_clusters and _frontier_after_sweep: ids and entries equal
    bit for bit, over the clusters plus two all-NaN padding boxes, which
    never fire (the same elementwise float operations on both sides)."""
    jc, tc = clusters
    nan = np.full((2, 3), np.nan, np.float32)
    jc = dataclasses.replace(
        jc, cluster_min=jnp.concatenate([jc.cluster_min, nan]),
        cluster_max=jnp.concatenate([jc.cluster_max, nan]))
    tc = dataclasses.replace(
        tc, cluster_min=torch.cat([tc.cluster_min, _t(nan)]),
        cluster_max=torch.cat([tc.cluster_max, _t(nan)]))
    oc, dc = _camera_rays(16, 16)
    oi, di = _random_rays(256, 8)
    o, d = np.concatenate([oc, oi]), np.concatenate([dc, di])
    R = o.shape[0]
    inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12).astype(np.float32)
    t_min = np.full(R, 1e-3, np.float32)
    le, lc, bt = _pass_state(R, 4)
    j = jsweep._candidate_clusters(jc, o, inv, t_min, bt, le, lc)
    t = tsweep._candidate_clusters(tc, _t(o), _t(inv), _t(t_min), _t(bt),
                                   _t(le), _t(lc).long())
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    active = np.asarray(j[2])
    assert 0 < active.sum() < R
    assert (np.asarray(j[0])[active] < 3).all()     # no NaN box picked
    win_lo = np.where(active, np.asarray(j[0]), 0).astype(np.int32)
    jf = jsweep._frontier_after_sweep(jc, o, inv, t_min, bt, le, lc, win_lo,
                                      win_lo + 1)
    tf = tsweep._frontier_after_sweep(tc, _t(o), _t(inv), _t(t_min), _t(bt),
                                      _t(le), _t(lc).long(),
                                      _t(win_lo).long(), _t(win_lo + 1).long())
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def sweep_scene():
    js = _scene(2000, sphere=True)
    jsi = jsweep.make_sweep_intersector(js)
    ts = convert.scene(convert.state_arrays(js), device="cpu")
    tsi = convert.sweep_intersector(convert.state_arrays(jsi), device="cpu")
    return js, jsi, ts, tsi


@pytest.mark.parametrize("wave", ["coherent", "incoherent"])
def test_intersector_matches_jax_and_oracle(sweep_scene, wave):
    """Prim ids and types of the port's SweepIntersector equal the JAX
    SweepIntersector's and the brute-force oracle's (the hit rule's tie
    allowance; measured 0 exceptions), spheres merged; no ray left active
    at the pass cap."""
    js, jsi, ts, tsi = sweep_scene
    o, d = _camera_rays() if wave == "coherent" else _random_rays(700, 3)
    log = []
    tsi = dataclasses.replace(tsi, log=log)
    got = tsi.intersect(ts, _t(o), _t(d))
    want = jsi.intersect(js, jnp.asarray(o), jnp.asarray(d))
    oracle = intersect_scene_bruteforce(ts, _t(o), _t(d))
    assert not log[0].unfinished and log[0].passes >= 1
    np.testing.assert_array_equal(got.prim_type.numpy(),
                                  np.asarray(want.prim_type))
    for ref in (want, oracle):
        ids = _t(np.asarray(ref.prim_id)) + 100000 * _t(
            np.asarray(ref.prim_type))
        assert hit_mismatches(got.prim_id + 100000 * got.prim_type, got.t,
                              ids, _t(np.asarray(ref.t))) == 0
    assert got.is_hit.any() and (~got.is_hit).any()
    assert (got.prim_type == 1).any()                # the sphere merged
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=2e-6,
                               atol=0)


def test_loops_agree(sweep_scene):
    """The lockstep loop (every ray each pass) and the compacting loop
    give the same (t, slot, u, v) bit for bit, and both finish."""
    _, _, _, tsi = sweep_scene
    o, d = _random_rays(640, 12)
    args = (tsi.clusters, _t(o), _t(d), torch.full((640,), 1e-3),
            torch.full((640,), 1e16))
    lock = tsweep.sweep_intersect(*args)
    host = tsweep.sweep_intersect_host(*args)
    for a, b in zip(lock[:4], host[:4]):
        assert torch.equal(a, b)
    assert not lock[4].unfinished and not host[4].unfinished
    assert lock[4].passes == host[4].passes
    assert host[4].live[-1] < host[4].live[0]        # it compacted


def test_render_matches_jax():
    """A 24x16 Whitted frame (spp 1, no jitter) through the sweep equals
    the JAX frame through the JAX sweep (its in-jit 64-pass loop) bit for
    bit."""
    mb = MaterialBuilder()
    mb.add_rough((0.6, 0.4, 0.3))
    mats = mb.build()
    js = _scene(3000)
    cam = JCamera.look_at((3, 0, 0.3), (0, 0, 0), (0, 0, 1))
    jsi = jsweep.make_sweep_intersector(js)
    want, _, _ = jwave.render(js, mats, cam, 24, 16, spp=1, seed=5,
                              intersector=jsi, jitter=False)
    tsi = convert.sweep_intersector(convert.state_arrays(jsi), device="cpu")
    got, _, _ = twave.render(
        convert.scene(convert.state_arrays(js), device="cpu"),
        convert.materials(convert.state_arrays(mats), device="cpu"),
        convert.camera(convert.state_arrays(cam), device="cpu"), 24, 16,
        spp=1, seed=5, intersector=tsi, jitter=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_sweep_intersector_matches_convert(sweep_scene):
    """make_sweep_intersector builds on the scene's device the very
    ClusterSet the JAX package builds."""
    _, jsi, ts, _ = sweep_scene
    si = tsweep.make_sweep_intersector(ts)
    ref = convert.state_arrays(jsi.clusters)
    for k in convert.CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(si.clusters, k).numpy(),
                                      ref[k])
