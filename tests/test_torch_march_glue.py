"""Kernels O, P, Q and R (the marcher's wave glue and the hit shading
frame): their plain twins against the JAX package on the same inputs,
and ``MarchIntersector.intersect`` / ``any_hit`` and ``shading_frame``
as a whole against the JAX functions (Pallas in interpret mode).

The scene is tests/test_torch_wavefront.py's: a ~2500-triangle sphere
and a ground quad in the cluster set (more than SORT_FREE_TRIS, so waves
are sorted) plus one analytic sphere; sort-free waves use a 500-triangle
sphere.  Inputs come from numpy seeds.

Tolerances: keys and permutations bit-equal (the twin's int32 key is the
JAX uint32 key less 2^31); the sorted ray rows equal, NaN equal to NaN;
hits under the hit rule (prim ids equal, or |dt| <= 1e-5 |t| + 1e-6) with
no exceptions, occlusion equal, and u, v within 1e-5 + |dt| |r . d| where
the prims agree (ROADMAP's RNG contract; r the winner's Woop row).  The
shading frame: point and normal within 2e-6 relative (XLA's CPU code may
fuse o + t d and the normal's sums into multiply-adds, one rounding
fewer), front flags equal wherever |d . n| > 1e-5 |d| |n|, material ids
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import intersect as jisect
from optix_ray_tracer_tpu.ops import march as jmarch
from optix_ray_tracer_tpu.ops import raysort as jraysort
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import intersect as tisect
from optix_ray_tracer_tpu_torch.ops.intersect import Hit, hit_mismatches
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as tbm
from optix_ray_tracer_tpu_torch.ops.kernels import march_glue
from optix_ray_tracer_tpu_torch.ops.march import SORT_FREE_TRIS

torch.set_num_threads(2)

UV_ATOL = 1e-5
N_RAYS = 1000          # not a whole number of 128-ray blocks
BIG = 1 << 24          # prim key: type * BIG + id


def _t(x):
    return torch.as_tensor(np.array(x))


def _scene(n_tris: int):
    v, n = sphere_with_n_triangles(n_tris)
    qv, qn = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
    tris = JTriangles.from_arrays(v, n, 0).concat(
        JTriangles.from_arrays(qv, qn, 1))
    jscene = JScene(spheres=JSpheres.from_list([((0.2, 1.5, -0.6), 0.4, 2)]),
                    triangles=tris)
    jinter = jmarch.make_march_intersector(jscene)
    tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    tinter = convert.march_intersector(convert.state_arrays(jinter.clusters),
                                       tscene, raster=False, device="cpu")
    return jscene, jinter, tscene, tinter


@pytest.fixture(scope="module")
def setup():
    big = _scene(2500)
    small = _scene(500)
    assert big[1].num_tris > SORT_FREE_TRIS >= small[1].num_tris
    r = np.random.default_rng(11)
    oi = r.uniform(-1.6, 1.6, (N_RAYS, 3)).astype(np.float32)
    di = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    cam = JCamera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    oc, dc = cam.generate_rays(40, 25)
    waves = {"incoherent": (oi, di),
             "camera": (np.asarray(oc).reshape(-1, 3),
                        np.asarray(dc).reshape(-1, 3))}
    return big, small, waves


def _bounds(n: int, any_hit: bool, seed: int, segment: float = 0.9):
    """t_min 1e-3, t_max 1e16 (``segment`` for occlusion waves, so both
    outcomes occur); every 7th ray dead (t_max 0)."""
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, segment if any_hit else 1e16, np.float32)
    tmax[seed % 7::7] = 0.0
    return tmin, tmax


def _edge_wave(seed: int):
    """Incoherent rays plus the Morton edge values: origins on the scene
    box's high corner (q * 1024 = 1024, clamped to cell 1023) and outside
    the box, directions with zero components (mid-grid cells)."""
    r = np.random.default_rng(seed)
    o = r.uniform(-5.0, 5.0, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:16] = (4.0, 4.0, 1.0)
    o[16:32] = (9.0, -9.0, 30.0)
    d[32:48, 0] = 0.0
    d[48:64] = (0.0, 0.0, 1.0)
    d[64:80] = (0.0, -1.0, 0.0)
    return o, d


def test_morton_keys_match_jax(setup):
    """O's twin in Morton mode: the keys as uint32 equal JAX's
    ``ray_sort_keys``, bit 31 set on some and clear on others, and the
    stable argsort of the int32 keys equals ``jnp.argsort`` of JAX's."""
    (jscene, jinter, tscene, tinter), _, _ = setup
    o, d = _edge_wave(5)
    ref = np.asarray(jraysort.ray_sort_keys(jnp.asarray(o), jnp.asarray(d),
                                            jinter.scene_lo,
                                            jinter.scene_hi))
    got = march_glue.march_keys(_t(d), _t(o), tinter.scene_lo,
                                tinter.scene_hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32) ^ 0x80000000,
                                  ref.astype(np.uint32))
    assert 0 < int((ref >= 1 << 31).sum()) < N_RAYS
    np.testing.assert_array_equal(torch.argsort(got, stable=True).numpy(),
                                  np.asarray(jnp.argsort(ref)))


def test_probe_keys_match_jax(setup):
    """O's twin in probe mode on the port's C answer: the keys as uint32
    equal JAX's ``ray_probe_keys``, and the permutations are equal."""
    (_, jinter, _, tinter), _, waves = setup
    o, d = waves["incoherent"]
    tmin, tmax = _bounds(N_RAYS, False, 3)
    ref = np.asarray(jmarch.ray_probe_keys(
        jinter.clusters, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax)))
    cid = tbm.probe_first_cluster(tinter.clusters, _t(o), _t(d), _t(tmin),
                                  _t(tmax))
    got = march_glue.march_keys(_t(d), cid=cid)
    np.testing.assert_array_equal(got.numpy().view(np.uint32) ^ 0x80000000,
                                  ref.astype(np.uint32))
    np.testing.assert_array_equal(torch.argsort(got, stable=True).numpy(),
                                  np.asarray(jnp.argsort(ref)))


@pytest.mark.parametrize("w", [1, 128, 512])
def test_gather_rays_matches_jax(setup, w):
    """P's twin against the JAX package's sort, (R, 8) gather, dead-ray
    padding and t_max clamp (``ops/march.py:337-352``,
    ``ops/pallas/block_march.py:855-868``), with NaN t_min and +-inf
    t_max among the rays: the rows equal, NaN equal to NaN; t_min's bits
    and -inf carried unchanged, +inf clamped to INF."""
    o, d = _edge_wave(9)
    tmin, tmax = _bounds(N_RAYS, False, 2)
    tmin[100:110] = np.nan
    tmax[110:120] = np.inf
    tmax[120:130] = -np.inf
    tmax[130:135] = np.nan
    perm = np.random.default_rng(4).permutation(N_RAYS)
    packed = jnp.concatenate([jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tmin)[:, None],
                              jnp.asarray(tmax)[:, None]], 1)[perm]
    pad = (-N_RAYS) % w
    jo = jnp.pad(packed[:, 0:3], ((0, pad), (0, 0)))
    jd = jnp.pad(packed[:, 3:6], ((0, pad), (0, 0))).at[N_RAYS:, 2].set(1.0)
    jtmin = jnp.pad(packed[:, 6], (0, pad), constant_values=1.0)
    jtmax = jnp.minimum(jnp.pad(packed[:, 7], (0, pad), constant_values=0.0),
                        1e16)
    ref = np.asarray(jnp.concatenate([jo.T, jd.T, jtmin[None], jtmax[None]]))
    got, inv = march_glue.gather_rays(_t(o), _t(d), _t(tmin), _t(tmax),
                                      _t(perm), w)
    got = got.numpy()
    assert got.shape == (8, N_RAYS + pad)
    np.testing.assert_array_equal(got, ref)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy()[perm], np.arange(N_RAYS))
    np.testing.assert_array_equal(got[6, :N_RAYS].view(np.int32),
                                  tmin[perm].view(np.int32))
    want = np.where(tmax[perm] == np.inf, np.float32(1e16), tmax[perm])
    np.testing.assert_array_equal(got[7, :N_RAYS].view(np.int32),
                                  want.view(np.int32))


def test_gather_rays_scalar_bounds(setup):
    """P's twin on bounds broadcast from one value (``ray_bound``'s
    expand) equals the same bounds given per ray."""
    o, d = _edge_wave(2)
    tmin = torch.tensor(1e-3).expand(N_RAYS)
    tmax = torch.tensor(float("inf")).expand(N_RAYS)
    got, inv = march_glue.gather_rays(_t(o), _t(d), tmin, tmax, None, 256)
    want, _ = march_glue.gather_rays(_t(o), _t(d), tmin.contiguous(),
                                     tmax.contiguous(), None, 256)
    assert torch.equal(got, want) and inv is None


def _finish_numpy(t, slot, prim_index, o, d, woop, inv, any_hit, u=None,
                  v=None):
    """Q's function written out in numpy float32, in block_march._finish's
    order of operations, ray i at sorted position inv[i]."""
    n = o.shape[0]
    j = np.arange(n) if inv is None else inv
    t, slot = t[j], slot[j]
    miss = slot < 0
    s = np.maximum(slot, 0)
    if u is None:
        u = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
        if not any_hit:
            w = woop[s]
            ts = np.where(miss, np.float32(0), t)
            for out, a, off in ((u, 0, 9), (v, 3, 10)):
                do = (w[:, a] * o[:, 0] + w[:, a + 1] * o[:, 1]) \
                    + w[:, a + 2] * o[:, 2]
                dd = (w[:, a] * d[:, 0] + w[:, a + 1] * d[:, 1]) \
                    + w[:, a + 2] * d[:, 2]
                out[:] = (do - w[:, off]) + ts * dd
    else:
        u, v = u[j], v[j]
    return (np.where(miss, np.float32(1e16), t),
            np.where(miss, 0, 2).astype(np.int32),
            np.where(miss, 0, prim_index[s]).astype(np.int32),
            np.where(miss, np.float32(0), u),
            np.where(miss, np.float32(0), v))


@pytest.mark.parametrize("mode", ["recompute", "any_hit", "given"])
@pytest.mark.parametrize("sorted_", [False, True], ids=["unsorted",
                                                        "sorted"])
def test_finish_hits_matches_numpy(setup, mode, sorted_):
    """Q's twin on a march's (t, slot) over a padded wave, with misses and
    the inverse of a permutation: every field equal to the numpy
    reference, bit for bit."""
    (_, _, _, tinter), _, _ = setup
    cs = tinter.clusters
    r = np.random.default_rng(17)
    n, n_pad = N_RAYS, 1024
    rows = cs.woop.shape[0]
    slot = r.integers(0, rows, n_pad).astype(np.int32)
    slot[r.random(n_pad) < 0.3] = -1
    t = r.uniform(0.1, 5.0, n_pad).astype(np.float32)
    if mode == "any_hit":
        t[slot >= 0] = -1e16
    o = r.normal(size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    inv = r.permutation(n).astype(np.int32) if sorted_ else None
    u = v = None
    if mode == "given":      # beside t and slot: the padded length
        u = r.random(n_pad).astype(np.float32)
        v = r.random(n_pad).astype(np.float32)
    got = march_glue.finish_hits(
        _t(t), _t(slot), cs.prim_index, n, _t(o), _t(d), cs.woop,
        u=None if u is None else _t(u), v=None if v is None else _t(v),
        inv=None if inv is None else _t(inv), any_hit=mode == "any_hit")
    want = _finish_numpy(t[:n], slot[:n], cs.prim_index.numpy(), o, d,
                         cs.woop.numpy(), inv, mode == "any_hit", u, v)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert got[1].dtype == got[2].dtype == torch.int32


def test_finish_hits_unsorts_as_before(setup):
    """Q's twin through P's inverse equals the march's finish in sorted
    order (``block_march._finish`` on the sorted rays) scattered back
    through the permutation, as the port unsorted before: bit for bit."""
    (_, _, _, tinter), _, waves = setup
    inter = tinter.for_incoherent()
    o, d = (_t(x) for x in waves["incoherent"])
    n = o.shape[0]
    tmin, tmax = (_t(x) for x in _bounds(n, False, 4))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    rays, inv = march_glue.gather_rays(o, d, tmin, tmax, perm, 128)
    tables = tbm.march_tables(inter.clusters, coherent=False)
    t, slot, _ = tbm.march_call(rays=rays, **tables)
    got = march_glue.finish_hits(t, slot, inter.clusters.prim_index, n, o,
                                 d, inter.clusters.woop, inv=inv)
    ts, ss, us, vs = tbm._finish(t[:n], slot[:n], False, lambda: (
        inter.clusters.woop[slot[:n].clamp(min=0).long()], rays[0:3, :n].T,
        rays[3:6, :n].T))
    back = [torch.empty_like(x) for x in (ts, us, vs)]
    for b, x in zip(back, (ts, us, vs)):
        b[perm] = x
    assert torch.equal(got[0], back[0])
    assert torch.equal(got[3].view(torch.int32), back[1].view(torch.int32))
    assert torch.equal(got[4].view(torch.int32), back[2].view(torch.int32))
    assert int((got[1] == 2).sum()) > n // 4


def _prim_keys(hit):
    ptype, pid = (np.asarray(hit.prim_type), np.asarray(hit.prim_id))
    return np.where(ptype == 0, -1, ptype.astype(np.int64) * BIG + pid)


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest",
                                                        "any_hit"])
@pytest.mark.parametrize("route", ["morton", "probe", "sort_free"])
def test_intersect_matches_jax(setup, route, any_hit):
    """``MarchIntersector.intersect`` (``any_hit``) through O, P, the
    march and Q (their twins on the CPU) against the JAX intersector on
    the same ClusterSet: Morton-sorted camera waves, probe-sorted
    incoherent waves, sort-free waves of the small scene; 1000 rays with
    dead lanes."""
    big, small, waves = setup
    jscene, jinter, tscene, tinter = small if route == "sort_free" else big
    o, d = waves["camera" if route == "morton" else "incoherent"]
    if route == "probe":
        jinter, tinter = jinter.for_incoherent(), tinter.for_incoherent()
    n = o.shape[0]
    tmin, tmax = _bounds(n, any_hit, 1, 2.6 if route == "morton" else 0.9)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
            jnp.asarray(tmax))
    targs = (_t(o), _t(d), _t(tmin), _t(tmax))
    if any_hit:
        ref = np.asarray(jinter.any_hit(jscene, *args))
        got = tinter.any_hit(tscene, *targs).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.sum() < n
        assert not got[1::7].any()
        return
    ref = jinter.intersect(jscene, *args)
    got = tinter.intersect(tscene, *targs)
    pj, pt = _prim_keys(ref), _prim_keys(got)
    assert hit_mismatches(_t(pt), got.t, _t(pj), _t(np.asarray(ref.t))) == 0
    assert (pt >= 0).sum() > n // 4 and (pt[1::7] < 0).all()
    same = (pj == pt) & (np.asarray(got.prim_type) == 2)
    # the winners' Woop rows, by triangle id
    cs = tinter.clusters
    slot_of = np.empty(cs.prim_index.shape[0], np.int64)
    slot_of[cs.prim_index.numpy()] = np.arange(cs.prim_index.shape[0])
    rows = cs.woop.numpy()[slot_of[np.asarray(got.prim_id)]]
    dt = got.t.numpy() - np.asarray(ref.t)
    for r_, g, w_ in ((rows[:, 0:3], got.u, ref.u), (rows[:, 3:6], got.v,
                                                     ref.v)):
        slack = UV_ATOL + np.abs(dt) * np.abs((r_ * d).sum(-1))
        err = np.abs(g.numpy() - np.asarray(w_))
        assert (err <= slack)[same].all(), (err - slack)[same].max()
    miss = pt < 0
    assert (got.t.numpy()[miss] == 1e16).all()
    assert (got.u.numpy()[miss] == 0).all() and (got.v.numpy()[miss]
                                                 == 0).all()


def _hits(n: int, n_spheres: int, n_tris: int, seed: int):
    """numpy Hit fields over misses, sphere and triangle hits, ids beyond
    each table's end among them (both sides clamp them)."""
    r = np.random.default_rng(seed)
    ptype = r.integers(0, 3, n).astype(np.int32)
    pid = r.integers(0, max(n_spheres, n_tris) + 3, n).astype(np.int32)
    t = np.where(ptype == 0, np.float32(1e16),
                 r.uniform(0.1, 5.0, n)).astype(np.float32)
    u = r.random(n).astype(np.float32)
    v = (r.random(n) * (1 - u)).astype(np.float32)
    u[ptype != 2] = 0.0
    v[ptype != 2] = 0.0
    return t, ptype, pid, u, v


@pytest.mark.parametrize("spheres", [True, False], ids=["spheres",
                                                        "no_spheres"])
def test_shading_frame_matches_jax(setup, spheres):
    """``shading_frame`` (R's twin on the CPU) against the JAX function on
    triangle hits, sphere hits and misses of the same rays; the scene
    with its analytic sphere and without."""
    (jscene, _, tscene, _), _, waves = setup
    if not spheres:
        jscene = JScene(spheres=JSpheres.empty(), triangles=jscene.triangles)
        tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    o, d = waves["incoherent"]
    n = o.shape[0]
    fields = _hits(n, jscene.sphere_count, jscene.triangle_count, 8)
    jhit = jisect.Hit(*(jnp.asarray(x) for x in fields))
    thit = Hit(*(_t(x) for x in fields))
    ref = [np.asarray(x) for x in jisect.shading_frame(
        jscene, jnp.asarray(o), jnp.asarray(d), jhit)]
    got = [x.numpy() for x in tisect.shading_frame(tscene, _t(o), _t(d),
                                                   thit)]
    for k in (0, 1):
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-6, atol=1e-7)
    dn = np.abs((d * got[1]).sum(-1))
    clear = dn > 1e-5 * np.linalg.norm(got[1], axis=-1)
    np.testing.assert_array_equal(got[2][clear], ref[2][clear])
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[2].dtype == bool and got[3].dtype == np.int32


def test_shading_frame_plain_is_the_cpu_route(setup):
    """On CPU tensors ``shading_frame`` is its twin, bit for bit."""
    (_, _, tscene, _), _, waves = setup
    o, d = (_t(x) for x in waves["camera"])
    hit = Hit(*(_t(x) for x in _hits(o.shape[0], 1, tscene.triangle_count,
                                      4)))
    for a, b in zip(tisect.shading_frame(tscene, o, d, hit),
                    tisect.shading_frame_plain(tscene, o, d, hit)):
        assert torch.equal(a, b)


def test_cpu_dispatch_takes_the_twins(setup, monkeypatch):
    """On CPU tensors intersect, any_hit and shading_frame call the twins
    of O, P, Q and R (P twice on probe waves) and launch no kernel."""
    (jscene, _, tscene, tinter), _, waves = setup
    calls = []
    for module, name in ((march_glue, "march_keys_plain"),
                         (march_glue, "gather_rays_plain"),
                         (march_glue, "finish_hits_plain"),
                         (tisect, "shading_frame_plain")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    before = [k.launches for k in _lib.KERNELS]
    o, d = (_t(x) for x in waves["incoherent"])
    hit = tinter.for_incoherent().intersect(tscene, o, d)
    tinter.any_hit(tscene, o, d, 1e-3, 0.5)
    tisect.shading_frame(tscene, o, d, hit)
    assert calls == ["gather_rays_plain", "march_keys_plain",
                     "gather_rays_plain", "finish_hits_plain",
                     "march_keys_plain", "gather_rays_plain",
                     "finish_hits_plain", "shading_frame_plain"]
    assert [k.launches for k in _lib.KERNELS] == before


def test_call_wrappers_refuse_cpu_tensors(setup):
    """The wrappers of O, P, Q and R never run a plain version: CPU tensors
    raise before any build or launch."""
    (_, _, tscene, tinter), _, waves = setup
    o, d = (_t(x) for x in waves["incoherent"])
    n = o.shape[0]
    f, i = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
    calls = (
        lambda: march_glue.march_keys_call(d, o, tinter.scene_lo,
                                           tinter.scene_hi),
        lambda: march_glue.gather_rays_call(o, d, f, f),
        lambda: march_glue.finish_hits_call(f, i, tinter.clusters.prim_index,
                                            n, o, d, tinter.clusters.woop),
        lambda: march_glue.shading_frame_call(tscene, o, d,
                                              Hit(f, i, i, f, f)))
    before = [k.launches for k in _lib.KERNELS]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [k.launches for k in _lib.KERNELS] == before
    assert _lib._lib is None
