"""The marcher past ``block_march.MAX_CLUSTERS`` (8,192 clusters), on the
CPU: the deep kernels' plain versions, F2's (``march_deep_plain``) and
C2's (``probe_deep_plain``), and the routing that sends a wave to them.

* A ClusterSet of 8,202 clusters (5,302 UV spheres of 396 triangles,
  Morton-built; one sphere twice, so rays that hit it tie at an exactly
  equal t; its supercluster and hypercluster tables end in NaN padding):
  ``block_march`` on coherent and incoherent waves of 64 rays (the brute
  force scans 2.1M triangles a ray), nearest and any-hit, against
  ``intersect_scene_bruteforce`` under the hit rule (prim ids equal, or
  |dt| <= 1e-5 |t| + 1e-6), every seventh ray dead.
* C2's plain probe against a brute-force scan of every cluster box
  (nearest entry, lowest id on ties) over 8,203 random boxes with equal
  copies across hyperclusters, nested boxes, a box with a NaN, dead and
  NaN rays: ids equal.
* Routing: past the cap every wave takes the deep twins and opens one
  ``march.deep`` span; at or below it, none of them; the error past
  MAX_DEEP_CLUSTERS names the limit."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.ops import march
from optix_ray_tracer_tpu_torch.ops.intersect import (
    hit_mismatches, intersect_scene_bruteforce,
)
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
from optix_ray_tracer_tpu_torch.ops.sweep import build_clusters
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)

torch.set_num_threads(2)

SPHERES = 5302          # x 396 triangles: 8,202 clusters of 256


def _sphere_grid(n: int, spacing: float = 2.5):
    """n unit UV spheres of 396 triangles on a square grid in z = 0, the
    first one twice (the copy last): (vertices (T, 3, 3), normals)."""
    v, nrm = sphere_with_n_triangles(450)
    side = int(np.ceil(np.sqrt(n)))
    k = np.arange(n - 1)
    centers = np.stack([k % side, k // side, np.zeros(n - 1)], -1) * spacing
    centers = np.concatenate([centers, centers[:1]]).astype(np.float32)
    return ((v[None] + centers[:, None, None]).reshape(-1, 3, 3),
            np.broadcast_to(nrm, (n,) + nrm.shape).reshape(-1, 3, 3))


@pytest.fixture(scope="module")
def deep():
    v, nrm = _sphere_grid(SPHERES)
    cs = build_clusters(v, method="morton", device="cpu")
    assert cs.num_clusters == 8202 > bm.MAX_CLUSTERS
    scene = Scene(Spheres.empty(device="cpu"),
                  Triangles.from_arrays(v, nrm, device="cpu"))
    r = np.random.default_rng(5)
    side = np.ceil(np.sqrt(SPHERES)) * 2.5
    # coherent: a pinhole fan over the grid, Morton-sorted as the
    # intersector sorts camera waves; its first rays aim at the twin
    n = 64
    o_c = np.tile(np.array([[-3.0, -3.0, 6.0]], np.float32), (n, 1))
    aim = np.concatenate([
        np.zeros((16, 3)) + r.uniform(-0.3, 0.3, (16, 3)) * [1, 1, 0],
        r.uniform(0.0, side, (n - 16, 3)) * [1, 1, 0]]) - o_c
    d_c = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(
        np.float32)
    o_c, d_c = torch.as_tensor(o_c), torch.as_tensor(d_c)
    lo, hi = v.reshape(-1, 3).min(0), v.reshape(-1, 3).max(0)
    perm = torch.argsort(ray_sort_keys(o_c, d_c, torch.as_tensor(lo),
                                       torch.as_tensor(hi)), stable=True)
    o_c, d_c = o_c[perm], d_c[perm]
    # incoherent: between and inside the spheres, every direction
    o_i = torch.as_tensor(np.concatenate([
        r.uniform(-1.0, side, (n, 2)), r.uniform(-1.5, 1.5, (n, 1))],
        -1).astype(np.float32))
    d_i = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32))
    d_i = d_i / torch.linalg.norm(d_i, dim=-1, keepdim=True)
    waves = {}
    for name, o, d in (("coherent", o_c, d_c), ("incoherent", o_i, d_i)):
        tmax = torch.full((n,), 1e16)
        tmax[::7] = 0.0                       # dead lanes
        ref = intersect_scene_bruteforce(scene, o, d, 1e-3, tmax, chunk=4096)
        waves[name] = (o, d, tmax, ref)
    return cs, scene, waves


def _prims(cs, slot):
    return torch.where(slot < 0, -1, cs.prim_index[slot.clamp(min=0).long()])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("wave", ["coherent", "incoherent"])
def test_deep_march_matches_brute_force(deep, wave, any_hit):
    cs, _, waves = deep
    o, d, tmax, ref = waves[wave]
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3)
    seg = 8.5 if wave == "coherent" else 0.8
    if any_hit:
        tmax = torch.where(tmax > 0, torch.full_like(tmax, seg), tmax)
    t, slot, _, _ = bm.block_march(cs, o, d, tmin, tmax, any_hit=any_hit,
                                   coherent=wave == "coherent")
    if any_hit:
        assert torch.equal(slot >= 0, ref.t < seg)
        assert 0 < int((slot >= 0).sum()) < n
    else:
        assert hit_mismatches(_prims(cs, slot), t, ref.prim_id, ref.t) == 0
        assert int((slot >= 0).sum()) > n // 4
    assert not bool((slot[::7] >= 0).any())   # dead lanes hit nothing


def test_deep_march_ties_at_the_twin(deep):
    """Rays on the sphere drawn twice hit one of its two copies, at the
    same t as the brute force's."""
    cs, _, waves = deep
    o, d, tmax, ref = waves["coherent"]
    tmin = torch.full((o.shape[0],), 1e-3)
    t, slot, _, _ = bm.block_march(cs, o, d, tmin, tmax)
    prim = _prims(cs, slot)
    per = 396
    twin = (prim >= 0) & ((prim < per) | (prim >= (SPHERES - 1) * per))
    assert int(twin.sum()) >= 4
    assert hit_mismatches(prim[twin] % per, t[twin],
                          ref.prim_id[twin] % per, ref.t[twin]) == 0


def test_deep_intersector_uses_the_deep_tables(deep):
    """MarchIntersector's incoherent wave (C2's probe keys, then F2) past
    the cap, through the tables it builds once for both."""
    cs, scene, waves = deep
    o, d, tmax, ref = waves["incoherent"]
    inter = march.march_intersector_from_clusters(cs, scene)
    hit = inter.for_incoherent().intersect(scene, o, d, t_max=tmax)
    assert hit_mismatches(hit.prim_id, hit.t, ref.prim_id, ref.t) == 0
    tables = bm.march_tables(cs, coherent=False)
    assert {"hyper_boxes", "sup_boxes"} <= set(tables)
    n_sup, n_hyper = -(-8202 // 8), -(-(-(-8202 // 8)) // 8)
    assert tables["sup_boxes"].shape == (-(-n_sup // 8) * 8, 8)
    assert tables["hyper_boxes"].shape == (-(-n_hyper // 8) * 8, 8)
    # pure padding past the last hypercluster is NaN, never entered
    assert bool(torch.isnan(tables["hyper_boxes"][n_hyper:, :6]).all())


def _probe_boxes(n_clusters: int, n_rays: int, seed: int):
    """probe_call arguments over random boxes (min <= max) with copies of
    box 1 in three other hyperclusters, box 2 around box 3, box 5 with a
    NaN; random rays, every fifth dead, a block inside box 3, one with a
    NaN origin."""
    r = np.random.default_rng(seed)
    c_pad = -(-n_clusters // 8) * 8
    lo = r.uniform(-1.0, 0.9, (n_clusters, 3))
    hi = lo + r.uniform(0.01, 0.12, (n_clusters, 3))
    lo[1], hi[1] = (2.0, 2.0, 2.0), (2.1, 2.1, 2.1)   # alone, out of the way
    for c in (100, 4000, n_clusters - 1):
        lo[c], hi[c] = lo[1], hi[1]
    lo[2], hi[2] = lo[3] - 0.02, hi[3] + 0.02
    boxes = np.full((c_pad, 8), np.nan, np.float32)
    boxes[:, 6:] = 0.0
    boxes[:n_clusters, 0:3], boxes[:n_clusters, 3:6] = lo, hi
    boxes[5, 4] = np.nan
    o = r.uniform(-1.1, 1.1, (n_rays, 3))
    o[:64] = (lo[3] + hi[3]) / 2
    o[64:128] = (lo[1] + hi[1]) / 2 - [0.0, 0.0, 0.5]
    d = r.normal(size=(n_rays, 3))
    d[64:128] = [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n_rays, 1e16)
    tmax[::5] = 0.0
    o[7] = np.nan
    rays = np.ascontiguousarray(np.concatenate(
        [o.T, d.T, np.full((1, n_rays), 1e-3), tmax[None]]), np.float32)
    return dict(rays=torch.as_tensor(rays), boxes=torch.as_tensor(boxes),
                n_clusters=n_clusters, c_pad=c_pad)


def _probe_brute(rays, boxes, n_clusters, c_pad):
    """Every ray against every box: the nearest entry below t_max, the
    lowest id on ties (argmin's first), else c_pad."""
    e = bm.slab_entry(boxes[None, :n_clusters, 0:3],
                      boxes[None, :n_clusters, 3:6], rays[0:3].T[:, None],
                      bm.inv_dir(rays[3:6].T)[:, None], rays[6][:, None])
    e = torch.where(e < rays[7][:, None], e, torch.full_like(e, bm.INF))
    ids = torch.argmin(e, 1)
    hit = torch.gather(e, 1, ids[:, None])[:, 0] < bm.INF
    return torch.where(hit, ids, torch.full_like(ids, c_pad)).to(torch.int32)


@pytest.mark.parametrize("n_clusters", [8193, 8203, 9000])
def test_deep_probe_matches_brute_force(n_clusters):
    inp = _probe_boxes(n_clusters, 1024, seed=n_clusters)
    ids, tests = bm.probe_call(**inp)
    assert tests is None                       # the plain version ran
    assert torch.equal(ids, _probe_brute(**inp))
    assert torch.equal(ids, bm.probe_plain(**inp))
    # ties: the copies of box 1 never win over box 1
    assert int((ids[64:128] == 1).sum()) > 0
    assert not bool(torch.isin(ids, torch.tensor(
        [100, 4000, n_clusters - 1], dtype=torch.int32)).any())
    assert int(ids[7]) == inp["c_pad"] and bool(
        (ids[::5] == inp["c_pad"]).all())
    assert int((ids < n_clusters).sum()) > 1024 // 4


def test_deep_tables_are_unions():
    """Each hypercluster holds its superclusters, each of those its
    clusters (NaN-aware), NaN rows for pure padding."""
    inp = _probe_boxes(8203, 8, seed=1)
    boxes = inp["boxes"]
    sup, hyper = bm.deep_tables(boxes)
    n_sup = -(-8203 // 8)
    for s in (0, 77, n_sup - 1):
        mem = boxes[8 * s:8 * s + 8]
        ok = ~torch.isnan(mem[:, :6]).any(1)
        assert bool((sup[s, :3] <= mem[ok, :3]).all())
        assert bool((sup[s, 3:6] >= mem[ok, 3:6]).all())
    for h in (0, 128):
        mem = sup[8 * h:8 * h + 8]
        ok = ~torch.isnan(mem[:, :6]).any(1)
        assert bool((hyper[h, :3] <= mem[ok, :3]).all())
        assert bool((hyper[h, 3:6] >= mem[ok, 3:6]).all())
    assert bool(torch.isnan(hyper[129:, :6]).all())


def _small():
    v, nrm = sphere_with_n_triangles(20000)
    scene = Scene(Spheres.empty(device="cpu"),
                  Triangles.from_arrays(v, nrm, device="cpu"))
    inter = march.make_march_intersector(scene, method="morton")
    r = np.random.default_rng(2)
    o = torch.as_tensor(r.uniform(-1.2, 1.2, (256, 3)).astype(np.float32))
    d = torch.as_tensor(r.normal(size=(256, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return scene, inter, o, d


def _forbid(monkeypatch, names):
    def refuse(*a, **k):
        raise AssertionError("a wave took the wrong marcher")
    for name in names:
        monkeypatch.setattr(bm, name, refuse)


DEEP = ("march_deep_plain", "probe_deep_plain", "march_deep_call")
SHALLOW = ("march_plain", "march_hier_plain", "probe_plain")


def _spans(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == "march.deep" for e in prof.events())


def test_scenes_at_the_cap_take_todays_marchers(monkeypatch):
    """A scene of at most MAX_CLUSTERS clusters: its probe, coherent and
    incoherent marches take B, C and F's plain versions, with B, C and F's
    tables (the probe called with C's arguments alone), and open no
    ``march.deep`` span."""
    scene, inter, o, d = _small()
    assert not bm.is_deep(inter.clusters.num_clusters)
    assert not bm.is_deep(bm.MAX_CLUSTERS) and bm.is_deep(bm.MAX_CLUSTERS + 1)
    assert "hyper_boxes" not in bm.march_tables(inter.clusters, False)
    _forbid(monkeypatch, DEEP)
    probe, probes = bm.probe_call, []

    def seen(**kw):
        probes.append(sorted(kw))
        return probe(**kw)
    monkeypatch.setattr(bm, "probe_call", seen)
    want = intersect_scene_bruteforce(scene, o, d)
    for it in (inter, inter.for_incoherent()):
        hit, n = _spans(lambda: it.intersect(scene, o, d))
        assert n == 0
        assert hit_mismatches(hit.prim_id, hit.t, want.prim_id, want.t) == 0
    assert probes == [["boxes", "c_pad", "n_clusters", "rays"]]


def test_scenes_past_the_cap_take_the_deep_marchers(monkeypatch):
    """The same scene with the cap lowered below its cluster count: every
    wave takes F2 and C2's plain versions, one ``march.deep`` span a
    wave, and the same hits."""
    scene, inter, o, d = _small()
    monkeypatch.setattr(bm, "MAX_CLUSTERS", 16)
    assert bm.is_deep(inter.clusters.num_clusters)
    _forbid(monkeypatch, SHALLOW)
    want = intersect_scene_bruteforce(scene, o, d)
    for it in (inter, inter.for_incoherent()):
        hit, n = _spans(lambda: it.intersect(scene, o, d))
        assert n == 1
        assert hit_mismatches(hit.prim_id, hit.t, want.prim_id, want.t) == 0


def test_cap_error_names_the_limit():
    bm._check_clusters(bm.MAX_DEEP_CLUSTERS)
    with pytest.raises(ValueError, match="65,536 clusters = 16,777,216"):
        bm._check_clusters(bm.MAX_DEEP_CLUSTERS + 1)


def test_probe_key_shift_fits_the_ids():
    """Kernel O gives a probe key's id field 14 bits: ids stay whole up to
    16,383 clusters (today's scenes keep the JAX package's keys) and are
    shifted past it."""
    for c_pad, shift in ((3368, 0), (8192, 0), (16376, 0), (16384, 1),
                         (26136, 1), (65536, 3)):
        assert bm.probe_key_shift(c_pad) == shift
        assert c_pad >> shift < 1 << 14


def test_device_first_build_is_the_rebuild():
    """``rebuild_clusters(None, ...)`` (a large scene's first build on the
    card) gives the per-file rebuild's ClusterSet from scratch."""
    from optix_ray_tracer_tpu_torch.ops.sweep import rebuild_clusters
    v, _ = _sphere_grid(40)
    tv = torch.as_tensor(v)
    got = rebuild_clusters(None, tv)
    want = rebuild_clusters(build_clusters(v, device="cpu"), tv)
    for f in ("woop", "woop_t", "prim_index", "cluster_min", "cluster_max",
              "sub_min", "sub_max"):
        assert torch.equal(getattr(got, f), getattr(want, f)) or (
            torch.allclose(getattr(got, f), getattr(want, f),
                           equal_nan=True, rtol=0, atol=0)), f


@pytest.mark.parametrize("cuda,triangles,method", [
    (False, 6_689_762, "sah"), (True, 862_166, "sah"),
    (True, 2_000_000, "sah"), (True, 2_000_001, "median"),
    (True, 6_689_762, "median")])
def test_first_build_method_follows_the_host_build_cost(cuda, triangles,
                                                       method):
    """The device median build replaces the host SAH build only on the
    card and only past HOST_BUILD_MAX_TRIS: the pile (862,166 triangles)
    keeps its SAH build, the chute (6,689,762) does not wait for one."""
    from types import SimpleNamespace

    from optix_ray_tracer_tpu_torch.models import common
    scene = SimpleNamespace(
        triangles=SimpleNamespace(vertices=SimpleNamespace(is_cuda=cuda)),
        triangle_count=triangles)
    assert common.first_build_method(scene) == method
