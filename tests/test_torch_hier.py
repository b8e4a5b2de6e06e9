"""Kernel F (the hierarchical block march) in its plain PyTorch version:
against the JAX ``block_march_hier`` (Pallas interpret mode on the CPU)
and against the port's flat ``block_march`` over the very same ClusterSet
(tests/test_march.py's 20000-triangle sphere, 80 clusters in 10
superclusters), coherent and incoherent waves, nearest and any-hit; on
edge waves (dead rays among live ones, a wave that misses everything,
and, port side only, NaN cluster, supercluster and sub rows among live
ones); and ``block_march``'s routing with ``HIER_MIN_CLUSTERS`` lowered,
as tests/test_march.py lowers it.

Hit rule (bench.py): prim ids equal, or |dt| <= 1e-5 |t| + 1e-6 at an
fp-equal t (flat and hierarchical marchers may pick different triangles
on an exact tie).  Occlusion waves: hit masks equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import sweep as jsweep
from optix_ray_tracer_tpu.ops.pallas import block_march as jbm
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as tbm
from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def setup():
    v, _ = sphere_with_n_triangles(20000)
    jc = jsweep.build_clusters(v)
    tc = convert.clusters(convert.state_arrays(jc), device="cpu")
    assert tc.num_clusters >= 64
    cam = JCamera.look_at((3.0, 0.0, 0.3), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    oc, dc = cam.generate_rays(32, 24)
    oc, dc = np.asarray(oc).reshape(-1, 3), np.asarray(dc).reshape(-1, 3)
    # coherent waves arrive Morton-sorted, as MarchIntersector sorts them
    lo, hi = _t(v.reshape(-1, 3).min(0)), _t(v.reshape(-1, 3).max(0))
    perm = torch.argsort(ray_sort_keys(_t(oc), _t(dc), lo, hi),
                         stable=True).numpy()
    rng = np.random.default_rng(9)
    oi = rng.uniform(-1.2, 1.2, (512, 3)).astype(np.float32)
    di = rng.normal(size=(512, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    return jc, tc, {"coherent": (oc[perm], dc[perm]),
                    "incoherent": (oi, di)}


def _prims(prim_index, slot):
    slot = np.asarray(slot)
    return np.where(slot < 0, -1, np.asarray(prim_index)[np.maximum(slot, 0)])


def _bounds(n, any_hit, seg):
    return (np.full(n, 1e-3, np.float32),
            np.full(n, seg if any_hit else 1e16, np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("wave", ["coherent", "incoherent"])
def test_hier_matches_jax_and_flat(setup, wave, any_hit):
    jc, tc, waves = setup
    o, d = waves[wave]
    coherent = wave == "coherent"
    tmin, tmax = _bounds(o.shape[0], any_hit, 2.3 if coherent else 0.7)
    jt, js, _, _ = jbm.block_march_hier(
        jc, *(jnp.asarray(x) for x in (o, d, tmin, tmax)), any_hit=any_hit,
        coherent=coherent)
    args = [_t(x) for x in (o, d, tmin, tmax)]
    ht, hs, hu, hv = tbm.block_march_hier(tc, *args, any_hit=any_hit,
                                          coherent=coherent)
    # the flat kernel B on the same wave (an explicit block width keeps
    # block_march off the hierarchical route)
    ft, fs, fu, fv = tbm.block_march(tc, *args, any_hit=any_hit,
                                     coherent=coherent, block_rays=128)
    if any_hit:
        ref = np.asarray(js) >= 0
        np.testing.assert_array_equal(hs.numpy() >= 0, ref)
        np.testing.assert_array_equal(fs.numpy() >= 0, ref)
        assert 0 < ref.sum() < ref.size
        return
    ph = _prims(tc.prim_index, hs.numpy())
    assert hit_mismatches(_t(ph), ht, _t(_prims(jc.prim_index, js)),
                          _t(jt)) == 0
    assert hit_mismatches(_t(ph), ht, _t(_prims(tc.prim_index, fs.numpy())),
                          ft) == 0
    assert (ph >= 0).sum() > o.shape[0] // 4
    same = hs == fs
    torch.testing.assert_close(hu[same], fu[same], rtol=0, atol=0)
    torch.testing.assert_close(hv[same], fv[same], rtol=0, atol=0)


def _edge_wave(setup, wave):
    """(o, d, t_min, t_max) of an edge wave over the incoherent rays:
    "dead_rays" gives every third and every seventh ray t_max 0,
    "all_miss" starts every ray outside the sphere facing away."""
    o, d = setup[2]["incoherent"]
    tmin, tmax = _bounds(o.shape[0], False, None)
    if wave == "all_miss":
        d = o / np.linalg.norm(o, axis=-1, keepdims=True)
        o = 3.0 * d
    else:
        tmax[::3] = 0.0
        tmax[5::7] = 0.0
    return o, d, tmin, tmax


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("wave", ["dead_rays", "all_miss"])
def test_hier_edge_waves_match_jax_and_flat(setup, wave, any_hit):
    """Plain F on edge waves against the JAX block_march_hier and plain
    B: dead rays keep slot -1 and t = t_max, an all-miss wave hits
    nothing."""
    jc, tc, _ = setup
    o, d, tmin, tmax = _edge_wave(setup, wave)
    jt, js, _, _ = jbm.block_march_hier(
        jc, *(jnp.asarray(x) for x in (o, d, tmin, tmax)), any_hit=any_hit,
        coherent=False)
    args = [_t(x) for x in (o, d, tmin, tmax)]
    ht, hs, _, _ = tbm.block_march_hier(tc, *args, any_hit=any_hit,
                                        coherent=False)
    ft, fs, _, _ = tbm.block_march(tc, *args, any_hit=any_hit,
                                   coherent=False, block_rays=128)
    hit = hs.numpy() >= 0
    np.testing.assert_array_equal(hit, np.asarray(js) >= 0)
    np.testing.assert_array_equal(hit, fs.numpy() >= 0)
    if wave == "all_miss":
        assert not hit.any()
    else:
        assert not hit[tmax <= tmin].any() and hit.any()
    if not any_hit:
        ph = _t(_prims(tc.prim_index, hs.numpy()))
        assert hit_mismatches(ph, ht, _t(_prims(jc.prim_index, js)),
                              _t(jt)) == 0
        assert hit_mismatches(ph, ht, _t(_prims(tc.prim_index, fs.numpy())),
                              ft) == 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_hier_nan_rows_match_flat(setup, any_hit):
    """Plain F with NaN cluster rows (every fifth, and all eight of
    supercluster 1, whose union is then NaN) and NaN sub rows among live
    ones, against plain B on the same rows: no hit lies in a NaN cluster
    or part."""
    _, tc, waves = setup
    o, d = (_t(x) for x in waves["incoherent"])
    n = o.shape[0]
    inp = tbm.hier_inputs(tc, o, d, torch.full((n,), 1e-3),
                          torch.full((n,), 1e16), coherent=False)
    boxes, subs = inp["boxes"].clone(), inp["sub_boxes"].clone()
    boxes[1::5] = float("nan")
    boxes[tbm.GROUP:2 * tbm.GROUP] = float("nan")
    subs[2::3, 1] = float("nan")
    sup = tbm.supercluster_boxes(boxes)
    assert torch.isnan(sup[1, :6]).all() and not torch.isnan(sup[0]).any()
    args = dict(inp, boxes=boxes, sub_boxes=subs, sup_boxes=sup)
    del args["w"]
    ht, hs = tbm.march_hier_plain(**args, any_hit=any_hit)
    del args["sup_boxes"]
    ft, fs = tbm.march_plain(**args, any_hit=any_hit)
    hit = hs >= 0
    assert torch.equal(hit, fs >= 0) and int(hit.sum()) > n // 8
    if not any_hit:
        assert hit_mismatches(_t(_prims(tc.prim_index, hs.numpy())), ht,
                              _t(_prims(tc.prim_index, fs.numpy())), ft) == 0
    cl = hs[hit].long() // tbm.CLUSTER_TRIS
    part = hs[hit].long() % tbm.CLUSTER_TRIS // (tbm.CLUSTER_TRIS
                                                 // inp["n_subs"])
    assert not torch.isnan(boxes[cl, 0]).any()
    assert not torch.isnan(subs[cl, part, 0]).any()


def test_supercluster_boxes(setup):
    """Superclusters: NaN-aware unions of 8 cluster boxes, all-NaN
    padding rows, and every cluster box inside its supercluster's."""
    _, tc, waves = setup
    o, d = (_t(x) for x in waves["coherent"])
    inp = tbm.hier_inputs(tc, o, d, torch.full((o.shape[0],), 1e-3),
                          torch.full((o.shape[0],), 1e16))
    C = tc.num_clusters
    S = -(-C // tbm.GROUP)
    sup = inp["sup_boxes"]
    assert sup.shape[0] % 8 == 0 and torch.isnan(sup[S:, :6]).all()
    boxes = inp["boxes"][:S * tbm.GROUP].reshape(S, tbm.GROUP, 8)
    real = ~torch.isnan(boxes[..., 0])
    assert (boxes[..., 0:3] >= sup[:S, None, 0:3])[real].all()
    assert (boxes[..., 3:6] <= sup[:S, None, 3:6])[real].all()
    assert inp["w"] == tbm.BLOCK_RAYS


def test_routing(setup, monkeypatch):
    """With HIER_MIN_CLUSTERS lowered, block_march sends coherent waves
    to F and incoherent waves to B, with the same hits either way."""
    _, tc, waves = setup
    calls = []
    hier = tbm.block_march_hier

    def spy(*a, **kw):
        calls.append(kw.get("coherent"))
        return hier(*a, **kw)

    monkeypatch.setattr(tbm, "block_march_hier", spy)
    o, d = (_t(x) for x in waves["coherent"])
    n = o.shape[0]
    tmin, tmax = torch.full((n,), 1e-3), torch.full((n,), 1e16)
    flat = tbm.block_march(tc, o, d, tmin, tmax)
    assert calls == []                       # 80 clusters < 3072
    monkeypatch.setattr(tbm, "HIER_MIN_CLUSTERS", 8)
    routed = tbm.block_march(tc, o, d, tmin, tmax)
    assert calls == [True]
    tbm.block_march(tc, o, d, tmin, tmax, coherent=False)
    tbm.block_march(tc, o, d, tmin, tmax, block_rays=256)
    assert calls == [True]                   # incoherent / explicit W: B
    pf = _prims(tc.prim_index, flat[1].numpy())
    pr = _prims(tc.prim_index, routed[1].numpy())
    assert hit_mismatches(_t(pr), routed[0], _t(pf), flat[0]) == 0
