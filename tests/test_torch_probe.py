"""Kernel C (cluster probe) and the needed-work counts of the kernel
table, on the CPU:

* the plain probe (``probe_plain``, a flat scan over every box) equals a
  two-level numpy reference written here (superclusters of 8 clusters in
  ascending id order, members opened only when the union's entry is below
  the best entry so far and t_max) and the JAX probe (Pallas interpret
  mode) on adversarial fixtures: equal entries across superclusters,
  rays starting inside several overlapping boxes, NaN padding at a
  cluster count that is not a multiple of 8, a real box with a NaN, dead
  rays and NaN rays;
* ``needed_probe_work`` equals a brute-force per-ray loop and never
  exceeds the flat count;
* ``needed_raster_work`` equals a brute-force loop over the schedules of
  kernels A and D.

Ids are compared exactly, counts as integers."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.ops.pallas import block_march as jbm
from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.ops import raster
from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from test_torch_instanced import _setup, _waves

torch.set_num_threads(2)

N_RAYS = 384      # a multiple of the JAX probe's 128-ray blocks
INF = np.float32(1e16)


def _fixture(n_clusters: int, seed: int):
    """(rays (8, N_RAYS), boxes (c_pad, 8)) as float32 numpy arrays."""
    r = np.random.default_rng(seed)
    c_pad = -(-n_clusters // 8) * 8
    lo = r.uniform(-1.0, 0.8, (n_clusters, 3))
    hi = lo + r.uniform(0.05, 0.7, (n_clusters, 3))
    # the same box in three superclusters (equal entries across them), and
    # a nested pair: rays inside both enter both at t_min
    for c in (9, 17):
        if c < n_clusters:
            lo[c], hi[c] = lo[1], hi[1]
    lo[2], hi[2] = lo[3] - 0.05, hi[3] + 0.05
    boxes = np.full((c_pad, 8), np.nan, np.float32)
    boxes[:, 6:] = 0.0
    boxes[:n_clusters, 0:3], boxes[:n_clusters, 3:6] = lo, hi
    boxes[n_clusters - 2, 4] = np.nan       # a real box with a NaN
    o = r.uniform(-1.2, 1.2, (N_RAYS, 3))
    o[:32] = (lo[1] + hi[1]) / 2 + r.uniform(-0.01, 0.01, (32, 3))
    o[32:48] = (lo[3] + hi[3]) / 2          # inside boxes 2 and 3
    d = r.normal(size=(N_RAYS, 3))
    d[48:64] = [1.0, 0.0, 0.0]              # axis-parallel: 1/d = 1e12
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # rays aimed from outside at box 1 (and its copies)
    far = (lo[1] + hi[1]) / 2 + [(hi[1, 0] - lo[1, 0]) / 2 + 0.05, 0, 0]
    o[64:96] = far
    d[64:96] = (lo[1] + hi[1]) / 2 + r.uniform(-0.02, 0.02, (32, 3)) - far
    d[64:96] /= np.linalg.norm(d[64:96], axis=-1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-3)
    tmax = np.full(N_RAYS, INF, np.float64)
    tmax[100:110] = 0.0                     # dead: t_max < t_min
    tmax[110:115] = 1e-3                    # dead: t_max == t_min
    tmax[115:130] = 0.3                     # short segments
    rays = np.concatenate([o.T, d.T, tmin[None], tmax[None]]).astype(
        np.float32)
    rays[0, 130] = np.nan                   # NaN origin: never fires
    rays[4, 131] = np.nan                   # NaN direction: 1/d = 1e12
    rays[6, 132] = np.nan                   # NaN t_min
    rays[7, 133] = np.nan                   # NaN t_max
    return rays, boxes


def _entries_np(lo, hi, o, inv, tmin):
    """Slab entries (R,) in float32, the kernels' operation order, NaN
    propagating (np.maximum / np.minimum)."""
    ent = np.full(o.shape[0], -INF, np.float32)
    ext = np.full(o.shape[0], INF, np.float32)
    for ax in range(3):
        t0 = (lo[ax] - o[:, ax]) * inv[:, ax]
        t1 = (hi[ax] - o[:, ax]) * inv[:, ax]
        ent = np.maximum(ent, np.minimum(t0, t1))
        ext = np.minimum(ext, np.maximum(t0, t1))
    ent = np.maximum(ent, tmin)
    return np.where(ent <= ext, ent, INF)


def _inv_np(d):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(np.abs(d) > 1e-12, np.float32(1) / d,
                        np.float32(1e12)).astype(np.float32)


def two_level_probe(rays, boxes, n_clusters):
    """The probe by superclusters: NaN-aware 8-cluster unions visited in
    ascending id order; a supercluster's members are tested (ascending)
    only where the union's entry is below both the best entry so far and
    t_max; a member takes the answer on a strictly smaller entry."""
    o, inv = rays[0:3].T, _inv_np(rays[3:6].T)
    tmin, tmax = rays[6], rays[7]
    c_pad = boxes.shape[0]
    emin = np.full(o.shape[0], INF, np.float32)
    first = np.full(o.shape[0], c_pad, np.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-NaN unions
        for s in range(-(-n_clusters // 8)):
            mem = boxes[8 * s:min(8 * s + 8, n_clusters)]
            eu = _entries_np(np.nanmin(mem[:, 0:3], 0),
                             np.nanmax(mem[:, 3:6], 0), o, inv, tmin)
            opened = (eu < emin) & (eu < tmax)
            for k, box in enumerate(mem):
                e = _entries_np(box[0:3], box[3:6], o, inv, tmin)
                take = opened & (e < tmax) & (e < emin)
                emin = np.where(take, e, emin)
                first = np.where(take, 8 * s + k, first)
    return np.where(emin < INF, first, c_pad)


CLUSTER_COUNTS = [29, 64, 203]


@pytest.mark.parametrize("n_clusters", CLUSTER_COUNTS)
def test_probe_plain_equals_two_level_reference(n_clusters):
    rays, boxes = _fixture(n_clusters, seed=n_clusters)
    want = two_level_probe(rays, boxes, n_clusters)
    c_pad = boxes.shape[0]
    got = bm.probe_plain(torch.as_tensor(rays), torch.as_tensor(boxes),
                         n_clusters, c_pad).numpy()
    np.testing.assert_array_equal(got, want)
    # the fixture holds what it is meant to: ties across superclusters
    # (the lowest copy wins), dead and NaN-origin / NaN-bound rays
    assert (got[100:115] == c_pad).all() and (got[[130, 132, 133]] ==
                                              c_pad).all()
    assert not np.isin(got[:96], [9, 17]).any()
    assert (got[:96] == 1).sum() > 8
    assert (got < c_pad).sum() > N_RAYS // 3


@pytest.mark.parametrize("n_clusters", CLUSTER_COUNTS)
def test_probe_matches_jax_on_adversarial(n_clusters):
    """The JAX probe kernel (interpret mode) on the same padded boxes."""
    rays, boxes = _fixture(n_clusters, seed=n_clusters)
    c_pad = boxes.shape[0]
    ref = np.asarray(jbm._probe_call(jnp.asarray(rays), jnp.asarray(boxes),
                                     c_pad=c_pad, n_clusters=n_clusters,
                                     w=128)).reshape(-1)
    got = bm.probe_plain(torch.as_tensor(rays), torch.as_tensor(boxes),
                         n_clusters, c_pad).numpy()
    np.testing.assert_array_equal(got, ref)


def test_probe_live_rule():
    """probe_live marks exactly the rays that can get an id: the others
    all get c_pad from the plain probe."""
    rays, boxes = _fixture(64, seed=5)
    live = bm.probe_live(torch.as_tensor(rays)).numpy()
    assert not live[100:115].any() and not live[[130, 132, 133]].any()
    assert live[131]                        # a NaN direction may fire
    got = bm.probe_plain(torch.as_tensor(rays), torch.as_tensor(boxes), 64,
                         64).numpy()
    assert (got[~live] == 64).all()


def test_probe_call_on_cpu_is_plain():
    """On CPU tensors probe_call returns the plain ids and no test count,
    and launches nothing."""
    rays, boxes = (torch.as_tensor(x) for x in _fixture(29, seed=2))
    before = _lib.PROBE.launches
    ids, tests = bm.probe_call(rays, boxes, 29, 32)
    assert tests is None and _lib.PROBE.launches == before
    assert torch.equal(ids, bm.probe_plain(rays, boxes, 29, 32))


def test_supercluster_boxes():
    """hier_inputs' supercluster boxes (kernel F's, and those
    needed_probe_work counts kernel C's pre-cull on) come from
    supercluster_boxes: a pure-padding supercluster is NaN, a partly padded
    one is the union of its real clusters."""
    v, n = sphere_with_n_triangles(1500)
    cs = make_march_intersector(Scene(
        Spheres.empty(device="cpu"),
        Triangles.from_arrays(v, n, device="cpu"))).clusters
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    tmin, tmax = torch.full((4,), 1e-3), torch.full((4,), 1e16)
    boxes = bm.probe_inputs(cs, o, d, tmin, tmax)["boxes"]
    sup = bm.supercluster_boxes(boxes)
    torch.testing.assert_close(bm.hier_inputs(cs, o, d, tmin, tmax)
                               ["sup_boxes"], sup, equal_nan=True, rtol=0,
                               atol=0)
    C = cs.num_clusters
    S = -(-C // 8)
    assert C % 8 and torch.isnan(sup[S:, :6]).all()
    torch.testing.assert_close(sup[S - 1, 0:3],
                               boxes[8 * (S - 1):C, 0:3].amin(0))
    torch.testing.assert_close(sup[S - 1, 3:6],
                               boxes[8 * (S - 1):C, 3:6].amax(0))


def _brute_probe_work(rays, first, boxes, n_clusters):
    """needed_probe_work's counts by a loop over rays and superclusters."""
    sup = bm.supercluster_boxes(boxes)
    n_sup = -(-n_clusters // 8)
    slab = flat = 0
    for r in range(rays.shape[1]):
        o, inv, tmin = rays[0:3, r], bm.inv_dir(rays[3:6, r]), rays[6, r]
        if not bool(tmin < rays[7, r]) or bool(torch.isnan(o).any()):
            continue
        flat += n_clusters
        slab += n_sup
        f = int(first[r])
        if f < n_clusters:
            reach = bm.slab_entry(boxes[f, 0:3], boxes[f, 3:6], o, inv, tmin)

            def needs(e):
                return bool(e <= reach)
        else:
            def needs(e):
                return bool(e < rays[7, r])
        for s in range(n_sup):
            if needs(bm.slab_entry(sup[s, 0:3], sup[s, 3:6], o, inv, tmin)):
                slab += min(8, n_clusters - 8 * s)
    return slab, flat


@pytest.mark.parametrize("n_clusters", [29, 203])
def test_needed_probe_work_matches_brute_force(n_clusters):
    rays, boxes = (torch.as_tensor(x)
                   for x in _fixture(n_clusters, seed=n_clusters))
    first = bm.probe_plain(rays, boxes, n_clusters, boxes.shape[0])
    work = bm.needed_probe_work(rays, first, boxes, n_clusters, chunk=100)
    slab, flat = _brute_probe_work(rays, first, boxes, n_clusters)
    assert (work["slab"], work["flat"]) == (slab, flat)
    assert work["live"] == int(bm.probe_live(rays).sum())
    assert 0 < work["slab"] <= work["flat"]


def _brute_raster_work(inp, w, t, slot, any_hit=False):
    """needed_raster_work's counts by a loop over the scheduled pairs and
    their parts (the rule written out, over the tile's rays): live rays
    only; an occlusion ray's search ends with the part whose slot range
    holds its first hit."""
    inst = "pair_insts" in inp
    sub = inp["sub_boxes"]
    n_subs = sub.shape[1]
    ct = 256 // (1 if inst else inp["granularity"])
    step = ct // n_subs
    nb = inp["n_blocks"]
    rays = inp["rays_t_ext"]
    t, slot = t.reshape(-1), slot.reshape(-1)
    done = torch.zeros(slot.shape, dtype=torch.bool)
    ids = inp["pair_ids"] if inst else inp["pair_clusters"]
    work = dict(slab=0, inst=0, woop=0)
    for p in range(inp["pair_tiles"].shape[0]):
        b = int(inp["pair_tiles"][p])
        if b >= nb:
            continue
        r = slice(b * w, (b + 1) * w)
        o, inv, tmin = rays[0:3, r].T, bm.inv_dir(rays[3:6, r].T), rays[6, r]
        tmax = rays[7, r]
        hit = slot[r] >= 0
        live = tmax > tmin
        work["slab"] += int((live & ~done[r]).sum()) * n_subs
        parts = torch.zeros(w, dtype=torch.int64)
        for k in range(n_subs):
            box = sub[int(ids[p]), k]
            e = bm.slab_entry(box[0:3], box[3:6], o, inv, tmin)
            if any_hit:
                parts += live & ~done[r] & (e < tmax)
                lo = int(ids[p]) * ct + k * step
                done[r] |= (slot[r] >= lo) & (slot[r] < lo + step)
            else:
                parts += live & torch.where(hit, e <= t[r], e < tmax)
        work["woop"] += int(parts.sum()) * step
        work["inst"] += int((parts > 0).sum()) if inst else 0
    return work


def _tile_order(x, h, w, tile):
    return (x.reshape(h // tile, tile, w // tile, tile, 3).transpose(1, 2)
            .reshape(-1, 3))


@pytest.mark.parametrize("case", ["A-nearest", "A-any-hit", "D",
                                  "D-any-hit", "A-bundle-any-hit"])
def test_needed_raster_work_matches_brute_force(case):
    W = 64
    if case.startswith("D"):
        inter = _setup(12, 1.0, 3, invalid=(5,))["tinter"]
        o, d = (torch.as_tensor(np.array(x)) for x in _waves(
            dict(rng=np.random.default_rng(0)), n_cam=(16, 16), n_inc=0))
    else:
        v, n = sphere_with_n_triangles(600)
        inter = make_march_intersector(Scene(
            Spheres.empty(device="cpu"),
            Triangles.from_arrays(v, n, device="cpu")), raster=True)
        cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0), device="cpu")
        o, d = cam.generate_rays(16, 16)
    o, d = _tile_order(o, 16, 16, 8), _tile_order(d, 16, 16, 8)
    R = o.shape[0]
    any_hit = case.endswith("any-hit")
    tmin = torch.full((R,), 1e-3)
    # occlusion segments end inside the sphere's reach; the TLAS wave's
    # run to infinity (its scene is farther)
    tmax = torch.full((R,), 2.5 if case == "A-any-hit" else 1e16)
    tmax[::7] = 0.0                          # dead rays
    if case.startswith("D"):
        S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, o, d,
                                      tmin, tmax, "origin", o[0], W, 1 << 14,
                                      inter.pair_shape, inter.pair_inst)
        inp = ri.instanced_schedule_inputs(inter, S)
        t, slot, _, _ = tr.raster_instanced_plain(
            **inp, w=W, any_hit=any_hit, common="origin")
    elif case == "A-bundle-any-hit":
        # segments from the camera wave's hits toward a point light, each
        # ray's own origin and direction (a bundle schedule)
        far = torch.full((R,), 1e16)
        S0 = raster._coarse_stage(inter.raster, inter.clusters, o, d, tmin,
                                  far, "origin", o[0], W, 1 << 14, 2)
        t0, s0, _, _ = tr.raster_cluster_plain(**raster.schedule_inputs(
            inter.clusters, S0, S0["nb"], 2), w=W, common="origin")
        t0 = t0.reshape(-1)
        hit = s0.reshape(-1) >= 0
        p = o + torch.where(hit, t0, 0.0)[:, None] * d
        light = torch.tensor([2.0, 1.5, 2.5])
        dist = torch.linalg.norm(light - p, dim=-1)
        o, d = p, (light - p) / dist[:, None]
        tmax = torch.where(hit, dist - 1e-3, 0.0)
        S = raster.bundle_stage(inter.clusters, o, d, tmin, tmax, W, 1 << 14)
        inp = raster.schedule_inputs(inter.clusters, S, S["nb"])
        t, slot, _, _ = tr.raster_cluster_plain(**inp, w=W, any_hit=True)
    else:
        S = raster._coarse_stage(inter.raster, inter.clusters, o, d, tmin,
                                 tmax, "origin", o[0], W, 1 << 14, 2)
        inp = raster.schedule_inputs(inter.clusters, S, S["nb"], 2)
        t, slot, _, _ = tr.raster_cluster_plain(**inp, w=W, any_hit=any_hit,
                                                common="origin")
    assert int(S["pc_total"]) <= 1 << 14
    got = tr.needed_raster_work(inp, W, t, slot, any_hit=any_hit,
                                chunk=W * 4 * 3)
    assert got == _brute_raster_work(inp, W, t, slot, any_hit)
    live = int(((inp["rays_t_ext"][7] > inp["rays_t_ext"][6])[
        :inp["n_blocks"] * W]).sum())
    assert 0 < live < inp["n_blocks"] * W
    assert got["woop"] > 0 and (got["inst"] > 0) == case.startswith("D")
    if any_hit:
        # an occlusion search stops at its first hit: never more work
        # than the nearest search over the same segments
        near = tr._raster_plain(inp, W, False, None, tr.WARP)
        full = tr.needed_raster_work(inp, W, near[0], near[1])
        assert 0 < int((slot >= 0).sum())
        assert got["slab"] <= full["slab"]
