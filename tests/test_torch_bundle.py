"""The bundle engine (3-D binning of arbitrary waves, kernel A with
full-width dots): ``bundle_stage``'s pair schedule against the JAX
package's (equal), ``bundle_query`` against the JAX query (Pallas
interpret mode on the CPU) under the hit rule, and
``MarchIntersector.intersect_bundled`` / ``make_tiled_bundle_intersect``
against the marcher, overflow route included.

The wave is the path tracer's: area-light shadow segments from a camera
wave's hit points (t_max just short of the light point), dead lanes
where the camera ray missed.  Hit rule (bench.py): prim ids equal, or
|dt| <= 1e-5 |t| + 1e-6 at an fp-equal t; occlusion compares ``is_hit``
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import march as jmarch
from optix_ray_tracer_tpu.ops import raster as jraster
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import raster as traster
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as ttr
from optix_ray_tracer_tpu_torch.ops.kernels.block_march import block_march
from bundle_cases import check_copies, copies_schedule, same_bits

torch.set_num_threads(2)

W, H = 32, 32          # one 32 x 32 camera tile per 1,024-ray block
BLOCK = 256


def _t(x):
    return torch.as_tensor(np.array(x))


def _prims(prim_index, slot):
    slot = np.asarray(slot)
    return np.where(slot < 0, -1, np.asarray(prim_index)[np.maximum(slot, 0)])


@pytest.fixture(scope="module")
def setup():
    """A 4,000-triangle sphere over a floor (17 clusters), one analytic
    sphere, and NEE segments toward random points of a 1 x 1 light."""
    v, n = sphere_with_n_triangles(4000, (0, 0, 0.5), 0.5)
    fv, fn = quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0])
    jscene = JScene(
        spheres=JSpheres.from_list([((0.9, -0.6, 0.25), 0.25, 0)]),
        triangles=JTriangles.from_arrays(np.concatenate([fv, v]),
                                         np.concatenate([fn, n])))
    jinter = jmarch.make_march_intersector(jscene, raster=True)
    tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    tinter = convert.march_intersector(
        convert.state_arrays(jinter.clusters), tscene, raster=True,
        device="cpu")
    cam = JCamera.look_at((3.0, 0.5, 1.5), (0.0, 0.0, 0.4), (0.0, 0.0, 1.0))
    o, d = (_t(np.asarray(x).reshape(-1, 3))
            for x in cam.generate_rays(W, H))
    h = tinter.intersect(tscene, o, d)
    p = torch.where(h.is_hit[:, None], o + h.t[:, None] * d, o)
    rng = np.random.default_rng(5)
    lp = _t(np.stack([rng.uniform(-0.5, 0.5, W * H),
                      rng.uniform(1.0, 2.0, W * H),
                      np.full(W * H, 2.0)], -1).astype(np.float32))
    to_l = lp - p
    dist = torch.linalg.norm(to_l, dim=-1)
    wl = to_l / dist[:, None]
    so = (p + wl * 1e-3).numpy()
    tmax = torch.where(h.is_hit, dist - 2e-3, 0.0).numpy()
    return dict(jscene=jscene, jinter=jinter, tscene=tscene, tinter=tinter,
                o=so, d=wl.numpy(), tmin=np.full(W * H, 1e-4, np.float32),
                tmax=tmax, cam=cam)


def _wave(s):
    return tuple(s[k] for k in ("o", "d", "tmin", "tmax"))


def log_bundle_waves(monkeypatch) -> list:
    """(pair count, capacity) of every bundle wave from now on, through
    ``raster.BUNDLE_OBSERVERS``."""
    log = []

    def observe(args, kw, S):
        log.append((int(S["pc_total"]), args[6]))

    monkeypatch.setattr(traster, "BUNDLE_OBSERVERS", [observe])
    return log


@pytest.mark.parametrize("octants", [True, False], ids=["octants", "flat"])
@pytest.mark.parametrize("granularity", [1, 2])
def test_bundle_stage_equals_jax(setup, octants, granularity):
    """The schedule: pair count, pairs per block and the depth-sorted
    (block, window) list equal the JAX package's."""
    s = setup
    kw = dict(W=BLOCK, pc_max=4096, dir_octants=octants,
              granularity=granularity)
    js = jraster.bundle_stage(s["jinter"].clusters,
                              *(jnp.asarray(x) for x in _wave(s)), **kw)
    ts = traster.bundle_stage(s["tinter"].clusters,
                              *(_t(x) for x in _wave(s)), **kw)
    assert int(ts["pc_total"]) == int(js["pc_total"]) > 0
    np.testing.assert_array_equal(ts["cnt_b"].numpy(), np.asarray(js["cnt_b"]))
    for k in ("b_i", "c_i", "validc"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_octants_tighten_the_schedule(setup):
    """Splitting each block by direction octant pairs no more windows than
    one interval per block, and every true hit's window stays paired."""
    s = setup
    ts = [traster.bundle_stage(s["tinter"].clusters,
                               *(_t(x) for x in _wave(s)), BLOCK, 4096,
                               dir_octants=o) for o in (True, False)]
    assert int(ts[0]["pc_total"]) <= int(ts[1]["pc_total"])
    for octants in (True, False):
        t, slot, _, _, ok = traster.bundle_query(
            s["tinter"].clusters, *(_t(x) for x in _wave(s)),
            block_rays=BLOCK, dir_octants=octants)
        rt, rslot, _, _ = block_march(s["tinter"].clusters,
                                      *(_t(x) for x in _wave(s)),
                                      coherent=False)
        pi = s["tinter"].clusters.prim_index
        assert ok and hit_mismatches(_t(_prims(pi, slot)), t,
                                     _t(_prims(pi, rslot)), rt) == 0


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_bundle_query_matches_jax(setup, any_hit):
    """Kernel A's plain twin on the bundle schedule against the JAX
    bundle_query: identities under the hit rule (any-hit: is_hit)."""
    s = setup
    kw = dict(any_hit=any_hit, block_rays=BLOCK)
    jt, js, _, _, jok = jraster.bundle_query(
        s["jinter"].clusters, *(jnp.asarray(x) for x in _wave(s)), **kw)
    tt, ts, _, _, tok = traster.bundle_query(
        s["tinter"].clusters, *(_t(x) for x in _wave(s)), **kw)
    assert bool(jok) and tok
    pi = s["tinter"].clusters.prim_index
    pj, pt = _prims(pi, js), _prims(pi, ts.numpy())
    if any_hit:
        np.testing.assert_array_equal(pt >= 0, pj >= 0)
    else:
        assert hit_mismatches(_t(pt), tt, _t(pj), _t(jt)) == 0
    live = s["tmax"] > s["tmin"]
    assert 0 < (pt >= 0).sum() < live.sum()
    assert (pt[~live] == -1).all()


def _split_wave(s):
    """The fixture's wave with block 1 all dead and block 2 one live
    ray."""
    tmax = s["tmax"].copy()
    tmax[BLOCK:2 * BLOCK] = 0.0
    tmax[2 * BLOCK:3 * BLOCK] = 0.0
    tmax[2 * BLOCK + 7] = 3.0
    return s["o"], s["d"], s["tmin"], tmax


@pytest.mark.parametrize("octants", [True, False], ids=["octants", "flat"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_bundle_walk_matches_jax(setup, any_hit, octants):
    """Kernel A's bundle walk (each tile's live rays packed into warps that
    walk its whole row) in its plain twin, through bundle_query, against
    the JAX bundle_query on a wave with an all-dead block and a block of
    one live ray: is_hit equal (any-hit), prim ids under the hit rule
    (nearest)."""
    s = setup
    wave = _split_wave(s)
    kw = dict(any_hit=any_hit, block_rays=BLOCK, dir_octants=octants)
    S = traster.bundle_stage(s["tinter"].clusters, *(_t(x) for x in wave),
                             BLOCK, 4096, dir_octants=octants)
    assert int(S["cnt_b"][1]) == 0 < int(S["cnt_b"][2])
    jt, js, _, _, jok = jraster.bundle_query(
        s["jinter"].clusters, *(jnp.asarray(x) for x in wave), **kw)
    tt, ts, _, _, tok = traster.bundle_query(
        s["tinter"].clusters, *(_t(x) for x in wave), **kw)
    assert bool(jok) and tok
    pi = s["tinter"].clusters.prim_index
    pj, pt = _prims(pi, js), _prims(pi, ts.numpy())
    if any_hit:
        np.testing.assert_array_equal(pt >= 0, pj >= 0)
    else:
        assert hit_mismatches(_t(pt), tt, _t(pj), _t(jt)) == 0
    assert (pt[BLOCK:2 * BLOCK] == -1).all()
    assert 0 < (pt >= 0).sum()


@pytest.mark.parametrize("octants", [True, False], ids=["octants", "flat"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_bundle_walk_against_sequential(setup, any_hit, octants):
    """The bundle walk against the sequential warp walk (every 32
    consecutive rays of a tile walk its whole row) on the same schedule:
    any-hit is_hit and slot equal, nearest under the hit rule; against the
    per-ray gate's walk bit for bit (t, slot, u, v); dead rays answer
    t_max, slot -1, u = v = 0; Woop tests only for packed warps, and no
    more in all than the sequential walk's rows x 32."""
    s = setup
    wave = _split_wave(s)
    S = traster.bundle_stage(s["tinter"].clusters, *(_t(x) for x in wave),
                             BLOCK, 4096, dir_octants=octants)
    inp = traster.schedule_inputs(s["tinter"].clusters, S, S["nb"])
    new = ttr._bundle_plain(inp, BLOCK, any_hit)
    old = ttr._raster_plain(inp, BLOCK, any_hit, None)
    per_ray = ttr._raster_plain(inp, BLOCK, any_hit, None, 1)
    for a, b in zip(new[:4], per_ray[:4]):
        assert same_bits(a, b)
    if any_hit:
        assert torch.equal(new[1], old[1])
    else:
        pi = s["tinter"].clusters.prim_index
        assert hit_mismatches(_t(_prims(pi, new[1].reshape(-1))),
                              new[0].reshape(-1),
                              _t(_prims(pi, old[1].reshape(-1))),
                              old[0].reshape(-1)) == 0
    rays = inp["rays_t_ext"][:, :S["nb"] * BLOCK]
    dead = ~(rays[7] > rays[6])
    assert same_bits(new[0].reshape(-1)[dead], rays[7][dead])
    assert bool((new[1].reshape(-1)[dead] == -1).all())
    assert not bool(new[2].reshape(-1)[dead].any())
    live = (~dead).reshape(S["nb"], BLOCK).sum(1)
    packed = (live + 31) // 32
    k = torch.arange(BLOCK // 32)
    assert bool((new[4].reshape(S["nb"], -1)[k >= packed[:, None]] == 0)
                .all())
    assert 0 < int(new[4].sum()) <= 32 * int(old[4].sum())


@pytest.mark.parametrize("w", [64, 128])
@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_bundle_walk_copies(setup, any_hit, w):
    """The copies schedule (tests/bundle_cases.py: rows of four identical
    copies of the windows, every hit a tie at equal t; dead, one-live, NaN
    and pair-less tiles): the earliest copy wins, the dead rays answer
    t_max, and the walk equals the sequential one (t, slot, u, v)."""
    s = setup
    inp = copies_schedule(s["tinter"].clusters, *(_t(x) for x in _wave(s)),
                          w)
    new = ttr._bundle_plain(inp, w, any_hit)
    check_copies(inp, new, w)
    old = ttr._raster_plain(inp, w, any_hit, None)
    for a, b in zip(new[:4], old[:4]):
        assert same_bits(a, b)


@pytest.mark.parametrize("w", [2048, 1056, 48])
def test_bundle_walk_refuses_wide_tiles(setup, w):
    """The bundle walk takes tiles of a multiple of 32 rays up to 1024 on
    either device (the kernel stages at most 1024 rays a tile): the CPU
    path refuses any other width as the card's does, before any walk."""
    inp = copies_schedule(setup["tinter"].clusters,
                          *(_t(x) for x in _wave(setup)), 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        ttr.raster_cluster_call(**inp, w=w, common=None)


def test_intersect_bundled_matches_intersect(setup):
    """intersect_bundled (spheres merged) against the sorted marcher and
    the JAX intersect_bundled, and its occlusion against any_hit."""
    s = setup
    wave = [_t(x) for x in _wave(s)]
    got = s["tinter"].intersect_bundled(s["tscene"], wave[0], wave[1],
                                        t_min=wave[2], t_max=wave[3],
                                        block_rays=BLOCK)
    ref = s["tinter"].intersect(s["tscene"], *wave)
    jh = s["jinter"].intersect_bundled(
        s["jscene"], *(jnp.asarray(x) for x in _wave(s)), block_rays=BLOCK)

    def key(h):
        return torch.where(h.is_hit, h.prim_type * 2 ** 20 + h.prim_id, -1)

    assert hit_mismatches(key(got), got.t, key(ref), ref.t) == 0
    jk = np.where(np.asarray(jh.t) < 1e15, np.asarray(jh.prim_type) * 2 ** 20
                  + np.asarray(jh.prim_id), -1)
    assert hit_mismatches(key(got), got.t, _t(jk), _t(jh.t)) == 0
    assert (got.prim_type == 2).any()     # the analytic sphere occludes too
    occ = s["tinter"].intersect_bundled(s["tscene"], wave[0], wave[1],
                                        t_min=wave[2], t_max=wave[3],
                                        any_hit=True, block_rays=BLOCK)
    assert torch.equal(occ.is_hit, s["tinter"].any_hit(s["tscene"], *wave))


def test_bundle_overflow_takes_the_marcher(setup):
    """A capacity below the pair count overflows on both sides (ok False)
    and intersect_bundled then answers with the incoherent marcher."""
    s = setup
    wave = [_t(x) for x in _wave(s)]
    *_, jok = jraster.bundle_query(s["jinter"].clusters,
                                   *(jnp.asarray(x) for x in _wave(s)),
                                   block_rays=BLOCK, pc_max=8)
    *_, tok = traster.bundle_query(s["tinter"].clusters, *wave,
                                   block_rays=BLOCK, pc_max=8)
    assert not bool(jok) and not tok
    got = s["tinter"].intersect_bundled(s["tscene"], wave[0], wave[1],
                                        t_min=wave[2], t_max=wave[3],
                                        block_rays=BLOCK, pc_max=8)
    ref = s["tinter"].for_incoherent().intersect(s["tscene"], *wave)
    for a, b in zip((got.t, got.prim_id, got.prim_type),
                    (ref.t, ref.prim_id, ref.prim_type)):
        assert torch.equal(a, b)


def test_capacity_and_measure_match_jax(setup):
    """default_bundle_pc_max and measure_pair_count(rset=None) give the
    JAX package's numbers below the TPU's SMEM cap on the schedule
    (131,072 pairs), which the port drops: config 5's 2,040 blocks get
    the uncapped heuristic."""
    s = setup
    for nb, c, g in ((4, 17, 1), (500, 430, 1), (300, 3368, 2)):
        assert (traster.default_bundle_pc_max(nb, c, g)
                == jraster.default_bundle_pc_max(nb, c, g))
    assert traster.default_bundle_pc_max(2040, 430) == 198656
    jn = jraster.measure_pair_count(None, s["jinter"].clusters,
                                    *(jnp.asarray(x) for x in _wave(s)),
                                    block_rays=BLOCK)
    tn = traster.measure_pair_count(None, s["tinter"].clusters,
                                    *(_t(x) for x in _wave(s)),
                                    block_rays=BLOCK)
    assert tn == jn > 0


def test_tiled_bundle_intersect(setup, monkeypatch):
    """make_tiled_bundle_intersect re-views a (row, col) wave in tile
    order, answers through the bundle engine and returns the caller's
    order: its any_hit equals the marcher's on every ray."""
    s = setup
    layout = traster.camera_tile_layout(s["tinter"], convert.camera(
        convert.state_arrays(s["cam"]), device="cpu"), 1, H, W)
    assert layout == (1, H, W, 32, 32)
    fn = traster.make_tiled_bundle_intersect(s["tinter"], *layout)
    wave = [_t(x) for x in _wave(s)]
    log = log_bundle_waves(monkeypatch)
    occ = fn.any_hit(s["tscene"], wave[0], wave[1], t_min=wave[2],
                     t_max=wave[3])
    assert len(log) == 1 and 0 < log[0][0] <= log[0][1]
    assert torch.equal(occ, s["tinter"].any_hit(s["tscene"], *wave))
    hit = fn(s["tscene"], wave[0], wave[1], t_min=wave[2], t_max=wave[3])
    ref = s["tinter"].intersect(s["tscene"], *wave)

    def key(h):
        return torch.where(h.is_hit, h.prim_type * 2 ** 20 + h.prim_id, -1)

    assert hit_mismatches(key(hit), hit.t, key(ref), ref.t) == 0


def test_tiled_bundle_intersect_leaves_no_cycle(setup):
    """The callable and its ``any_hit`` hold the intersector through no
    reference cycle: once dropped they are freed at once, with the
    garbage collector off (a cycle would keep each frame's refit
    intersector on the device until the collector's next full pass)."""
    import gc

    fn = traster.make_tiled_bundle_intersect(setup["tinter"], 1, H, W, 32,
                                             32)
    any_hit = fn.any_hit
    gc.collect()
    gc.disable()
    try:
        del fn, any_hit
        assert gc.collect() == 0
    finally:
        gc.enable()
