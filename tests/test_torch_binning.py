"""The raster binning's plain versions (kernels S, T and U,
``ops/kernels/binning``) against the JAX package's binning on the same
inputs, exactly: the window rects, the ray pack, the block bounds, the
pair counts and the depth-sorted schedule of the projective stage
(modes "origin", "target" and "ortho" at g = 1, 2, 4), of the TLAS pair
stage and of the bundle stage (with and without direction octants),
T's hit mask (the overlap matrix as bits) and U's schedule from it;
the stages run S's projection basis (``bin_basis_plain``, through the
dispatcher ``bin_rects``), which is held to the JAX package's within 4
ulps per component (its sums round in XLA's order, its norms and cross
products by XLA's kernels), and on its own: the fallback axis at a point
on the centroid and for all-NaN geometry, the same bits at every call and
on a band of the wave, and its fixed halving tree against the order in
which kernel S adds (``test_centroid_tree_order``).
Cases: a dead block, NaN-padded windows and sub boxes, NaN pair boxes,
keys -0.0 and +0.0 in one row (they tie, in window order), a block that
pairs every window, an overflowed capacity (the straddling row keeps its
lowest windows; the tail is (nb - 1, C - 1, invalid)).  Tolerance: none,
every array equal (NaN equal to NaN), but for projected coordinates (the
rects and block bounds of the projective and TLAS stages), which XLA's
CPU dot products round otherwise, by an ulp or two (rtol and atol 1e-6;
the bundle boxes, not projected, are exact).  The kernels are held to
these plain versions bit for bit on the card
(tests/test_torch_cuda.py); the early exit of the kernels' bundle test is
held here to the margins it bounds (``test_early_exit_bounds``)."""

import warnings
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
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
from optix_ray_tracer_tpu_torch.ops.kernels import binning

torch.set_num_threads(2)

W = 64                 # rays a block
EYE = (3.0, 0.5, 1.0)
LIGHT = (0.2, -0.3, 2.5)
SUN = (0.3, 0.2, 0.9)
GROUP_VERTS = 24


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(got, ref):
    """Equal arrays, NaN equal to NaN, -0.0 equal to +0.0."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _close(got, ref):
    """Projected coordinates against the JAX package's: XLA's CPU dot
    product (``q @ u``) rounds a projection otherwise than torch's three
    products and two sums, by an ulp or two (the binning's margins, 1e-5
    relative, absorb it); NaN where the JAX package has NaN."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    """A 2,000-triangle sphere over a floor that reaches behind the eye
    (8 clusters, the last padded: NaN windows at g = 2 and 4), and three
    512-ray waves in 64-ray blocks, each with block 1 dead and every
    11th ray dead: a camera wave ("origin" at EYE), segments toward
    LIGHT ("target") and a sun wave ("ortho")."""
    v, n = sphere_with_n_triangles(2000)
    fv, fn = quad([-3, -3, -1.2], [3, -3, -1.2], [3, 3, -1.2], [-3, 3, -1.2])
    jscene = JScene(spheres=JSpheres.empty(), triangles=JTriangles.from_arrays(
        np.concatenate([v, fv]), np.concatenate([n, fn])))
    jinter = jmarch.make_march_intersector(jscene, raster=True)
    tscene = convert.scene(convert.state_arrays(jscene), device="cpu")
    tinter = convert.march_intersector(
        convert.state_arrays(jinter.clusters), tscene, raster=True,
        device="cpu")
    cam = JCamera.look_at(EYE, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = (np.asarray(x).reshape(-1, 3) for x in cam.generate_rays(32, 16))
    n_rays = o.shape[0]
    dead = np.zeros(n_rays, bool)
    dead[W:2 * W] = True
    dead[::11] = True
    tmin = np.full(n_rays, 1e-3, np.float32)
    h = tinter.intersect(tscene, _t(o), _t(d))
    p = torch.where(h.is_hit[:, None], _t(o) + h.t[:, None] * _t(d),
                    _t(o)).numpy()
    to_l = np.asarray(LIGHT, np.float32) - p
    dist = np.linalg.norm(to_l, axis=-1).astype(np.float32)
    wl = (to_l / dist[:, None]).astype(np.float32)
    sun = np.asarray(SUN, np.float32) / np.linalg.norm(SUN).astype(np.float32)
    waves = {
        "origin": (o, d, tmin, np.where(dead, 0.0, 1e16).astype(np.float32),
                   o[0]),
        "target": ((p + wl * 1e-3).astype(np.float32), wl, tmin,
                   np.where(dead, 0.0, dist - 1e-3).astype(np.float32),
                   np.asarray(LIGHT, np.float32)),
        "ortho": ((p + sun * 1e-3).astype(np.float32),
                  np.broadcast_to(sun, p.shape).copy(), tmin,
                  np.where(dead, 0.0, 1e16).astype(np.float32), None),
    }
    return dict(jinter=jinter, tinter=tinter, waves=waves)


def _jax_captured(monkeypatch, run):
    """Run a JAX stage with its basis, block rects and overlap matrix
    recorded: (its output, {"basis", "blocks", "ov", "key"})."""
    seen = {}
    basis_from, block_rects, enum = (jraster._basis_from, jraster._block_rects,
                                     jraster._enumerate_sorted_pairs)

    def b_from(wvec):
        seen["basis"] = basis_from(wvec)
        return seen["basis"]

    def b_rects(*a):
        seen["blocks"] = block_rects(*a)
        return seen["blocks"]

    def e_pairs(ov, key, *a):
        seen["ov"], seen["key"] = ov, key
        return enum(ov, key, *a)

    monkeypatch.setattr(jraster, "_basis_from", b_from)
    monkeypatch.setattr(jraster, "_block_rects", b_rects)
    monkeypatch.setattr(jraster, "_enumerate_sorted_pairs", e_pairs)
    monkeypatch.setattr(jri, "_basis_from", b_from)
    monkeypatch.setattr(jri, "_block_rects", b_rects)
    monkeypatch.setattr(jri, "_enumerate_sorted_pairs", e_pairs)
    return run(), seen


def _jax_window_rects(verts, basis, point, g):
    """The JAX package's window rects (optix_ray_tracer_tpu/ops/raster.py
    ``_coarse_stage``, its 8-triangle group steps) on its basis."""
    q = verts.reshape(-1, 3)
    persp = point is not None
    if persp:
        q = q - jnp.asarray(point)
    vx, vy, vw, vgood = jraster._proj(q, basis, persp)
    behind = ~vgood & ~jnp.isnan(vx)
    n_g = q.shape[0] // GROUP_VERTS
    vxm = jnp.where(vgood, vx, jnp.nan).reshape(n_g, GROUP_VERTS)
    vym = jnp.where(vgood, vy, jnp.nan).reshape(n_g, GROUP_VERTS)
    vzm = vw.reshape(n_g, GROUP_VERTS)
    lo_hi = []
    for m in (vxm, vym, vzm):
        lo, hi = jnp.nanmin(m, axis=1), jnp.nanmax(m, axis=1)
        mg = 1e-5 * (jnp.abs(lo) + jnp.abs(hi)) + 1e-6
        lo_hi += [lo - mg, hi + mg]
    G = 32 // g
    C = n_g // G
    rects = [(jnp.nanmin if k % 2 == 0 else jnp.nanmax)(
        x.reshape(C, G), axis=1) for k, x in enumerate(lo_hi)]
    return np.stack(rects), np.asarray(
        jnp.any(behind.reshape(C, G * GROUP_VERTS), axis=1))


def _hold_mask(mask, ov):
    """T's hit mask holds the JAX package's overlap matrix ``ov`` as bits:
    bit c % 32 of word c // 32 of a row is (block, window c); the words
    past the last window are 0; a dead block's row is all 0."""
    ov = np.array(ov)
    nb, C = ov.shape
    mask = np.asarray(mask)
    assert mask.dtype == np.int32 and mask.shape == (nb, -(-C // 32))
    bits = (mask.view(np.uint32)[..., None] >> np.arange(32, dtype=np.uint32)
            ) & 1
    _eq(bits.reshape(nb, -1)[:, :C] != 0, ov)
    assert not bits.reshape(nb, -1)[:, C:].any()
    _eq(binning.unpack_mask(torch.as_tensor(mask), C), ov)
    _eq(binning.pack_mask(torch.as_tensor(ov)), mask)


def _hold_schedule(ts, js):
    """The port's stage output ``ts`` equals the JAX one's ``js``: the
    counts, the schedule and the padded wave (the ray pack's rows)."""
    assert int(ts["pc_total"]) == int(js["pc_total"])
    _eq(ts["cnt_b"], js["cnt_b"])
    for k in ("b_i", "c_i", "validc"):
        _eq(ts[k], js[k])
    for k in ("o_p", "d_p", "tmin_p", "tmax_p"):
        _eq(ts[k], js[k])
    rays = ts["rays_t_ext"]
    _eq(rays, np.concatenate([np.asarray(js["o_p"]).T,
                              np.asarray(js["d_p"]).T,
                              np.asarray(js["tmin_p"])[None],
                              np.asarray(js["tmax_p"])[None]]))
    nb = ts["nb"]
    _eq(ts["pair_tiles"], np.where(np.asarray(js["validc"]),
                                   np.asarray(js["b_i"]), nb))
    _eq(ts["pair_clusters"], np.where(np.asarray(js["validc"]),
                                      np.asarray(js["c_i"]), 0))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("mode", ["origin", "target", "ortho"])
def test_projective_stage_equals_jax(setup, monkeypatch, mode, g):
    """``_coarse_stage`` on S, T and U's plain versions equals the JAX
    package's: the schedule, the counts (the dead block pairs nothing)
    and the ray pack; on the JAX package's projection basis, the window
    rects (x, y, depth and the full-plane flag, NaN windows included),
    the block bounds and the overlap matrix."""
    jinter, tinter = setup["jinter"], setup["tinter"]
    o, d, tmin, tmax, point = setup["waves"][mode]
    pc_max = 4096
    js, seen = _jax_captured(monkeypatch, lambda: jraster._coarse_stage(
        jinter.raster, jinter.clusters, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), mode,
        None if point is None else jnp.asarray(point), W, pc_max, g))
    p = None if point is None else _t(point)
    ts = traster._coarse_stage(tinter.raster, tinter.clusters, _t(o), _t(d),
                               _t(tmin), _t(tmax), mode, p, W, pc_max, g)
    _hold_schedule(ts, js)
    assert int(ts["cnt_b"][1]) == 0 and int(js["pc_total"]) > 0
    # S and T on the JAX package's basis (the port's basis, torch's cross
    # products, may differ from it in the last bit; the margins absorb
    # that, and the schedules above are equal)
    tb = _t(np.stack(seen["basis"]))
    rects, cfull = binning.bin_rects_plain(binning.RECTS_CLUSTER,
                                           tinter.raster.verts, basis=tb,
                                           point=p, granularity=g)
    jrects, jfull = _jax_window_rects(jinter.raster.verts, seen["basis"],
                                      point, g)
    _close(rects, jrects)
    _eq(cfull, jfull)
    _close(rects[4], seen["key"])
    if g > 1:
        assert bool(torch.isnan(rects[0]).any())
    # T: the ray pack, the block bounds and the counts
    rays, cnt_b, offs, bounds, mask = binning.bin_count_plain(
        _t(o), _t(d), _t(tmin), _t(tmax), W, mode, rects, cfull, tb, p)
    _eq(rays, ts["rays_t_ext"])
    _close(bounds[:, :6].T, np.stack(seen["blocks"][:6]))
    _eq(bounds[:, 6] != 0, seen["blocks"][6])
    _eq(cnt_b, js["cnt_b"])
    _eq(offs, np.r_[0, np.cumsum(np.asarray(js["cnt_b"]))])
    ov, key = binning._overlap(mode, rects, cfull, bounds)
    _eq(ov, seen["ov"])
    _hold_mask(mask, seen["ov"])


@pytest.mark.parametrize("mode", ["origin", "target", "ortho"])
def test_instanced_stage_equals_jax(setup, monkeypatch, mode):
    """``instanced_coarse_stage`` equals the JAX package's on 40 random
    world boxes, two of them NaN (invalid instances): the pair rects
    (``_pair_rects``), the schedule and the ray pack; with the pairs'
    tables, pair_libs and pair_insts are the tables at pair_clusters."""
    o, d, tmin, tmax, point = setup["waves"][mode]
    r = np.random.default_rng(4)
    lo = r.uniform(-1.5, 1.0, (40, 3)).astype(np.float32)
    hi = (lo + r.uniform(0.05, 0.6, (40, 3))).astype(np.float32)
    lo[[7, 23]] = np.nan
    hi[[7, 23]] = np.nan
    pc_max = 2048
    jp = None if point is None else jnp.asarray(point)
    js, seen = _jax_captured(monkeypatch, lambda: jri.instanced_coarse_stage(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), mode, jp, W, pc_max))
    # T's mask on the JAX package's basis: its overlap matrix
    tb = _t(np.stack(seen["basis"]))
    tp = None if point is None else _t(point)
    prects, pfull = binning.bin_rects_plain(binning.RECTS_PAIR, _t(lo),
                                            _t(hi), tb, tp)
    _hold_mask(binning.bin_count_plain(_t(o), _t(d), _t(tmin), _t(tmax), W,
                                       mode, prects, pfull, tb, tp)[4],
               seen["ov"])
    shape = torch.as_tensor(r.integers(0, 3, 40).astype(np.int32))
    inst = torch.arange(40, dtype=torch.int32) // 2
    ts = tri.instanced_coarse_stage(_t(lo), _t(hi), _t(o), _t(d), _t(tmin),
                                    _t(tmax), mode, tp, W, pc_max, shape,
                                    inst)
    _hold_schedule(ts, js)
    assert int(js["pc_total"]) > 0
    ids = ts["pair_clusters"].long()
    _eq(ts["pair_libs"], shape[ids])
    _eq(ts["pair_insts"], inst[ids])
    jrect = jri._pair_rects(jnp.asarray(lo), jnp.asarray(hi), seen["basis"],
                            point is not None, jp)
    rects, cfull = binning.bin_rects_plain(
        binning.RECTS_PAIR, _t(lo), _t(hi), _t(np.stack(seen["basis"])), tp)
    _close(rects, np.stack(jrect[:6]))
    _eq(cfull, jrect[6])
    assert bool(torch.isnan(rects[:, 7]).all())


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("octants", [True, False], ids=["octants", "flat"])
def test_bundle_stage_equals_jax(setup, monkeypatch, octants, g):
    """``bundle_stage`` equals the JAX package's on the "target" wave
    (block 1 dead; NaN sub boxes at g = 2): counts, schedule, ray pack,
    T's mask (the JAX overlap matrix); S's margined boxes are the sub
    boxes' union."""
    jinter, tinter = setup["jinter"], setup["tinter"]
    o, d, tmin, tmax, _ = setup["waves"]["target"]
    pc_max = 2048
    js, seen = _jax_captured(monkeypatch, lambda: jraster.bundle_stage(
        jinter.clusters, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), W, pc_max, dir_octants=octants, granularity=g))
    ts = traster.bundle_stage(tinter.clusters, _t(o), _t(d), _t(tmin),
                              _t(tmax), W, pc_max, dir_octants=octants,
                              granularity=g)
    _hold_schedule(ts, js)
    assert int(ts["cnt_b"][1]) == 0 and int(js["pc_total"]) > 0
    rects, _ = binning.bin_rects_plain(binning.RECTS_BOX,
                                       tinter.clusters.sub_min,
                                       tinter.clusters.sub_max,
                                       granularity=g)
    sm = np.asarray(jinter.clusters.sub_min).reshape(rects.shape[1], -1, 3)
    sx = np.asarray(jinter.clusters.sub_max).reshape(rects.shape[1], -1, 3)
    assert np.isnan(sm).all(axis=(1, 2)).any() == (g == 2)
    with warnings.catch_warnings():      # all-NaN windows give NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        clo = np.nanmin(sm, axis=1)
        chi = np.nanmax(sx, axis=1)
    m = np.float32(1e-5) * (np.abs(clo) + np.abs(chi)) + np.float32(1e-6)
    _eq(rects[0::2].T, clo - m)
    _eq(rects[1::2].T, chi + m)
    mask = binning.bin_count_plain(_t(o), _t(d), _t(tmin), _t(tmax), W,
                                   "bundle", rects, dir_octants=octants)[4]
    _hold_mask(mask, seen["ov"])
    assert not bool(mask[1].any())


@pytest.mark.parametrize("per_block", [False, True],
                         ids=["window_keys", "pair_keys"])
def test_signed_zero_keys_tie(per_block):
    """Keys -0.0 and +0.0 in one row tie and keep ascending window ids, in
    the JAX package's sort and in U's plain version (from T's mask), with
    per-window (projective) and per-pair (bundle) keys; row 1 pairs
    nothing."""
    ov = np.array([[1, 1, 1, 1, 1, 0],
                   [0, 0, 0, 0, 0, 0],
                   [1, 0, 1, 1, 0, 1]], bool)
    keys = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -2.0], np.float32)
    if per_block:
        keys = np.stack([keys, keys[::-1], -keys])
    j = jraster._enumerate_sorted_pairs(jnp.asarray(ov), jnp.asarray(keys), 3,
                                        6, 12)
    t = binning._enumerate_sorted_pairs(_t(ov), _t(keys), 3, 6, 12)
    for a, b in zip(t, j[:3]):
        _eq(a, b)
    if not per_block:
        _eq(t[1][:5], [0, 1, 3, 4, 2])
    # the same row through U's plain version: rects whose near depth is
    # the key, bounds that admit every window of row 0
    rects = torch.stack([torch.full((6,), -1.0), torch.full((6,), 1.0),
                         torch.full((6,), -1.0), torch.full((6,), 1.0),
                         _t(keys if not per_block else keys[0]),
                         torch.full((6,), 5.0)])
    bounds = torch.tensor([[-0.5, 0.5, -0.5, 0.5, -3.0, 3.0, 1.0, 0.0],
                           [-0.5, 0.5, -0.5, 0.5, -3.0, 3.0, 0.0, 0.0]])
    cfull = torch.zeros(6, dtype=torch.bool)
    mask = binning.pack_mask(binning._overlap("origin", rects, cfull,
                                              bounds)[0])
    _eq(mask, [[0b111111], [0]])
    S = binning.bin_emit_plain(rects, bounds, None, None, mask, 9, "origin")
    _eq(S["c_i"][:6], [5, 0, 1, 3, 4, 2])
    _eq(S["b_i"][6:], [1, 1, 1])
    _eq(S["c_i"][6:], [5, 5, 5])


def test_block_pairing_every_window(setup, monkeypatch):
    """One 512-ray block (the whole camera wave) pairs every window but
    the NaN ones, as in the JAX package."""
    jinter, tinter = setup["jinter"], setup["tinter"]
    o, d, tmin, _, point = setup["waves"]["origin"]
    tmax = np.full(o.shape[0], 1e16, np.float32)
    n = o.shape[0]
    js = jraster._coarse_stage(
        jinter.raster, jinter.clusters, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), "origin", jnp.asarray(point), n,
        4096, 4)
    ts = traster._coarse_stage(tinter.raster, tinter.clusters, _t(o), _t(d),
                               _t(tmin), _t(tmax), "origin", _t(point), n,
                               4096, 4)
    _hold_schedule(ts, js)
    C = tinter.clusters.num_clusters * 4
    # windows with no vertex (padding): NaN depth on any basis
    empty = torch.isnan(binning.bin_rects_plain(
        binning.RECTS_CLUSTER, tinter.raster.verts, basis=torch.eye(3),
        point=_t(point), granularity=4)[0][4])
    assert 0 < int(empty.sum()) < C
    assert int(ts["cnt_b"][0]) == C - int(empty.sum())
    # the row holds each other window once
    _eq(torch.sort(ts["c_i"][:C - int(empty.sum())]).values,
        torch.nonzero(~empty)[:, 0])


@pytest.mark.parametrize("stage", ["projective", "bundle", "bundle_flat"])
def test_overflow_cut_and_tail(setup, stage):
    """A capacity below the pair count: the first pc_max pairs in (block,
    window) order, each block's sorted, as the JAX package cuts them (the
    straddling row keeps its lowest windows); a capacity above it: the
    slots past the total hold (nb - 1, C - 1, invalid), tile nb, window
    0.  Bundles with and without direction octants."""
    jinter, tinter = setup["jinter"], setup["tinter"]
    o, d, tmin, tmax, point = setup["waves"]["target"]

    def run(pc_max):
        if stage != "projective":
            octants = stage == "bundle"
            return (jraster.bundle_stage(
                jinter.clusters, jnp.asarray(o), jnp.asarray(d),
                jnp.asarray(tmin), jnp.asarray(tmax), W, pc_max,
                dir_octants=octants),
                traster.bundle_stage(tinter.clusters, _t(o), _t(d),
                                     _t(tmin), _t(tmax), W, pc_max,
                                     dir_octants=octants))
        return (jraster._coarse_stage(
            jinter.raster, jinter.clusters, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax), "target",
            jnp.asarray(point), W, pc_max, 2),
            traster._coarse_stage(tinter.raster, tinter.clusters, _t(o),
                                  _t(d), _t(tmin), _t(tmax), "target",
                                  _t(point), W, pc_max, 2))

    js, ts = run(8)
    total = int(ts["pc_total"])
    cnt = ts["cnt_b"].long()
    offs = torch.cumsum(cnt, 0) - cnt
    row = int(torch.nonzero((offs < total // 2)
                            & (offs + cnt > total // 2))[0])
    cut = total // 2
    js, ts = run(cut)
    _hold_schedule(ts, js)
    assert bool(ts["validc"].all()) and int(ts["pc_total"]) == total
    keep = cut - int(offs[row])
    assert 0 < keep < int(cnt[row])
    assert bool((ts["b_i"][int(offs[row]):] == row).all())
    _, full = run(total)
    lowest = full["c_i"][int(offs[row]):int(offs[row]) + int(cnt[row])]
    _eq(torch.sort(ts["c_i"][int(offs[row]):]).values,
        torch.sort(lowest).values[:keep])
    js, ts = run(total + 37)
    _hold_schedule(ts, js)
    nb = ts["nb"]
    C = tinter.clusters.num_clusters * (1 if stage != "projective" else 2)
    _eq(ts["b_i"][total:], np.full(37, nb - 1))
    _eq(ts["c_i"][total:], np.full(37, C - 1))
    assert not bool(ts["validc"][total:].any())
    _eq(ts["pair_tiles"][total:], np.full(37, nb))
    _eq(ts["pair_clusters"][total:], np.zeros(37))


# ---- the early exit of the kernels' bundle test ----------------------------

#: csrc/binning.cu kSlackRel, kSlackAbs
SLACK_REL, SLACK_ABS = np.float32(1.00001e-6), np.float32(1.00001e-8)


def _margined(x, sign):
    """The bundle test's margins as the plain version and the kernels
    round them (each step in float32): x - (|x| 1e-6 + 1e-8) for sign -1,
    x + (..) for +1."""
    x = np.asarray(x, np.float32)
    m = np.abs(x) * np.float32(1e-6) + np.float32(1e-8)
    return x - m if sign < 0 else x + m


def _round32(q, up: bool) -> np.float32:
    """The exact rational q rounded to float32 toward +inf (up) or -inf."""
    r = np.float32(float(q))
    step = np.float32(np.inf if up else -np.inf)
    back = np.float32(-np.inf if up else np.inf)

    def past(v):
        return Fraction(float(v)) >= q if up else Fraction(float(v)) <= q

    while not past(r):
        r = np.nextafter(r, step)
    while past(np.nextafter(r, back)):
        r = np.nextafter(r, back)
    return r


def _exit_bound(x, sign) -> np.float32:
    """The kernels' exit_floor (sign -1) or exit_ceil (+1) of a finite
    float32 x, each operation rounded as its intrinsic rounds it (__fmul_ru,
    __fadd_ru, then __fsub_rd or __fadd_ru)."""
    fx = Fraction(float(x))
    slack = _round32(_round32(abs(fx) * Fraction(float(SLACK_REL)), True)
                     + Fraction(float(SLACK_ABS)), True)
    return (_round32(fx - Fraction(float(slack)), False) if sign < 0 else
            _round32(fx + Fraction(float(slack)), True))


def _exit_samples(kind):
    r = np.random.default_rng(17)
    if kind == "margin_steps":
        # the float32 margin is not monotone: around 4.44e-10 a larger x
        # gets a smaller x - m(x) (the rounded 1e-6 |x| carries 1e-8 to
        # its next float)
        x = np.float32(4.4408918e-10)
        lo = x.view(np.int32) - 20_000
        xs = np.arange(lo, lo + 40_000, dtype=np.int32).view(np.float32)
        f = _margined(xs, -1)
        assert (f[1:] < f[:-1]).any()
        assert _margined(np.nextafter(x, np.float32(1)), -1) < _margined(x, -1)
        pick = np.nonzero(f[1:] < f[:-1])[0]
        return np.concatenate([xs[pick], xs[pick + 1], -xs[pick],
                               xs[::400]])
    if kind == "specials":
        tiny = np.float32(1e-45)
        return np.array([0.0, -0.0, tiny, -tiny, 1e-38, -1e-38, 1e-8, -1e-8,
                         1.0, -1.0, 1e16, -1e16, 3e38, -3e38], np.float32)
    mag = 10.0 ** r.uniform(-44, 38, 300)
    return (mag * r.choice([-1.0, 1.0], 300)).astype(np.float32)


@pytest.mark.parametrize("kind", ["margin_steps", "specials", "wide"])
def test_early_exit_bounds(kind):
    """The kernels' bundle test leaves its axis loop once
    max(exit_floor(lo_t), t_lo) > min(exit_ceil(hi_t), t_hi)
    (csrc/binning.cu, octant_admits): that is sound when every later
    lo_t' >= lo_t has margined lo_t' >= exit_floor(lo_t), and every later
    hi_t' <= hi_t has margined hi_t' <= exit_ceil(hi_t), though the float
    margins are not monotone.  Exact rational arithmetic for the bounds'
    directed roundings; later values a few ulps and up to 2x away, of
    either sign; infinities as IEEE gives them (exit_floor(+inf) and
    exit_ceil(-inf) are NaN, so the exit takes them, as the final test
    fails on them)."""
    up = np.float32(np.inf)
    for x in _exit_samples(kind):
        with np.errstate(over="ignore"):
            ys = [x, np.nextafter(x, up),
                  np.nextafter(np.nextafter(x, up), up),
                  np.float32(x + abs(x) * np.float32(0.5)),
                  np.float32(x + abs(x)), np.float32(x + np.float32(1e-9))]
        later_lo = np.array([y for y in ys if np.isfinite(y) and y >= x],
                            np.float32)
        assert (_margined(later_lo, -1) >= _exit_bound(x, -1)).all(), x
        later_hi = -later_lo
        assert (_margined(later_hi, 1) <= _exit_bound(-x, 1)).all(), x
    with np.errstate(invalid="ignore", over="ignore"):
        inf = np.float32(np.inf)
        slack = np.abs(inf) * SLACK_REL + SLACK_ABS
        assert np.isnan(inf - slack) and np.isnan(_margined(inf, -1))
        assert np.isnan(-inf + slack) and np.isnan(_margined(-inf, 1))
        assert -inf - slack == -inf and inf + slack == inf


# ---- S's projection basis ----------------------------------------------------

#: the basis's tolerance against the JAX package's, in float32 ulps per
#: component
BASIS_ULPS = 4


def _ulps(got, ref):
    """Per-element distance in float32 ulps (-0.0 and +0.0 the same)."""
    def ordered(x):
        i = np.asarray(x, np.float32).reshape(-1).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(got) - ordered(ref))


def _frame_np(w):
    """The JAX package's basis for an axis w (``ops/raster._basis_from``)."""
    return np.stack(jraster._basis_from(jnp.asarray(w, jnp.float32)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("mode", ["origin", "target", "ortho"])
def test_basis_equals_jax(setup, monkeypatch, mode, g):
    """S's basis (``bin_basis_plain`` on the RasterSet's vertices) within
    BASIS_ULPS of the basis the JAX package's ``_coarse_stage`` bins on,
    in the three projection modes at g 1, 2, 4; the dispatcher returns the
    same bits, and the stage hands them to T."""
    jinter, tinter = setup["jinter"], setup["tinter"]
    o, d, tmin, tmax, point = setup["waves"][mode]
    _, seen = _jax_captured(monkeypatch, lambda: jraster._coarse_stage(
        jinter.raster, jinter.clusters, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), mode,
        None if point is None else jnp.asarray(point), W, 4096, g))
    p = None if point is None else _t(point)
    basis = binning.bin_basis_plain(binning.RECTS_CLUSTER, tinter.raster.verts,
                                    point=p, d=_t(d))
    assert basis.shape == (3, 3) and basis.dtype == torch.float32
    assert _ulps(basis, np.stack(seen["basis"])).max() <= BASIS_ULPS
    got = binning.bin_rects(binning.RECTS_CLUSTER, tinter.raster.verts,
                            point=p, granularity=g, d=_t(d))
    _eq(_bits(got[2]), _bits(basis))
    handed = []
    real = binning.bin_count
    monkeypatch.setattr(binning, "bin_count", lambda *a: handed.append(a[8])
                        or real(*a))
    traster._coarse_stage(tinter.raster, tinter.clusters, _t(o), _t(d),
                          _t(tmin), _t(tmax), mode, p, W, 4096, g)
    _eq(_bits(handed[0]), _bits(basis))


@pytest.mark.parametrize("mode", ["origin", "target", "ortho"])
def test_pair_basis_equals_jax(setup, monkeypatch, mode):
    """S's basis on TLAS pairs (the centroid of the finite pair centers;
    two NaN boxes left out) within BASIS_ULPS of the JAX package's
    ``instanced_coarse_stage``'s."""
    o, d, tmin, tmax, point = setup["waves"][mode]
    r = np.random.default_rng(4)
    lo = r.uniform(-1.5, 1.0, (40, 3)).astype(np.float32)
    hi = (lo + r.uniform(0.05, 0.6, (40, 3))).astype(np.float32)
    lo[[7, 23]] = np.nan
    hi[[7, 23]] = np.nan
    jp = None if point is None else jnp.asarray(point)
    _, seen = _jax_captured(monkeypatch, lambda: jri.instanced_coarse_stage(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax), mode, jp, W, 2048))
    tp = None if point is None else _t(point)
    basis = binning.bin_basis_plain(binning.RECTS_PAIR, _t(lo), _t(hi), tp,
                                    _t(d))
    assert _ulps(basis, np.stack(seen["basis"])).max() <= BASIS_ULPS
    _eq(_bits(binning.bin_rects(binning.RECTS_PAIR, _t(lo), _t(hi), tp,
                                d=_t(d))[2]), _bits(basis))


def _symmetric_rows(n, seed):
    """n points (n = 2^k or 3 2^k) whose halving tree sums to exactly 0:
    rows i and i + n / 2 opposite for n = 2^k; for n = 3 2^k, padded to
    4 2^k, rows [A, C, -C, -A] (A 2^k rows, C 2^(k-1)): the first step
    cancels A, the pad's -0.0 keeps C, -C, the third step cancels them."""
    r = np.random.default_rng(seed)
    if n & (n - 1) == 0:
        x = r.uniform(-3, 3, (n // 2, 3)).astype(np.float32)
        return np.concatenate([x, -x])
    a = r.uniform(-3, 3, (n // 3, 3)).astype(np.float32)
    c = r.uniform(-3, 3, (n // 6, 3)).astype(np.float32)
    return np.concatenate([a, c, -c, -a])


@pytest.mark.parametrize("source", ["cluster", "pair"])
def test_basis_degenerate_point(source):
    """The shared point on the centroid (a camera inside a symmetric
    mesh): the centroid's norm is 0, so the axis falls back to (0, 0, 1)
    (as the JAX package's does), and the windows still bin (finite
    rects)."""
    if source == "cluster":
        # one cluster: 256 triangles, 768 vertex rows
        verts = _t(_symmetric_rows(768, 3).reshape(256, 3, 3))
        args = (binning.RECTS_CLUSTER, verts)
    else:
        # pair centers (lo + hi) 0.5 opposite in rows i and i + 16
        c = _symmetric_rows(32, 5)
        args = (binning.RECTS_PAIR, _t(c - 0.25), _t(c + 0.25))
    q = (args[1].reshape(-1, 3) if len(args) == 2
         else (args[1] + args[2]) * 0.5)
    assert bool((binning._halving_sum(q) == 0).all())
    rects, cfull, basis = binning.bin_rects(*args, point=(0.0, 0.0, 0.0))
    _eq(basis, _frame_np([0.0, 0.0, 1.0]))
    _eq(basis, [[0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    assert bool(torch.isfinite(rects[4:]).all()) and bool(cfull.any())


@pytest.mark.parametrize("source", ["cluster", "pair"])
def test_basis_all_nan_geometry(source):
    """Geometry whose every row is NaN (padding, invalid instances): no
    row is kept, the count clamps to 1, the sum is -0.0 (the tree's
    padding) and the axis falls back to (0, 0, 1); every rect is NaN."""
    if source == "cluster":
        args = (binning.RECTS_CLUSTER, torch.full((256, 3, 3), float("nan")))
    else:
        nan = torch.full((5, 3), float("nan"))
        args = (binning.RECTS_PAIR, nan, nan)
    rects, _, basis = binning.bin_rects(*args, point=(1.0, 2.0, 3.0))
    _eq(basis, _frame_np([0.0, 0.0, 1.0]))
    assert bool(torch.isnan(rects).all())
    rows = torch.full((37, 3), -0.0)
    assert (_bits(binning._halving_sum(rows)) == _bits(-0.0)).all()


@pytest.mark.parametrize("source", ["cluster", "pair"])
def test_basis_repeats_and_bands(setup, monkeypatch, source):
    """The basis is the same bits at every call, and a band of a wave (a
    sharded row band) bins with the whole wave's basis: T gets the same
    bits from both stages."""
    tinter = setup["tinter"]
    o, d, tmin, tmax, point = setup["waves"]["target"]
    r = np.random.default_rng(4)
    lo = _t(r.uniform(-1.5, 1.0, (40, 3)).astype(np.float32))
    hi = lo + _t(r.uniform(0.05, 0.6, (40, 3)).astype(np.float32))
    handed = []
    real = binning.bin_count
    monkeypatch.setattr(binning, "bin_count", lambda *a: handed.append(a[8])
                        or real(*a))
    for rows in (slice(None), slice(3 * W, 5 * W), slice(None)):
        wave = (_t(o[rows]), _t(d[rows]), _t(tmin[rows]), _t(tmax[rows]))
        if source == "cluster":
            traster._coarse_stage(tinter.raster, tinter.clusters, *wave,
                                  "target", _t(point), W, 4096, 2)
        else:
            tri.instanced_coarse_stage(lo, hi, *wave, "target", _t(point), W,
                                       2048)
    assert len(handed) == 3
    for b in handed[1:]:
        _eq(_bits(b), _bits(handed[0]))


def _kernel_order_sum(x, G):
    """The sum of the rows of x (n, 3) float32 in the order kernel S adds
    them with G sum roles (csrc/binning.cu, ``centroid_share`` and
    ``centroid_fold``: kBasisBlock 8, 256 threads): rows padded with
    -0.0 to 256 G 8 B, B the least power of two that holds them; thread
    (warp, lane) of role c takes rows lane + 32 (c + G (warp + 8 m)), m = r
    + B t: for each r (in bit-reversed order, into a binary counter) the
    static tree of its 8 rows t; then the CTA's warps pairwise (w with w
    + h, h = 4, 2, 1); then (the last CTA to arrive) for each lane the
    roles c = e 32 + l, padded with -0.0 to 128 (e with e + h, h = 2, 1,
    then l with l + h, h = 16 .. 1); then the lanes (h = 16 .. 1)."""
    n = x.shape[0]
    outer = 0
    while (256 * 8 * G) << outer < n:
        outer += 1
    B = 1 << outer
    rows = np.full((256 * 8 * G * B, 3), -0.0, np.float32)
    rows[:n] = x
    a = rows.reshape(8, B, 8, G, 32, 3)            # (t, r, warp, c, lane)
    stack = {}
    for k in range(B):
        r = int(format(k, f"0{outer}b")[::-1], 2) if outer else 0
        v = a[:, r]
        for h in (4, 2, 1):
            v = v[:h] + v[h:2 * h]
        v = v[0]
        lvl = 0
        while (k >> lvl) & 1:
            v = stack.pop(lvl) + v
            lvl += 1
        stack[lvl] = v
    t = stack[outer]                               # (warp, c, lane)
    for h in (4, 2, 1):
        t = t[:h] + t[h:2 * h]
    slots = np.full((128, 32, 3), -0.0, np.float32)
    slots[:G] = t[0]                               # (c, lane)
    t = slots.reshape(4, 32, 32, 3)                # (e, l, lane)
    for h in (2, 1):
        t = t[:h] + t[h:2 * h]
    t = t[0]                                       # (l, lane)
    for h in (16, 8, 4, 2, 1):
        t = t[:h] + t[h:2 * h]
    t = t[0]                                       # (lane,)
    for h in (16, 8, 4, 2, 1):
        t = t[:h] + t[h:2 * h]
    return t[0]


@pytest.mark.parametrize("n, G", [
    (0, 1), (1, 1), (37, 1), (2048, 2), (5000, 4), (5495, 128),
    (70_001, 64), (297_984, 128), (600_000, 128), (1_000_000, 128)])
def test_centroid_tree_order(n, G):
    """The fixed tree of ``bin_basis_plain``'s sum (``_halving_sum``: x[:h]
    + x[h:] over the rows padded with -0.0 to a power of two) is the order
    kernel S adds in, bit for bit, for the sum roles S launches (G: the
    largest power of two up to its grid and 128; the TLAS camera wave's
    5,495 pairs and the bench scene's 297,984 vertex rows take 128), from
    no row to more rows than 128 roles take in one 8-row tree a thread
    (1,000,000 rows: 4 trees a thread in the counter), with
    NaN-masked rows (-0.0), +-0.0 and magnitudes over 12 decades mixed;
    and within float32 rounding of the exact sum."""
    r = np.random.default_rng(n)
    x = (r.normal(size=(n, 3)) * 10.0 ** r.uniform(-6, 6, (n, 1))).astype(
        np.float32)
    if n > 8:
        x[::7] = -0.0
        x[3::11] = 0.0
        x[5::13] = -0.0                 # a NaN row, as the kernel masks it
    got = binning._halving_sum(torch.as_tensor(x))
    _eq(_bits(got), _bits(_kernel_order_sum(x, G)))
    exact = x.astype(np.float64).sum(0)
    scale = np.abs(x).astype(np.float64).sum(0)
    assert (np.abs(got.numpy() - exact) <= 1e-6 * scale + 1e-30).all()
