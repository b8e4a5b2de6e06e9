"""The gate groups of kernels A and D in their plain versions
(``ops/kernels/tile_raster.py``), on the cluster fixture of
test_torch_tile_raster.py and the TLAS fixture of test_torch_instanced.py:
camera waves in 16x16 tiles (dead rays every 11th ray), nearest and
any-hit (segments ending just before or just past each ray's nearest hit),
each tile in ``raster.to_tiles`` order (a warp's 32 rays are an 8x4 pixel
block) or row-major (a warp is two 16-pixel rows).

* Gated per warp, the plain version gives the hits it gives gated per
  whole tile (the kernels' first, CTA-wide design), under the hit rule
  (bench.py: prim ids equal, or |dt| <= 1e-5 |t| + 1e-6), and the same
  hit / miss for any-hit.
* Its Woop tests (rows tested per group x the group's rays) lie between
  the ones the answers need (``needed_raster_work``, nearest waves) and
  the whole-tile gate's, and above the per-ray gate's.
* Rows per group, t, slot, u and v equal, bit for bit, a brute-force
  float32 numpy loop over the schedule (the rule written out).
* Entries of an invalid instance (NaN sub boxes) never fire.
* ``raster.to_tiles`` puts every 32 consecutive rays on one 8x4 block.

The kernels on the card are held to these plain versions, counts
included, by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch.ops import raster
from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
from optix_ray_tracer_tpu_torch.utils.vecmath import INF
from test_torch_instanced import _keys, _setup
from test_torch_instanced import raster_setup  # noqa: F401  (TLAS fixture)
from test_torch_tile_raster import setup  # noqa: F401  (cluster fixture)

torch.set_num_threads(1)

TILE = 16                 # camera tiles of TILE x TILE rays
W = TILE * TILE
LAYOUTS = ("8x4", "runs")


def _tiles(x, h, w, layout):
    """(h * w, 3) pixel rows -> TILE x TILE tiles: each in 8x4 blocks
    (``raster.to_tiles``, the camera path's order), or row-major."""
    x = torch.as_tensor(np.array(x)).reshape(-1, 3)
    if layout == "8x4":
        return raster.to_tiles(x, 1, h, w, TILE, TILE)
    return (x.reshape(h // TILE, TILE, w // TILE, TILE, 3).transpose(1, 2)
            .reshape(-1, 3))


class _Case:
    """One kernel's plain version on its nearest and any-hit schedules in
    each layout; runs are kept per (layout, any_hit, group)."""

    def __init__(self, inputs, keys):
        self.inputs, self.keys = inputs, keys
        self._runs = {}

    def run(self, layout: str, any_hit: bool, group: int):
        key = (layout, any_hit, group)
        if key not in self._runs:
            self._runs[key] = tr._raster_plain(
                self.inputs[layout][any_hit], W, any_hit, "origin", group)
        return self._runs[key]


def _bounds(n):
    tmin = torch.full((n,), 1e-3)
    tmax = torch.full((n,), 1e16)
    tmax[::11] = 0.0                                   # dead rays
    return tmin, tmax


def _any_hit_tmax(tmax, t, slot):
    """Segments ending just before (even rays) or just past (odd rays) the
    nearest hit; rays that miss keep theirs."""
    t, slot = t.reshape(-1), slot.reshape(-1)
    odd = torch.arange(t.numel()) % 2 == 1
    cut = torch.where(odd, t * 1.001, t * 0.999)
    return torch.where((slot >= 0) & (tmax > 0), cut, tmax)


def _cluster_case(setup):
    _, _, _, tinter, o_px, d_px = setup

    def layout_inputs(layout):
        o, d = _tiles(o_px, 48, 48, layout), _tiles(d_px, 48, 48, layout)
        tmin, tmax = _bounds(o.shape[0])

        def inputs(tmax, g):
            S = raster._coarse_stage(tinter.raster, tinter.clusters, o, d,
                                     tmin, tmax, "origin", o[0], W, 1 << 14,
                                     g)
            assert int(S["pc_total"]) <= 1 << 14
            return raster.schedule_inputs(tinter.clusters, S, S["nb"], g)

        near = inputs(tmax, 4)
        t, slot, *_ = tr.raster_cluster_plain(**near, w=W, common="origin")
        return {False: near, True: inputs(_any_hit_tmax(tmax, t, slot), 2)}

    prims = tinter.clusters.prim_index

    def keys(s):
        return torch.where(s < 0, -1, prims[s.clamp(min=0).long()])

    return _Case({lay: layout_inputs(lay) for lay in LAYOUTS}, keys)


def _tlas_inputs(inter, o, d, tmin, tmax):
    S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, o, d, tmin,
                                  tmax, "origin", o[0], W, 1 << 14,
                                  inter.pair_shape, inter.pair_inst)
    assert int(S["pc_total"]) <= 1 << 14
    return ri.instanced_schedule_inputs(inter, S)


def _tlas_case(raster_setup):
    s, o_px, d_px = raster_setup
    inter = s["tinter"]

    def layout_inputs(layout):
        o, d = _tiles(o_px, 32, 32, layout), _tiles(d_px, 32, 32, layout)
        tmin, tmax = _bounds(o.shape[0])
        near = _tlas_inputs(inter, o, d, tmin, tmax)
        t, slot, *_ = tr.raster_instanced_plain(**near, w=W, common="origin")
        far = _tlas_inputs(inter, o, d, tmin, _any_hit_tmax(tmax, t, slot))
        return {False: near, True: far}

    return _Case({lay: layout_inputs(lay) for lay in LAYOUTS},
                 lambda sl: torch.as_tensor(_keys(inter, sl.numpy())))


@pytest.fixture(scope="module")
def cases(setup, raster_setup):  # noqa: F811
    return {"A": _cluster_case(setup), "D": _tlas_case(raster_setup)}


PARAMS = pytest.mark.parametrize(
    "kernel,layout,any_hit",
    [(k, lay, a) for k in ("A", "D") for lay in LAYOUTS for a in (False,
                                                                  True)],
    ids=lambda x: {False: "nearest", True: "any-hit"}.get(x, x)
    if isinstance(x, bool) else x)


@PARAMS
def test_warp_gate_matches_tile_gate(cases, kernel, layout, any_hit):
    """Gated per warp, the plain version finds the hits it finds gated per
    whole tile; dead rays miss."""
    c = cases[kernel]
    got = c.run(layout, any_hit, tr.WARP)
    ref = c.run(layout, any_hit, W)
    tg, sg = got[0].reshape(-1), got[1].reshape(-1)
    tw, sw = ref[0].reshape(-1), ref[1].reshape(-1)
    n = sg.numel()
    assert bool((sg[::11] < 0).all())
    if any_hit:
        assert torch.equal(sg >= 0, sw >= 0)
        assert 0 < int((sg >= 0).sum()) < n
        return
    assert hit_mismatches(c.keys(sg), tg, c.keys(sw), tw) == 0
    assert int((sg >= 0).sum()) > n // 8


@PARAMS
def test_gate_counts_ordered(cases, kernel, layout, any_hit):
    """Woop tests: per-ray gate <= warp gate <= whole-tile gate, and for a
    nearest wave the needed ones <= the warp gate's."""
    c = cases[kernel]
    warp = c.run(layout, any_hit, tr.WARP)
    run = int(warp[4].sum()) * tr.WARP
    per_ray = int(c.run(layout, any_hit, 1)[4].sum())
    tile = int(c.run(layout, any_hit, W)[4].sum()) * W
    assert warp[4].shape == (warp[0].numel() // tr.WARP,)
    assert 0 < per_ray <= run < tile
    if not any_hit:
        need = tr.needed_raster_work(c.inputs[layout][False], W, warp[0],
                                     warp[1])
        assert 0 < need["woop"] <= run


def _np_inv(d):
    with np.errstate(divide="ignore"):
        return np.where(np.abs(d) > np.float32(1e-12), np.float32(1.0) / d,
                        np.float32(1e12)).astype(np.float32)


def _np_entry(box, o, inv, tmin):
    """Slab entries of rays into one box row [min3, max3, ...]."""
    ent = np.full(o.shape[0], -INF, np.float32)
    ext = np.full(o.shape[0], INF, np.float32)
    for ax in range(3):
        t0 = (box[ax] - o[:, ax]) * inv[:, ax]
        t1 = (box[3 + ax] - o[:, ax]) * inv[:, ax]
        ent = np.maximum(ent, np.minimum(t0, t1))
        ext = np.minimum(ext, np.maximum(t0, t1))
    ent = np.maximum(ent, tmin)
    return np.where(ent <= ext, ent, np.float32(INF))


def _np_move(m, p, point: bool):
    """Points (p - b) or directions moved by the affine row m: A x."""
    x = [p[..., k] - m[9 + k] if point else p[..., k] for k in range(3)]
    return np.stack([(m[3 * r] * x[0] + m[3 * r + 1] * x[1])
                     + m[3 * r + 2] * x[2] for r in range(3)], -1)


def _np_brute(inp, any_hit):
    """The warp-gated walk written out: every tile's runs of 32 rays, each
    over its tile's pairs in schedule order, row by row.  Returns (t, slot,
    u, v) in tile order and the rows each run tested."""
    inst = "pair_insts" in inp
    g = 1 if inst else inp["granularity"]
    sub = inp["sub_boxes"].numpy()
    n_subs = sub.shape[1]
    ct = 256 // g
    step = ct // n_subs
    woop = inp["woop_t"].numpy()
    nb = inp["n_blocks"]
    rays = inp["rays_t_ext"].numpy()[:, :nb * W]
    tiles = inp["pair_tiles"].numpy()
    boxes = (inp["pair_ids"] if inst else inp["pair_clusters"]).numpy()
    wins = (inp["pair_libs"] if inst else inp["pair_clusters"]).numpy()
    bt, slot = rays[7].copy(), np.full(nb * W, -1, np.int64)
    u, v = np.zeros(nb * W, np.float32), np.zeros(nb * W, np.float32)
    rows = []
    for b in range(nb):
        pairs = np.nonzero(tiles == b)[0]
        c0 = rays[0:3, b * W]
        for k in range(W // 32):
            r = b * W + 32 * k + np.arange(32)
            o, d, tmin = rays[0:3, r].T, rays[3:6, r].T, rays[6, r]
            inv = _np_inv(d)
            tested = 0
            for p in pairs:
                sb = sub[boxes[p]]
                ent = [_np_entry(sb[q], o, inv, tmin) for q in range(n_subs)]
                if not any((e < bt[r]).any() for e in ent):
                    continue
                oo, dd, cc = o, d, c0
                if inst:
                    m = inp["inst_rows"][inp["pair_insts"][p]].numpy()
                    oo, dd = _np_move(m, o, True), _np_move(m, d, False)
                    cc = _np_move(m, c0, True)
                w = woop[wins[p] // g, :12, (wins[p] % g) * ct:]
                for q in range(n_subs):
                    if not (ent[q] < bt[r]).any():
                        continue
                    tested += step
                    for row in range(q * step, (q + 1) * step):
                        x = w[:, row]
                        op = [((x[4 * i] * cc[0] + x[4 * i + 1] * cc[1])
                               + x[4 * i + 2] * cc[2]) - x[4 * i + 3]
                              for i in range(3)]
                        dp = [(x[4 * i] * dd[:, 0] + x[4 * i + 1] * dd[:, 1])
                              + x[4 * i + 2] * dd[:, 2] for i in range(3)]
                        ok_z = np.abs(dp[2]) > np.float32(1e-12)
                        t = -op[2] / np.where(ok_z, dp[2], np.float32(1e-12))
                        uu, vv = op[0] + t * dp[0], op[1] + t * dp[1]
                        hit = (ok_z & (uu >= 0) & (vv >= 0)
                               & (uu + vv <= np.float32(1)) & (t > tmin)
                               & (t < bt[r]))
                        slot[r[hit]] = boxes[p] * ct + row
                        if any_hit:
                            bt[r[hit]] = -INF
                        else:
                            bt[r[hit]], u[r[hit]], v[r[hit]] = (
                                t[hit], uu[hit], vv[hit])
            rows.append(tested)
    return (bt, slot, u, v), np.asarray(rows)


@PARAMS
def test_counts_match_brute_force(cases, kernel, layout, any_hit):
    """The plain version's rows per group, t, slot, u and v equal a
    brute-force numpy loop over the schedule, bit for bit."""
    c = cases[kernel]
    got = c.run(layout, any_hit, tr.WARP)
    ref, rows = _np_brute(c.inputs[layout][any_hit], any_hit)
    np.testing.assert_array_equal(got[4].numpy(), rows)
    for g, r in zip(got[:4], ref):
        np.testing.assert_array_equal(g.reshape(-1).numpy(), r)
    assert rows.sum() > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_invalid_instance_never_fires(raster_setup, layout):  # noqa: F811
    """Every tile's schedule is given, first, the entries of an invalid
    instance (NaN sub boxes): no gate opens for them, so t, slot, u, v
    and the rows tested are those of the schedule without them."""
    _, o, d = raster_setup
    inter = _setup(10, 1.0, 11, invalid=(4,))["tinter"]
    o, d = _tiles(o, 32, 32, layout), _tiles(d, 32, 32, layout)
    tmin, tmax = _bounds(o.shape[0])
    inp = _tlas_inputs(inter, o, d, tmin, tmax)
    bad = torch.nonzero(inter.pair_inst == 4)[:, 0]
    assert bool(torch.isnan(inter.sub_min[bad]).all())
    nb = inp["n_blocks"]
    tiles = torch.cat([torch.arange(nb).repeat_interleave(bad.numel()),
                       inp["pair_tiles"].long()])
    order = torch.argsort(tiles, stable=True)
    ids = torch.cat([bad.repeat(nb), inp["pair_ids"].long()])[order]
    poisoned = dict(inp, pair_tiles=tiles[order].to(torch.int32),
                    pair_ids=ids.to(torch.int32),
                    pair_libs=inter.pair_shape[ids].to(torch.int32),
                    pair_insts=inter.pair_inst[ids].to(torch.int32))
    kw = dict(w=W, common="origin", visits=True)
    got = tr.raster_instanced_plain(**poisoned, **kw)
    ref = tr.raster_instanced_plain(**inp, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int((ref[1] >= 0).sum()) > 0


@pytest.mark.parametrize("th,tw", [(32, 32), (16, 32), (32, 16), (8, 8)])
def test_to_tiles_order(th, tw):
    """``raster.to_tiles`` lays out a camera wave tile by tile, row-major,
    each tile's rays as 8-wide, 4-tall pixel blocks, row-major: every 32
    consecutive rays are one block, and a tile's first ray is its top-left
    pixel.  ``from_tiles`` undoes it."""
    S, H, Wd = 2, 2 * th, 3 * tw
    pix = torch.arange(S * H * Wd)
    a = torch.stack([pix, -pix], 1)
    got = raster.to_tiles(a, S, H, Wd, th, tw)
    assert torch.equal(raster.from_tiles(got, S, H, Wd, th, tw), a)
    assert torch.equal(got[:, 1], -got[:, 0])
    s, rem = got[:, 0] // (H * Wd), got[:, 0] % (H * Wd)
    row, col = rem // Wd, rem % Wd
    tile = (s * (H // th) + row // th) * (Wd // tw) + col // tw
    n = th * tw
    assert torch.equal(tile, torch.arange(S * H * Wd) // n)
    first = torch.arange(0, S * H * Wd, n)
    assert bool((row[first] % th == 0).all() & (col[first] % tw == 0).all())
    lane = torch.arange(32)
    for k in range(S * H * Wd // 32):
        r, c = row[32 * k:32 * (k + 1)], col[32 * k:32 * (k + 1)]
        assert torch.equal(r, r[0] + lane // 8) and r[0] % 4 == 0
        assert torch.equal(c, c[0] + lane % 8) and c[0] % 8 == 0
        blk = k % (n // 32)
        assert r[0] % th == (blk // (tw // 8)) * 4
        assert c[0] % tw == (blk % (tw // 8)) * 8
