"""Kernels A-G on the card against their plain PyTorch versions, on the
same CUDA inputs at a small scene size; the sweep intersector against the
marcher, and the denoisers against their CPU runs.  Marked ``cuda``: they skip
where no CUDA device is present; on a machine with one, run

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures jax, which a machine for
the port need not have.)

Tolerance: the hit rule (prim ids equal, or |dt| <= 1e-5 |t| + 1e-6)
with no exceptions, and equal hit / miss for occlusion waves; u and v to
1e-6; G exact, filler and dead lanes included.  (The kernels and the
plain versions round every operation alike, so the expected difference
is zero.)  Denoisers, card against CPU: the tolerances of
tests/test_torch_denoise.py."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.ops import raster
from optix_ray_tracer_tpu_torch.ops.intersect import Hit, hit_mismatches
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
from optix_ray_tracer_tpu_torch.ops.march import (
    make_march_intersector, ray_probe_keys,
)
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(dev):
    v, n = sphere_with_n_triangles(20000)
    scene = Scene(Spheres.empty(), Triangles.from_arrays(v, n))
    inter = make_march_intersector(scene, raster=True)
    cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = cam.generate_rays(128, 128)
    # 32x32 tiles, as the camera wave feeds the raster engine
    o, d = (raster.to_tiles(x.reshape(-1, 3), 1, 128, 128, 32, 32)
            for x in (o, d))
    r = np.random.default_rng(3)
    oi = torch.as_tensor(r.uniform(-0.9, 0.9, (8192, 3)).astype(np.float32),
                         device=dev)
    di = torch.as_tensor(r.normal(size=(8192, 3)).astype(np.float32),
                         device=dev)
    di = di / torch.linalg.norm(di, dim=-1, keepdim=True)
    return scene, inter, o, d, oi, di


def _prims(clusters, slot):
    return torch.where(slot < 0, -1,
                       clusters.prim_index[slot.clamp(min=0).long()])


def _check(clusters, kern, plain):
    (tk, sk), (tp, sp) = kern[:2], plain[:2]
    torch.cuda.synchronize()
    assert hit_mismatches(_prims(clusters, sk), tk, _prims(clusters, sp),
                          tp) == 0
    return int((sk != sp).sum())


def _hold(kern, plain, any_hit: bool):
    """A march's (t, slot) against its plain version's: equal hit / miss
    for occlusion waves, the hit rule on the slots otherwise."""
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(kern[1] >= 0, plain[1] >= 0)
    else:
        assert hit_mismatches(kern[1], kern[0], plain[1], plain[0]) == 0


def _plain_args(inp):
    return {k: v for k, v in inp.items() if k != "w"}


@pytest.mark.parametrize("w", [128, 256, 512])
@pytest.mark.parametrize("coherent", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_kernel(setup, dev, coherent, any_hit, w):
    """Kernel B against its plain version at each block width the callers
    pad to; the visit counts are per warp."""
    scene, inter, _, _, oi, di = setup
    cs = inter.clusters
    n = oi.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 0.5 if any_hit else 1e16, device=dev)
    perm = torch.argsort(ray_probe_keys(cs, oi, di, tmin, tmax), stable=True)
    inp = bm.march_inputs(cs, oi[perm], di[perm], tmin, tmax, coherent, w)
    assert inp["w"] == w
    before = _lib.BLOCK_MARCH.launches
    kern = bm.march_call(**inp, any_hit=any_hit)
    assert _lib.BLOCK_MARCH.launches == before + 1
    assert kern[2].shape == (inp["rays"].shape[1] // 32,)
    assert int(kern[2].sum()) > 0
    plain = bm.march_plain(**_plain_args(inp), any_hit=any_hit)
    if any_hit:
        assert torch.equal(kern[1] >= 0, plain[1] >= 0)
    else:
        _check(cs, kern, plain)


def test_probe_kernel(setup, dev):
    _, inter, _, _, oi, di = setup
    n = oi.shape[0]
    tmax = torch.full((n,), 1e16, device=dev)
    tmax[::9] = 0.0
    inp = bm.probe_inputs(inter.clusters, oi, di,
                          torch.full((n,), 1e-3, device=dev), tmax)
    before = _lib.PROBE.launches
    ids, tests = bm.probe_call(**inp)
    assert _lib.PROBE.launches == before + 1
    assert torch.equal(ids, bm.probe_plain(**inp))
    assert 0 < int(tests) <= n * (inp["n_clusters"]
                                  + -(-inp["n_clusters"] // 8))


def _probe_wave(dev, n_clusters: int, n_rays: int = 8192, seed: int = 0):
    """probe_call arguments over random boxes (min <= max) in [-1, 1.2]^3
    with three copies of box 1 in three superclusters (equal entries, the
    lowest id wins) and box 2 around box 3 (rays inside both enter both at
    t_min) and box 5 with a NaN; random rays, every fifth dead (t_max 0),
    a block of them starting inside box 3."""
    r = np.random.default_rng(seed)
    c_pad = -(-n_clusters // 8) * 8
    lo = r.uniform(-1.0, 0.9, (n_clusters, 3))
    hi = lo + r.uniform(0.02, 0.3, (n_clusters, 3))
    for c in (9, 17, n_clusters - 1):
        lo[c], hi[c] = lo[1], hi[1]
    lo[2], hi[2] = lo[3] - 0.02, hi[3] + 0.02
    boxes = np.full((c_pad, 8), np.nan, np.float32)
    boxes[:, 6:] = 0.0
    boxes[:n_clusters, 0:3], boxes[:n_clusters, 3:6] = lo, hi
    boxes[5, 4] = np.nan      # a real box with a NaN: never entered
    o = r.uniform(-1.1, 1.1, (n_rays, 3))
    o[:256] = (lo[3] + hi[3]) / 2 + r.uniform(-0.005, 0.005, (256, 3))
    o[256:512] = (lo[1] + hi[1]) / 2
    d = r.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n_rays, 1e16)
    tmax[::5] = 0.0
    # concatenating transposed rows gives a Fortran-ordered array
    rays = np.ascontiguousarray(np.concatenate(
        [o.T, d.T, np.full((1, n_rays), 1e-3), tmax[None]]), np.float32)
    return dict(rays=torch.as_tensor(rays, device=dev),
                boxes=torch.as_tensor(boxes, device=dev),
                n_clusters=n_clusters, c_pad=c_pad)


@pytest.mark.parametrize("n_clusters", [388, 1003, 8192])
def test_probe_kernel_cluster_counts(dev, n_clusters):
    """Kernel C against its plain version at the bench scene's cluster
    count, at one that is not a multiple of 8 and at MAX_CLUSTERS; the
    ties go to the lowest copy; its occupancy does not depend on the
    cluster count (fixed shared memory)."""
    inp = _probe_wave(dev, n_clusters, seed=n_clusters)
    ids, tests = bm.probe_call(**inp)
    plain = bm.probe_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(ids, plain)
    assert not bool(torch.isin(ids[:512], torch.tensor(
        [9, 17, n_clusters - 1], device=dev, dtype=torch.int32)).any())
    assert int((ids[256:512] == 1).sum()) > 0
    assert int((ids < n_clusters).sum()) > inp["rays"].shape[1] // 4
    assert int(tests) > 0
    assert bm.probe_occupancy() >= 32


def test_probe_kernel_all_dead(dev):
    """A wave of dead rays (t_max <= t_min, or NaN bounds) gets c_pad
    everywhere without a single box test."""
    inp = _probe_wave(dev, 388)
    rays = inp["rays"].clone()
    rays[7] = rays[6]
    rays[7, 1::3] = 0.0
    rays[6, 2::7] = float("nan")
    rays[7, 3::7] = float("nan")
    ids, tests = bm.probe_call(**dict(inp, rays=rays))
    torch.cuda.synchronize()
    assert bool((ids == inp["c_pad"]).all())
    assert int(tests) == 0


def test_probe_kernel_nan_and_infinite_rays(dev):
    """NaN in the origin or t_min gives c_pad, as the plain version and
    the JAX probe give (NaN propagates through their min / max; CUDA's
    fmaxf would drop a NaN t_min and let the ray enter a box); NaN in the
    direction and infinite origins or directions (the flagged warps that
    test every box with the NaN check) match the plain version."""
    inp = _probe_wave(dev, 1003, seed=4)
    rays = inp["rays"].clone()
    rays[7] = 1e16
    rays[0, 0::11] = float("nan")
    rays[6, 1::11] = float("nan")
    rays[3, 2::11] = float("nan")
    rays[1, 3::97] = float("inf")
    rays[5, 4::97] = float("-inf")
    ids, _ = bm.probe_call(**dict(inp, rays=rays))
    plain = bm.probe_plain(**dict(inp, rays=rays))
    torch.cuda.synchronize()
    assert torch.equal(ids, plain)
    assert bool((ids[0::11] == inp["c_pad"]).all())
    assert bool((ids[1::11] == inp["c_pad"]).all())
    assert int((ids[2::11] < inp["n_clusters"]).sum()) > 0


@pytest.mark.parametrize("mode,any_hit,g", [("origin", False, 4),
                                            ("origin", True, 2),
                                            ("target", False, 4)])
def test_tile_raster_kernel(setup, dev, mode, any_hit, g):
    scene, inter, o, d, _, _ = setup
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 1e16, device=dev)
    point = o[0]
    if mode == "target":
        h = inter.intersect(scene, o, d)
        light = torch.tensor([3.0, 3.0, 3.0], device=dev)
        p = torch.where(h.is_hit[:, None], o + h.t[:, None] * d, o)
        wl = light - p
        tmax = torch.linalg.norm(wl, dim=-1) - 1e-3
        wl = wl / torch.linalg.norm(wl, dim=-1, keepdim=True)
        o, d, point = p + wl * 1e-3, wl, light
    S = raster._coarse_stage(inter.raster, inter.clusters, o, d, tmin, tmax,
                             mode, point, 1024, 1 << 16, g)
    assert int(S["pc_total"]) <= 1 << 16
    inp = raster.schedule_inputs(inter.clusters, S, S["nb"], g)
    common = "origin" if mode == "origin" else None
    kern = tr.raster_cluster_call(**inp, w=1024, any_hit=any_hit,
                                  common=common)
    plain = tr.raster_cluster_plain(**inp, w=1024, any_hit=any_hit,
                                    common=common)
    if any_hit:
        assert torch.equal(kern[1] >= 0, plain[1] >= 0)
        return
    _check(inter.clusters, [x.reshape(-1) for x in kern],
           [x.reshape(-1) for x in plain])
    torch.testing.assert_close(kern[2], plain[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(kern[3], plain[3], rtol=0, atol=1e-6)


def test_overflow_fallback_on_card(setup, dev):
    """A tiny pair capacity sends the camera wave to kernel B (coherent),
    between kernels P and Q; the hits equal the raster route's under the
    hit rule."""
    scene, inter, o, d, _, _ = setup
    before = (_lib.TILE_RASTER.launches, _lib.BLOCK_MARCH.launches,
              _lib.GATHER_RAYS.launches, _lib.FINISH_HITS.launches)
    h_f = inter.intersect_from(scene, o, d, mode="origin", point=o[0],
                               pc_max=64)
    assert _lib.TILE_RASTER.launches == before[0]
    assert _lib.BLOCK_MARCH.launches == before[1] + 1
    assert _lib.GATHER_RAYS.launches == before[2] + 1
    assert _lib.FINISH_HITS.launches == before[3] + 1
    h_r = inter.intersect_from(scene, o, d, mode="origin", point=o[0])
    assert _lib.TILE_RASTER.launches == before[0] + 1
    assert hit_mismatches(h_f.prim_id, h_f.t, h_r.prim_id, h_r.t) == 0


def test_render_matches_cpu(dev):
    """The Whitted path on the card against the same call on CPU tensors
    (the plain versions): same image to fp noise."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.7, 0.6, 0.5))
    v, n = sphere_with_n_triangles(2500)
    qv, qn = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
    tris = Triangles.from_arrays(v, n, metal).concat(
        Triangles.from_arrays(qv, qn, ground))
    imgs = []
    for device in (dev, torch.device("cpu")):
        scene = Scene(Spheres.from_list([((0.2, 1.5, -0.6), 0.4, ground)],
                                        device), tris.to(device))
        inter = make_march_intersector(scene, raster=True)
        cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0), device=device)
        imgs.append(wavefront.render(scene, mb.build(device), cam, 64, 64,
                                     spp=4, seed=7,
                                     intersector=inter)[0].cpu())
    diff = (imgs[0] - imgs[1]).abs()
    assert float(diff.mean()) <= 1e-5
    assert float((diff.amax(-1) <= 1e-4).float().mean()) >= 0.999


@pytest.fixture(scope="module")
def tlas(dev):
    """A small TLAS on the card: the library of tests/test_instanced.py
    (80, 200, 450 triangles), 40 posed instances, one invalid."""
    from optix_ray_tracer_tpu_torch.ops.instanced import (
        build_instanced_library, make_instanced_intersector,
    )
    from optix_ray_tracer_tpu_torch.utils.transforms import (
        quat_to_rotation_matrix,
    )
    meshes = [sphere_with_n_triangles(s)[0] for s in (80, 200, 450)]
    counts = np.asarray([m.shape[0] for m in meshes])
    lib = build_instanced_library(np.concatenate(meshes), np.concatenate(
        [[0], np.cumsum(counts)[:-1]]), counts)
    r = np.random.default_rng(5)
    P = 40
    q = torch.as_tensor(r.normal(size=(P, 4)).astype(np.float32), device=dev)
    valid = torch.ones(P, dtype=torch.bool, device=dev)
    valid[7] = False
    inter = make_instanced_intersector(
        lib, r.integers(0, 3, P), quat_to_rotation_matrix(q),
        torch.as_tensor(r.uniform(-6, 6, (P, 3)).astype(np.float32),
                        device=dev), 0.8, valid)
    oi = torch.as_tensor(r.uniform(-5, 5, (8192, 3)).astype(np.float32),
                         device=dev)
    di = torch.as_tensor(r.normal(size=(8192, 3)).astype(np.float32),
                         device=dev)
    return inter, oi, di / torch.linalg.norm(di, dim=-1, keepdim=True)


@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_instanced_kernel(tlas, dev, any_hit):
    """Kernel E against its plain version: the same slots."""
    inter, oi, di = tlas
    n = oi.shape[0]
    inp = bm.march_instanced_inputs(
        inter.pair_min, inter.pair_max, inter.sub_min, inter.sub_max,
        inter.pair_shape, inter.pair_inst, inter.inst_rows,
        inter.library.woop_t, oi, di, torch.full((n,), 1e-3, device=dev),
        torch.full((n,), 2.0 if any_hit else 1e16, device=dev))
    before = _lib.BLOCK_MARCH_INSTANCED.launches
    kern = bm.march_instanced_call(**inp, any_hit=any_hit)
    assert _lib.BLOCK_MARCH_INSTANCED.launches == before + 1
    assert kern[2].shape == (inp["rays"].shape[1] // 32,)
    plain = bm.march_instanced_plain(
        **{k: v for k, v in inp.items() if k != "w"}, any_hit=any_hit)
    torch.cuda.synchronize()
    assert torch.equal(kern[1] >= 0, plain[1] >= 0)
    assert 0 < int((kern[1] >= 0).sum()) < n
    if not any_hit:
        tk, tp = kern[0], plain[0]
        assert bool((torch.abs(tk - tp) <= 1e-5 * torch.abs(tp) + 1e-6)
                    [plain[1] >= 0].all())


def _instanced_inputs(inter, o, d, tmin, tmax):
    return bm.march_instanced_inputs(
        inter.pair_min, inter.pair_max, inter.sub_min, inter.sub_max,
        inter.pair_shape, inter.pair_inst, inter.inst_rows,
        inter.library.woop_t, o, d, tmin, tmax)


def _library(dev, sizes):
    from optix_ray_tracer_tpu_torch.ops.instanced import (
        build_instanced_library,
    )
    meshes = [sphere_with_n_triangles(s)[0] for s in sizes]
    counts = np.asarray([m.shape[0] for m in meshes])
    return build_instanced_library(np.concatenate(meshes), np.concatenate(
        [[0], np.cumsum(counts)[:-1]]), counts, device=dev)


@pytest.fixture(scope="module")
def lattice(dev):
    """A TLAS the warp candidate lists overflow: 1,920 particles of the
    (80, 200, 450)-triangle library (radius 0.4, random poses) on a
    30 x 8 x 8 unit lattice, 2,647 pairs, and 49 more in a wall past its
    end, one in each gap; rays run down the gaps, 32 different gaps per
    warp, crossing the rotated pair boxes of the lattice (~1,500 rows per
    warp, each needed: nothing is hit before the wall), so every warp
    culls more rows than its list holds and marches several rounds."""
    from optix_ray_tracer_tpu_torch.ops.instanced import (
        make_instanced_intersector,
    )
    from optix_ray_tracer_tpu_torch.utils.transforms import (
        quat_to_rotation_matrix,
    )
    n = (30, 8, 8)
    r = np.random.default_rng(2)
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in n], indexing="ij"),
                    -1).reshape(-1, 3)
    gy, gz = np.meshgrid(np.arange(n[1] - 1) + 0.5,
                         np.arange(n[2] - 1) + 0.5, indexing="ij")
    wall = np.stack([np.full(gy.size, n[0] + 0.5), gy.ravel(), gz.ravel()],
                    -1)
    pos = np.concatenate([grid, wall]).astype(np.float32)
    P = pos.shape[0]
    q = torch.as_tensor(r.normal(size=(P, 4)).astype(np.float32), device=dev)
    inter = make_instanced_intersector(
        _library(dev, (80, 200, 450)), r.integers(0, 3, P),
        quat_to_rotation_matrix(q), torch.as_tensor(pos, device=dev), 0.4,
        torch.ones(P, dtype=torch.bool, device=dev))
    R = 2048
    gaps = (n[1] - 1) * (n[2] - 1)
    g = (np.arange(R) + np.arange(R) // 32 * 7) % gaps
    o = np.stack([np.full(R, -2.0), g // (n[2] - 1) + 0.5
                  + r.normal(0, 0.02, R), g % (n[2] - 1) + 0.5
                  + r.normal(0, 0.02, R)], -1)
    d = np.concatenate([np.ones((R, 1)), r.normal(0, 0.002, (R, 2))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return inter, torch.as_tensor(o.astype(np.float32), device=dev), \
        torch.as_tensor(d.astype(np.float32), device=dev)


@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_instanced_overflow(lattice, dev, any_hit):
    """Kernel E where every warp's candidates overflow its 512-key list
    and its needed rows outnumber the 256 it keeps: exact all the same."""
    inter, o, d = lattice
    n = o.shape[0]
    assert inter.pair_min.shape[0] > 2000
    inp = _instanced_inputs(inter, o, d, torch.full((n,), 1e-3, device=dev),
                            torch.full((n,), 1e16, device=dev))
    kern = bm.march_instanced_call(**inp, any_hit=any_hit)
    plain = bm.march_instanced_plain(**_plain_args(inp), any_hit=any_hit)
    _hold(kern, plain, any_hit)
    assert int((plain[1] >= 0).sum()) > n // 2
    # the precondition: rows some lane of a warp needs, per warp
    rays = inp["rays"]
    t, slot = bm.march_instanced_plain(**_plain_args(inp), any_hit=False)
    ent = bm._entries(inp["boxes"][:inp["n_pairs"]], rays[0:3].T,
                      bm.inv_dir(rays[3:6].T), rays[6])
    reach = torch.where(slot >= 0, torch.nextafter(
        t, torch.full_like(t, float("inf"))), rays[7])
    need = (ent < reach[:, None]).reshape(-1, 32, ent.shape[1]).any(1)
    assert int(need.sum(1).min()) > 512


@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_instanced_large_library(dev, any_hit):
    """Kernel E over a library of more than 16 clusters (2,000, 1,500 and
    900-triangle spheres): each warp's rows come from many library
    clusters."""
    from optix_ray_tracer_tpu_torch.ops.instanced import (
        make_instanced_intersector,
    )
    from optix_ray_tracer_tpu_torch.utils.transforms import (
        quat_to_rotation_matrix,
    )
    lib = _library(dev, (2000, 1500, 900))
    assert lib.woop_t.shape[0] > 16
    r = np.random.default_rng(8)
    P = 120
    q = torch.as_tensor(r.normal(size=(P, 4)).astype(np.float32), device=dev)
    inter = make_instanced_intersector(
        lib, r.integers(0, 3, P), quat_to_rotation_matrix(q),
        torch.as_tensor(r.uniform(-6, 6, (P, 3)).astype(np.float32),
                        device=dev), 0.8, torch.ones(P, dtype=torch.bool,
                                                     device=dev))
    n = 4096
    o = torch.as_tensor(r.uniform(-5, 5, (n, 3)).astype(np.float32),
                        device=dev)
    d = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32), device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    inp = _instanced_inputs(inter, o, d, torch.full((n,), 1e-3, device=dev),
                            torch.full((n,), 3.0 if any_hit else 1e16,
                                       device=dev))
    kern = bm.march_instanced_call(**inp, any_hit=any_hit)
    plain = bm.march_instanced_plain(**_plain_args(inp), any_hit=any_hit)
    _hold(kern, plain, any_hit)
    hit_libs = inter.pair_shape[(plain[1][plain[1] >= 0] // 256).long()]
    assert int(torch.unique(hit_libs).numel()) > 16


@pytest.mark.parametrize("wave", ["dead_rays_nan_rows", "all_miss"])
@pytest.mark.parametrize("kernel", ["B", "E", "F"])
def test_march_edge_waves(setup, tlas, dev, kernel, wave):
    """B, E and F against their plain versions on a wave with dead (t_max
    0) rays among live ones and NaN cull rows and sub boxes among live rows
    (for F also a NaN supercluster), and on a wave that misses everything
    (every slot -1, t = t_max)."""
    n = 4096
    r = np.random.default_rng(6)
    if kernel != "E":
        cs = setup[1].clusters
        o = torch.as_tensor(r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32),
                            device=dev)
        far = 3.0
    else:
        inter = tlas[0]
        o = torch.as_tensor(r.uniform(-5, 5, (n, 3)).astype(np.float32),
                            device=dev)
        far = 40.0
    d = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32), device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    tmax = torch.full((n,), 1e16, device=dev)
    if wave == "all_miss":      # from outside the scene, facing away
        d = torch.nn.functional.normalize(o, dim=-1)
        o = d * far
    else:
        tmax[::3] = 0.0
        tmax[5::7] = 0.0
    tmin = torch.full((n,), 1e-3, device=dev)
    if kernel == "B":
        inp = bm.march_inputs(cs, o, d, tmin, tmax, coherent=False)
        call, plain_fn = bm.march_call, bm.march_plain
    elif kernel == "F":
        inp = bm.hier_inputs(cs, o, d, tmin, tmax, coherent=False)
        call, plain_fn = bm.march_hier_call, bm.march_hier_plain
    else:
        inp = _instanced_inputs(inter, o, d, tmin, tmax)
        call, plain_fn = bm.march_instanced_call, bm.march_instanced_plain
    if wave != "all_miss":
        boxes, subs = inp["boxes"].clone(), inp["sub_boxes"].clone()
        boxes[1::5] = float("nan")
        subs[2::3, 1] = float("nan")
        inp = dict(inp, boxes=boxes, sub_boxes=subs)
        if kernel == "F":
            boxes[bm.GROUP:2 * bm.GROUP] = float("nan")
            inp["sup_boxes"] = bm.supercluster_boxes(boxes)
    for any_hit in (False, True):
        kern = call(**inp, any_hit=any_hit)
        plain = plain_fn(**_plain_args(inp), any_hit=any_hit)
        _hold(kern, plain, any_hit)
        live = inp["rays"][7] > 0
        if wave == "all_miss":
            assert int((kern[1] >= 0).sum()) == 0
            assert torch.equal(kern[0], inp["rays"][7])
        else:
            assert int((kern[1] >= 0).sum()) > 0
            assert int((kern[1][~live] >= 0).sum()) == 0


@pytest.mark.parametrize("kernel", ["B", "E", "F"])
def test_march_refuses_partial_cta(setup, tlas, dev, kernel):
    """B, E and F launch 4-warp CTAs: a block width that is not a multiple
    of BLOCK_RAYS raises before any launch."""
    n = 256
    o = torch.zeros((n, 3), device=dev)
    d = torch.zeros((n, 3), device=dev)
    d[:, 2] = 1.0
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 1e16, device=dev)
    if kernel == "B":
        inp = bm.march_inputs(setup[1].clusters, o, d, tmin, tmax,
                              coherent=False)
        call, counter = bm.march_call, _lib.BLOCK_MARCH
    elif kernel == "F":
        inp = bm.hier_inputs(setup[1].clusters, o, d, tmin, tmax)
        call, counter = bm.march_hier_call, _lib.BLOCK_MARCH_HIER
    else:
        inp = _instanced_inputs(tlas[0], o, d, tmin, tmax)
        call, counter = bm.march_instanced_call, _lib.BLOCK_MARCH_INSTANCED
    before = counter.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        call(**dict(inp, w=64))
    assert counter.launches == before


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_raster_instanced_kernel(tlas, dev, any_hit):
    """Kernel D against its plain version on a camera wave (origin mode):
    the same slots, t, u and v."""
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    inter, _, _ = tlas
    cam = Camera.look_at((16.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = cam.generate_rays(128, 128)
    o = o.reshape(4, 32, 4, 32, 3).transpose(1, 2).reshape(-1, 3)
    d = d.reshape(4, 32, 4, 32, 3).transpose(1, 2).reshape(-1, 3)
    n = o.shape[0]
    tmax = torch.full((n,), 16.0 if any_hit else 1e16, device=dev)
    S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, o, d,
                                  torch.full((n,), 1e-3, device=dev), tmax,
                                  "origin", o[0], 1024, 1 << 16,
                                  inter.pair_shape, inter.pair_inst)
    assert int(S["pc_total"]) <= 1 << 16
    inp = ri.instanced_schedule_inputs(inter, S)
    before = _lib.TILE_RASTER_INSTANCED.launches
    kern = ri.raster_instanced_call(**inp, w=1024, any_hit=any_hit,
                                    common="origin")
    assert _lib.TILE_RASTER_INSTANCED.launches == before + 1
    plain = tr.raster_instanced_plain(**inp, w=1024, any_hit=any_hit,
                                      common="origin")
    torch.cuda.synchronize()
    assert torch.equal(kern[1] >= 0, plain[1] >= 0)
    assert int((kern[1] >= 0).sum()) > 0
    if not any_hit:
        assert torch.equal(kern[1], plain[1])
        for a, b in zip(kern, plain):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _raster_kernel_case(kernel, inter, cam, th, tw, any_hit, dev,
                        size=128):
    """Kernel A (or D) on a size x size camera wave in th x tw tiles in
    ``raster.to_tiles`` order (a warp per 8x4 block), against its plain
    version: t,
    slot, u, v and the Woop-tested rows per warp equal, one launch.  The
    wave has dead rays (every 13th, and all of tile 1: a tile with no
    pairs) and NaN sub boxes (every 7th window's first); an any-hit
    wave's segments end just before or just past each nearest hit.
    Returns (schedule inputs, coarse stage, kernel outputs)."""
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    o, d = cam.generate_rays(size, size)
    o, d = (raster.to_tiles(x.reshape(-1, 3), 1, size, size, th, tw)
            for x in (o, d))
    w, n = th * tw, o.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 1e16, device=dev)
    tmax[::13] = 0.0
    tmax[w:2 * w] = 0.0
    if kernel == "A":
        call, plain_fn = tr.raster_cluster_call, tr.raster_cluster_plain
        counter = _lib.TILE_RASTER
    else:
        call, plain_fn = tr.raster_instanced_call, tr.raster_instanced_plain
        counter = _lib.TILE_RASTER_INSTANCED

    def inputs(tmax, any_hit):
        if kernel == "A":
            g = 2 if any_hit else 4
            S = raster._coarse_stage(inter.raster, inter.clusters, o, d, tmin,
                                     tmax, "origin", o[0], w, 1 << 17, g)
            inp = raster.schedule_inputs(inter.clusters, S, S["nb"], g)
        else:
            S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, o,
                                          d, tmin, tmax, "origin", o[0], w,
                                          1 << 17, inter.pair_shape,
                                          inter.pair_inst)
            inp = ri.instanced_schedule_inputs(inter, S)
        assert int(S["pc_total"]) <= 1 << 17
        subs = inp["sub_boxes"].clone()
        subs[3::7, 0] = float("nan")
        return dict(inp, sub_boxes=subs), S

    kw = dict(w=w, common="origin", visits=True)
    inp, S = inputs(tmax, False)
    if any_hit:
        t, slot = plain_fn(**inp, **kw)[:2]
        t, slot = t.reshape(-1), slot.reshape(-1)
        odd = torch.arange(n, device=dev) % 2 == 1
        cut = torch.where(odd, t * 1.001, t * 0.999)
        inp, S = inputs(torch.where((slot >= 0) & (tmax > 0), cut, tmax),
                        True)
    before = counter.launches
    kern = call(**inp, **kw, any_hit=any_hit)
    assert counter.launches == before + 1
    plain = plain_fn(**inp, **kw, any_hit=any_hit)
    torch.cuda.synchronize()
    assert kern[4].shape == (S["nb"] * w // 32,)
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    assert int(kern[4].sum()) > 0
    return inp, S, kern


@pytest.mark.parametrize("tiles", [(32, 32), (16, 32), (32, 16)],
                         ids=["32x32", "16x32", "32x16"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["A", "D"])
def test_raster_warp_kernel(setup, tlas, dev, kernel, tiles, any_hit):
    """A and D walk each tile per warp of an 8x4 pixel block: equal to
    their plain versions, Woop-tested rows included, on th x tw tiles, a
    tile with no pairs, dead rays, NaN sub boxes (and for D an invalid
    instance), nearest and any-hit."""
    th, tw = tiles
    if kernel == "A":
        inter = setup[1]
        cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0))
    else:
        inter = tlas[0]
        cam = Camera.look_at((16.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0))
    inp, S, kern = _raster_kernel_case(kernel, inter, cam, th, tw, any_hit,
                                       dev)
    w = th * tw
    hits = kern[1].reshape(-1) >= 0
    assert 0 < int(hits.sum()) < hits.numel()
    assert int(S["cnt_b"][1]) == 0
    assert not bool(hits[w:2 * w].any())
    assert int(kern[4].reshape(-1, w // 32)[1].sum()) == 0


@pytest.mark.parametrize("kernel", ["A", "D"])
def test_raster_warp_kernel_long_tile(setup, lattice, dev, kernel):
    """A tile with more than 128 scheduled pairs: the whole sphere (A) or
    a view down the 2,696-pair lattice (D) in the middle one of 3 x 3
    tiles."""
    if kernel == "A":
        inter = setup[1]
        cam = Camera.look_at((30.0, 0.0, 0.0), (29.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0))
    else:
        inter = lattice[0]
        cam = Camera.look_at((-10.0, 3.5, 3.5), (0.0, 3.5, 3.5),
                             (0.0, 0.0, 1.0))
    _, S, kern = _raster_kernel_case(kernel, inter, cam, 32, 32, False, dev,
                                     size=96)
    assert int(S["cnt_b"].max()) > 128
    assert int((kern[1] >= 0).sum()) > 0


def test_raster_occupancy(dev):
    """A and D keep at least 16 resident warps per SM in every variant."""
    for instanced in (False, True):
        for any_hit in (False, True):
            for common in tr.COMMONS:
                assert tr.raster_occupancy(instanced, any_hit, common) >= 16


def _ortho_wave(center, target, extent, dev, size=128):
    """A size x size grid of parallel rays (an ortho wave) over extent x
    extent units of the plane through ``center`` facing ``target``, in
    32 x 32 tiles of ``raster.to_tiles`` order; every 13th ray dead."""
    c = torch.tensor(center, device=dev)
    d = torch.tensor(target, device=dev) - c
    d = d / torch.linalg.norm(d)
    u = torch.linalg.cross(d, torch.tensor([0.0, 0.0, 1.0], device=dev))
    u = u / torch.linalg.norm(u)
    v = torch.linalg.cross(u, d)
    g = ((torch.arange(size, device=dev) + 0.5) / size - 0.5) * extent
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    o = c + gx.reshape(-1, 1) * u + gy.reshape(-1, 1) * v
    o = raster.to_tiles(o, 1, size, size, 32, 32)
    n = o.shape[0]
    tmax = torch.full((n,), 1e16, device=dev)
    tmax[::13] = 0.0
    return o, d.expand(n, 3).contiguous(), torch.full((n,), 1e-3,
                                                      device=dev), tmax


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["A", "D"])
def test_raster_dir_kernel(setup, tlas, dev, kernel, any_hit):
    """A's and D's common="dir" variant (ortho waves) against its plain
    twin: t, slot, u, v and the Woop-tested rows per warp equal, one
    launch; and against the marcher under the hit rule."""
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    if kernel == "A":
        inter = setup[1]
        o, d, tmin, tmax = _ortho_wave((3.0, 0.3, 0.8), (0.0, 0.0, 0.0),
                                       2.4, dev)
        S = raster._coarse_stage(inter.raster, inter.clusters, o, d, tmin,
                                 tmax, "ortho", None, 1024, 1 << 17, 2)
        inp = raster.schedule_inputs(inter.clusters, S, S["nb"], 2)
        call, plain_fn = tr.raster_cluster_call, tr.raster_cluster_plain
        counter = _lib.TILE_RASTER
    else:
        inter = tlas[0]
        o, d, tmin, tmax = _ortho_wave((16.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                                       16.0, dev)
        S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, o, d,
                                      tmin, tmax, "ortho", None, 1024,
                                      1 << 17, inter.pair_shape,
                                      inter.pair_inst)
        inp = ri.instanced_schedule_inputs(inter, S)
        call, plain_fn = tr.raster_instanced_call, tr.raster_instanced_plain
        counter = _lib.TILE_RASTER_INSTANCED
    assert int(S["pc_total"]) <= 1 << 17
    kw = dict(w=1024, any_hit=any_hit, common="dir", visits=True)
    before = counter.launches
    kern = call(**inp, **kw)
    assert counter.launches == before + 1
    plain = plain_fn(**inp, **kw)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    hits = kern[1].reshape(-1)[:o.shape[0]] >= 0
    assert 0 < int(hits.sum()) < hits.numel()
    if kernel == "A":
        ref = inter.intersect(setup[0], o, d, tmin, tmax)
        got = inter.intersect_from(setup[0], o, d, mode="ortho", t_min=tmin,
                                   t_max=tmax, any_hit=any_hit)
    else:
        ref, _ = inter.intersect(o, d, tmin, tmax)
        got, _ = inter.intersect_from(o, d, mode="ortho", t_min=tmin,
                                      t_max=tmax, any_hit=any_hit)
    assert torch.equal(got.is_hit, ref.is_hit)
    if not any_hit:
        assert hit_mismatches(got.prim_id, got.t, ref.prim_id, ref.t) == 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_bundle_kernel(setup, dev, any_hit):
    """Kernel A on a 3-D bundle schedule (common=None): the camera wave's
    hit points toward random points of an area light, against its plain
    twin (equal, Woop-tested rows included) and the marcher."""
    scene, inter, o, d, _, _ = setup
    h = inter.intersect(scene, o, d)
    p = torch.where(h.is_hit[:, None], o + h.t[:, None] * d, o)
    n = o.shape[0]
    r = np.random.default_rng(9)
    lp = torch.as_tensor(np.stack([np.full(n, 3.0), r.uniform(-1, 1, n),
                                   r.uniform(1, 3, n)], -1).astype(
                                       np.float32), device=dev)
    wl = lp - p
    dist = torch.linalg.norm(wl, dim=-1)
    wl = wl / dist[:, None]
    so = p + wl * 1e-3
    tmin = torch.full((n,), 1e-4, device=dev)
    tmax = torch.where(h.is_hit, dist - 2e-3, 0.0)
    S = raster.bundle_stage(inter.clusters, so, wl, tmin, tmax, 1024,
                            1 << 17)
    assert 0 < int(S["pc_total"]) <= 1 << 17
    inp = raster.schedule_inputs(inter.clusters, S, S["nb"])
    kw = dict(w=1024, any_hit=any_hit, common=None, visits=True)
    before = _lib.TILE_RASTER.launches
    kern = tr.raster_cluster_call(**inp, **kw)
    assert _lib.TILE_RASTER.launches == before + 1
    plain = tr.raster_cluster_plain(**inp, **kw)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    got = inter.intersect_bundled(scene, so, wl, t_min=tmin, t_max=tmax,
                                  any_hit=any_hit)
    ref = inter.intersect(scene, so, wl, tmin, tmax)
    assert torch.equal(got.is_hit, ref.is_hit)
    assert 0 < int(got.is_hit.sum()) < int(h.is_hit.sum())


@pytest.mark.parametrize("any_hit", [False, True])
def test_bundle_kernel_copies(setup, dev, any_hit):
    """Kernel A's bundle walk on the copies schedule (tests/bundle_cases.py:
    rows of 4 copies of every window, staged in at least 4 chunks of 64
    pairs, every hit a tie at equal t across copies; a tile of 0 live rays
    and one of 1; NaN t_min, t_max and origins, t_max == t_min; NaN sub
    boxes; a tile with no pair; padding pairs) against its plain twin, bit
    for bit (t, slot, u, v, Woop tests; NaN equal to NaN), one launch; the
    earliest copy wins; the sequential warp walk gives the same hits
    (any-hit: slots; nearest: the hit rule)."""
    from bundle_cases import check_copies, copies_schedule, same_bits
    _, inter, o, d, _, _ = setup
    o, d = o[5 * 1024:], d[5 * 1024:]    # from the image's tile (1, 1) on
    n = o.shape[0]
    inp = copies_schedule(inter.clusters, o, d,
                          torch.full((n,), 1e-3, device=dev),
                          torch.full((n,), 1e16, device=dev), 256)
    assert int((inp["pair_tiles"] == 0).sum()) >= 4 * 64
    kw = dict(w=256, any_hit=any_hit, common=None, visits=True)
    before = _lib.TILE_RASTER.launches
    kern = tr.raster_cluster_call(**inp, **kw)
    assert _lib.TILE_RASTER.launches == before + 1
    plain = tr.raster_cluster_plain(**inp, **kw)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        assert same_bits(a, b)
    check_copies(inp, kern, 256)
    old = tr._raster_plain(inp, 256, any_hit, None)
    if any_hit:
        assert torch.equal(kern[1], old[1])
    else:
        def prims(slot):    # the copy's own slot: copies hold equal rows
            slot = slot.reshape(-1)
            return _prims(inter.clusters, torch.where(
                slot < 0, -1, slot % (inter.clusters.num_clusters * 256)))

        assert hit_mismatches(prims(kern[1]), kern[0].reshape(-1),
                              prims(old[1]), old[0].reshape(-1)) == 0


@pytest.mark.parametrize("coherent", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_hier_kernel(setup, dev, coherent, any_hit):
    """Kernel F against its plain version, and against kernel B, on the
    same sorted wave; its visits count each warp's Woop-tested rows, and
    on a nearest-hit wave they cover the work its answers need (an
    occlusion march may stop at any hit, so needed_work bounds it from
    neither side)."""
    scene, inter, o, d, oi, di = setup
    cs = inter.clusters
    wo, wd = (o, d) if coherent else (oi, di)
    n = wo.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 0.5 if any_hit else 1e16, device=dev)
    perm = torch.argsort(ray_probe_keys(cs, wo, wd, tmin, tmax), stable=True)
    inp = bm.hier_inputs(cs, wo[perm], wd[perm], tmin, tmax, coherent)
    before = _lib.BLOCK_MARCH_HIER.launches
    kern = bm.march_hier_call(**inp, any_hit=any_hit)
    assert _lib.BLOCK_MARCH_HIER.launches == before + 1
    rays = inp["rays"]
    assert kern[2].shape == (rays.shape[1] // 32,)
    plain = bm.march_hier_plain(**{k: v for k, v in inp.items() if k != "w"},
                                any_hit=any_hit)
    if not any_hit:
        work = bm.needed_work(rays, *plain, inp["boxes"], inp["sub_boxes"],
                              inp["n_clusters"], inp["n_subs"],
                              sup_boxes=inp["sup_boxes"])
        assert int(kern[2].sum()) * 32 >= work["woop"] > 0
    flat = bm.march_call(**bm.march_inputs(cs, wo[perm], wd[perm], tmin,
                                           tmax, coherent, 128),
                         any_hit=any_hit)
    if any_hit:
        assert torch.equal(kern[1] >= 0, plain[1] >= 0)
        assert torch.equal(kern[1] >= 0, flat[1] >= 0)
    else:
        _check(cs, kern, plain)
        _check(cs, kern, flat)


@pytest.fixture(scope="module")
def slivers(dev):
    """A ClusterSet past F's 512-key list: 1,228,800 thin triangles (0.035
    wide) stacked along x, 1e-4 apart, each along one of the lines
    y - z = c (c in -3.5, -2.5, ..., 3.5) across all of y in [-1, 17], so
    every cluster's and supercluster's box holds [-1, 17] x [4, 12] of the
    y-z plane, then a wall; 2,048 rays run along +x near the grid points
    of [4, 12]^2 (32 different points per warp), 0.35 or more from every
    line, and hit only the wall: 4,801 clusters in 601 superclusters,
    every one of them needed by every warp."""
    from optix_ray_tracer_tpu_torch.ops.sweep import build_clusters
    n = 4800 * 256
    r = np.random.default_rng(12)
    x = 1e-4 * np.arange(n)
    c = np.arange(n) % 8 - 3.5
    tri = np.stack([np.stack([x, np.full(n, -1.0), -1.0 - c], -1),
                    np.stack([x, np.full(n, 17.0), 17.0 - c], -1),
                    np.stack([x, np.full(n, 8.025), 7.975 - c], -1)], 1)
    xw = 1e-4 * n + 1.0
    wall = np.array([[[xw, -1, -1], [xw, 17, -1], [xw, -1, 17]],
                     [[xw, 17, -1], [xw, 17, 17], [xw, -1, 17]]])
    cs = build_clusters(np.concatenate([tri, wall]), device=dev)
    R = 2048
    point = (np.arange(R) + np.arange(R) // 32 * 7) % 81
    o = np.stack([np.full(R, -1.0), point // 9 + 4.0 + r.normal(0, 0.01, R),
                  point % 9 + 4.0 + r.normal(0, 0.01, R)], -1)
    d = np.concatenate([np.ones((R, 1)), r.normal(0, 1e-4, (R, 2))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return cs, torch.as_tensor(o.astype(np.float32), device=dev), \
        torch.as_tensor(d.astype(np.float32), device=dev)


@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_hier_overflow(slivers, dev, any_hit):
    """Kernel F where every warp's candidate superclusters overflow its
    512-key list: held against kernel B on the same wave by the hit rule
    (hit / miss for occlusion), every ray on the wall."""
    cs, o, d = slivers
    n = o.shape[0]
    assert cs.num_clusters > 4096
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 1e16, device=dev)
    inp = bm.hier_inputs(cs, o, d, tmin, tmax)
    kern = bm.march_hier_call(**inp, any_hit=any_hit)
    flat = bm.march_call(**bm.march_inputs(cs, o, d, tmin, tmax, True, 128),
                         any_hit=any_hit)
    _hold(kern, flat, any_hit)
    assert bool((kern[1][:n] >= 0).all())
    # the precondition: superclusters some lane of a warp needs, per warp
    rays = inp["rays"]
    t, slot, _ = bm.march_call(**bm.march_inputs(cs, o, d, tmin, tmax, True,
                                                 128))
    n_sup = -(-cs.num_clusters // bm.GROUP)
    ent = bm._entries(inp["sup_boxes"][:n_sup], rays[0:3].T,
                      bm.inv_dir(rays[3:6].T), rays[6])
    reach = torch.where(slot >= 0, torch.nextafter(
        t, torch.full_like(t, float("inf"))), rays[7])
    need = (ent < reach[:, None]).reshape(-1, 32, n_sup).any(1)
    assert int(need.sum(1).min()) > 512


def test_routing_on_card(setup, dev, monkeypatch):
    """block_march sends coherent waves past HIER_MIN_CLUSTERS to F."""
    scene, inter, o, d, _, _ = setup
    monkeypatch.setattr(bm, "HIER_MIN_CLUSTERS", 8)
    before = (_lib.BLOCK_MARCH.launches, _lib.BLOCK_MARCH_HIER.launches)
    h = inter.intersect(scene, o, d)
    assert (_lib.BLOCK_MARCH.launches, _lib.BLOCK_MARCH_HIER.launches) == \
        (before[0], before[1] + 1)
    monkeypatch.setattr(bm, "HIER_MIN_CLUSTERS", 3072)
    h_b = inter.intersect(scene, o, d)
    assert hit_mismatches(h.prim_id, h.t, h_b.prim_id, h_b.t) == 0


@pytest.mark.parametrize("wave", ["camera", "incoherent"])
def test_leaf_sweep_kernel(setup, dev, wave):
    """Kernel G against its plain version on the first sweep pass's
    blocks (as chip_smoke.py builds them), then on the same blocks with
    two filler-only blocks appended (as ops/sweep.py pads a window group:
    o 0, d +z, t_min 1, best t 0), every fifth ray dead (t_min = best t)
    and the most-hit row copied onto the next one: t, slot, u and v equal;
    filler and dead lanes keep their inputs, and the copy never wins (the
    first row wins on equal t)."""
    from chip_smoke import first_pass_blocks
    from optix_ray_tracer_tpu_torch.ops.kernels import leaf_sweep as ls
    _, inter, o, d, oi, di = setup
    wo, wd = (o, d) if wave == "camera" else (oi, di)
    args = first_pass_blocks(inter.clusters, wo, wd)
    before = _lib.LEAF_SWEEP.launches
    kern = ls.window_sweep_call(*args)
    assert _lib.LEAF_SWEEP.launches == before + 1
    plain = ls.window_sweep_plain(*args)
    torch.cuda.synchronize()
    assert int((kern[1] >= 0).sum()) > 0
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)

    woop, starts, o, d, t_min, best = args
    nb, B = o.shape[:2]

    def pad(x, value):
        return torch.cat([x, torch.full((2,) + x.shape[1:], value,
                                        dtype=x.dtype, device=dev)])

    d = pad(d, 0.0)
    d[nb:, :, 2] = 1.0
    best = (pad(best[0], 0.0), pad(best[1], -1), pad(best[2], 0.0),
            pad(best[3], 0.0))
    t_min = pad(t_min, 1.0)
    t_min[:, ::5] = best[0][:, ::5]
    keep = torch.zeros((nb + 2, B), dtype=torch.bool, device=dev)
    keep[nb:] = True
    keep[:, ::5] = True
    hits = kern[1][(kern[1] >= 0) & (kern[1] % 256 != 255)]
    r = int(torch.bincount(hits).argmax())
    woop = woop.clone()
    woop[r + 1] = woop[r]
    edge = (woop, pad(starts, 0), pad(o, 0.0), d, t_min, best)
    kern = ls.window_sweep_call(*edge)
    plain = ls.window_sweep_plain(*edge)
    torch.cuda.synchronize()
    for a, b, x in zip(kern, plain, best):
        assert torch.equal(a, b)
        assert torch.equal(a[keep], x[keep])
    assert bool((kern[1] == r).any()) and not bool((kern[1] == r + 1).any())


@pytest.mark.parametrize("wave", ["camera", "incoherent"])
def test_sweep_intersector_vs_marcher(setup, dev, wave):
    """SweepIntersector (kernel G) against the marcher on the card: the
    hit rule with no exceptions, and every ray finished."""
    from optix_ray_tracer_tpu_torch.ops.sweep import SweepIntersector
    scene, inter, o, d, oi, di = setup
    wo, wd = (o, d) if wave == "camera" else (oi, di)
    si = SweepIntersector(clusters=inter.clusters, log=[])
    before = _lib.LEAF_SWEEP.launches
    h = si.intersect(scene, wo, wd)
    ref = inter.intersect(scene, wo, wd)
    assert _lib.LEAF_SWEEP.launches > before
    assert not si.log[0].unfinished

    def keys(x):
        return torch.where(x.is_hit, x.prim_id, -1)
    assert hit_mismatches(keys(h), h.t, keys(ref), ref.t) == 0


@pytest.mark.parametrize("name", ["atrous", "neural"])
def test_denoiser_card_vs_cpu(dev, name):
    """The a-trous and KPCN denoisers on the card against the same call on
    the CPU copy (128x96 inputs): within tests/test_torch_denoise.py's
    relative tolerances (8e-6 a-trous, 2.4e-5 KPCN; measured on the H100
    here: 2.5e-6 and 6.2e-6)."""
    from optix_ray_tracer_tpu_torch.render.denoise import denoise
    from optix_ray_tracer_tpu_torch.render.neural_denoise import (
        denoise_neural,
    )
    r = np.random.default_rng(4)
    h, w = 96, 128
    color = torch.as_tensor(r.gamma(4.0, 0.2, (h, w, 3)).astype(np.float32))
    alb = torch.as_tensor(r.uniform(0.05, 0.9, (h, w, 3)).astype(np.float32))
    nrm = r.normal(size=(h, w, 3))
    nrm[..., 2] += 2.0
    nrm = torch.as_tensor((nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
                           ).astype(np.float32))
    alb[:8] = 0.0
    nrm[:8] = 0.0
    fn, rtol = ((denoise, 8e-6) if name == "atrous"
                else (denoise_neural, 2.4e-5))
    got = fn(color.to(dev), alb.to(dev), nrm.to(dev)).cpu()
    want = fn(color, alb, nrm)
    assert bool(((got - want).abs() <= rtol * want.abs()).all())


@pytest.mark.parametrize("op", ["refit", "median", "morton"])
def test_refit_rebuild_on_card(dev, op):
    """The device refit and rebuild on the card against the same call on
    CPU tensors: the ClusterSet, bounds and raster tables bit for bit
    (the same float32 and float64 operations, the same stable sorts);
    then the moved scene's hits through the kernels against the plain
    versions on the CPU, under the hit rule."""
    from optix_ray_tracer_tpu_torch import convert
    from optix_ray_tracer_tpu_torch.ops import march

    v, n = sphere_with_n_triangles(20000)
    r = np.random.default_rng(8)
    v2 = (v * 1.2 + r.normal(0.0, 0.01, v.shape)).astype(np.float32)
    cpu = torch.device("cpu")
    scenes = {d: [Scene(Spheres.empty(d), Triangles.from_arrays(x, n,
                                                                device=d))
                  for x in (v, v2)] for d in (dev, cpu)}
    base = make_march_intersector(scenes[cpu][0], raster=True)
    out = {}
    for d in (dev, cpu):
        prev = base.to(d)
        if op == "refit":
            out[d] = march.refit_march_intersector(prev, scenes[d][1])
        else:
            out[d] = march.rebuild_march_intersector(prev, scenes[d][1],
                                                     method=op)
    got, want = (convert.state_arrays(out[d].to(cpu)) for d in (dev, cpu))
    for part in ("clusters", "raster"):
        for k, a in want[part].items():
            np.testing.assert_array_equal(got[part][k], a, err_msg=k)
    for k in ("scene_lo", "scene_hi"):
        np.testing.assert_array_equal(got[k], want[k])
    cam = Camera.look_at((3.0, 0.3, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=dev)
    o, d = (x.reshape(-1, 3) for x in cam.generate_rays(64, 64))
    o = o + torch.as_tensor(r.normal(0.0, 0.5, o.shape).astype(np.float32),
                            device=o.device)
    hits = [out[x].intersect(scenes[x][1], o.to(x), d.to(x))
            for x in (dev, cpu)]
    assert hit_mismatches(hits[0].prim_id.cpu(), hits[0].t.cpu(),
                          hits[1].prim_id, hits[1].t) == 0
    assert bool(hits[1].is_hit.any())


def test_frontend_on_card_matches_cpu(dev, tmp_path):
    """A Time series over 1024 triangles through the default fused loop
    (host build, device rebuild per file, refit per frame, the temporal
    blend, a-trous, quantisation) with ``device=None`` on the card, then
    on the CPU: the frames agree by tests/test_torch_frontends.py's rule
    for the port against the JAX package (mean |diff| <= 1e-5, 99.9% of
    pixels within 1e-4), and the card's run launched kernels B, C, F."""
    import json

    import chip_smoke as cs
    from optix_ray_tracer_tpu_torch.io.config import parse_config_dict
    from optix_ray_tracer_tpu_torch.models import renderer_time

    poses = cs.pile_poses(10, cs.ANIM_TIMES)
    for p in poses:
        p["pos"] = p["pos"] * 0.15
        p["vel"] = p["vel"] * 0.15
    series, stl = cs.write_time_series(
        tmp_path / "time", [sphere_with_n_triangles(s)
                            for s in cs.TIME_LIBRARY], poses, cs.ANIM_TIMES)
    cfg = json.loads(cs.write_anim_config(
        tmp_path / "c.json", series, stl, tmp_path / "cache", 64, 48, 8
    ).read_text())
    cfg["loop-data"].update({"camera-center": [6.0, 1.0, 2.0],
                             "camera-target": [0.0, 0.0, -0.5]})
    config = parse_config_dict(cfg, base_dir=str(tmp_path))
    for k in _lib.KERNELS:
        k.launches = 0
    frames = []
    for device in (None, "cpu"):
        data = renderer_time.commit(config, device=device)
        frames.append([f.mean().cpu() for _, _, f in
                       renderer_time.render_frames(data, max_frames=4)])
    assert min(_lib.BLOCK_MARCH.launches, _lib.PROBE.launches,
               _lib.BLOCK_MARCH_HIER.launches + _lib.TILE_RASTER.launches) > 0
    for a, b in zip(*frames, strict=True):
        diff = (a - b).abs()
        assert float(diff.mean()) <= 1e-5
        assert float((diff.amax(-1) <= 1e-4).float().mean()) >= 0.999


def test_sobol_streams_card_equal_cpu(dev):
    """utils/qmc on the card: the same uint32 streams and uniforms as on
    the CPU, bit for bit (negative ids and bounces, samples past 2^16)."""
    from optix_ray_tracer_tpu_torch.utils import qmc, rng

    r = np.random.default_rng(5)
    pix = torch.as_tensor(r.integers(-(1 << 20), 1 << 22, 1 << 16))
    samp = torch.as_tensor(r.integers(0, 1 << 20, 1 << 16))
    words = torch.as_tensor(r.integers(0, 1 << 32, 1 << 16))
    assert torch.equal(qmc.owen_scramble(words.to(dev), 0x9E3779B9).cpu(),
                       qmc.owen_scramble(words, 0x9E3779B9))
    for d in range(6):
        assert torch.equal(qmc.sobol_u32(words.to(dev), d).cpu(),
                           qmc.sobol_u32(words, d))
    for b in (-2, -1, 0, 5):
        card = rng.uniform4(pix.to(dev), samp.to(dev), b, 7 ^ 0x5851F42D,
                            "sobol")
        cpu = rng.uniform4(pix, samp, b, 7 ^ 0x5851F42D, "sobol")
        for a, c in zip(card, cpu):
            assert torch.equal(a.cpu(), c)
        a = rng.stratified_jitter(pix.to(dev), samp.to(dev), 3, "sobol")
        c = rng.stratified_jitter(pix, samp, 3, "sobol")
        assert all(torch.equal(x.cpu(), y) for x, y in zip(a, c))


def _lit_scene(device):
    """A 4,000-triangle metal sphere and a ROUGH floor under a 2x2 lamp
    (>= 16 clusters, a raster-enabled marcher's scene)."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mb = MaterialBuilder()
    floor = mb.add_rough((0.8, 0.8, 0.8))
    body = mb.add_rough((0.7, 0.4, 0.3))
    lamp = mb.add_emissive((6.0, 6.0, 6.0))
    v, n = sphere_with_n_triangles(4000, (0, 0, 0.5), 0.5)
    fv, fn = quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0])
    lv, ln = quad([-1, -1, 2], [-1, 1, 2], [1, 1, 2], [1, -1, 2])
    mats = np.r_[np.full(2, floor), np.full(len(v), body),
                 np.full(2, lamp)].astype(np.int32)
    scene = Scene(Spheres.empty(device), Triangles.from_arrays(
        np.concatenate([fv, v, lv]), np.concatenate([fn, n, ln]), mats,
        device=device))
    m = mb.build(device)
    cam = Camera.look_at((3.0, 0.5, 1.5), (0.0, 0.0, 0.4), (0.0, 0.0, 1.0),
                         device=device)
    return scene, m, cam, collect_area_lights(scene, m)


@pytest.mark.parametrize("integrator", ["restir", "restir-gi"])
def test_restir_frame_card_vs_cpu(dev, integrator):
    """A ReSTIR frame (2 samples, the reservoirs carried, Sobol) through
    render_frame with a raster-enabled marcher on the card and on the
    CPU: >= 99% of pixels within 1e-4 (a 1-ulp weight may flip a
    reservoir pick, tests/test_torch_restir.py) and the means within 1%;
    the card's run launched B and C (ReSTIR's camera wave is a plain
    coherent query, as in the JAX package, not the raster engine's)."""
    from types import SimpleNamespace

    from optix_ray_tracer_tpu_torch.models.common import render_frame

    cfg = SimpleNamespace(integrator=integrator, background=(0.1, 0.1, 0.2),
                          max_depth=3, sampler="sobol", denoise=False)
    imgs = []
    for device in (dev, "cpu"):
        scene, m, cam, lights = _lit_scene(device)
        inter = make_march_intersector(scene, raster=True)
        for k in _lib.KERNELS:
            k.launches = 0
        img = render_frame(cfg, scene, m, cam, 64, 48, 2, 3, inter,
                           lights=lights, sample_offset=16)[0]
        if device == dev:
            launched = [_lib.BLOCK_MARCH.launches, _lib.PROBE.launches]
        imgs.append(img.cpu())
    assert min(launched) > 0, launched
    a, b = imgs
    assert torch.isfinite(a).all() and float(a.mean()) > 0
    within = float(((a - b).abs().amax(-1) <= 1e-4).float().mean())
    assert within >= 0.99, within
    assert abs(float(a.mean()) - float(b.mean())) <= 0.01 * float(b.mean())


def test_adaptive_ids_card_equal_cpu(dev):
    """The error map of the same film is bit-equal on the card and the
    CPU, and a sequence of Whitted adaptive batches selects the same
    pixels and counts on both."""
    from optix_ray_tracer_tpu_torch.render import adaptive

    r = np.random.default_rng(2)
    n = 40 * 30
    cnt = torch.as_tensor(r.integers(0, 9, n), dtype=torch.int32)
    acc = torch.as_tensor(r.random((n, 3)), dtype=torch.float32) * cnt[:, None]
    ss = torch.as_tensor(r.random(n), dtype=torch.float32) * cnt * 1.3
    film = adaptive.AdaptiveFilm(acc, ss, cnt, acc, acc, 40, 30)
    for rel in (False, True):
        assert torch.equal(adaptive.error_map(film.to(dev), rel).cpu(),
                           adaptive.error_map(film, rel))
    runs = []
    for device in (dev, "cpu"):
        scene, m, cam, lights = _lit_scene(device)
        inter = make_march_intersector(scene, raster=True)
        f = adaptive.AdaptiveFilm.create(40, 30, device)
        ids = []
        for k in (n, n, 300, 300, 123):
            ids.append(adaptive.select_pixels(f, k).cpu())
            f = adaptive.adaptive_batch(scene, m, lights, cam, f, k=k,
                                        intersector=inter, max_depth=3,
                                        integrator="whitted", seed=4)
        runs.append((ids, f.count.cpu()))
    (ids_a, cnt_a), (ids_b, cnt_b) = runs
    for a, b in zip(ids_a, ids_b):
        assert torch.equal(a, b)
    assert torch.equal(cnt_a, cnt_b)


@pytest.mark.parametrize("tile,sample", [(4, 1), (2, 2)])
def test_sharded_render_on_card(setup, dev, tile, sample):
    """``render_sharded`` on a mesh of cuda:0 repeated against
    ``wavefront.render`` on the card: > 2 LSB on < 1% of the channels
    (phase 7's rule; 32- and 64-row bands take the raster engine as the
    full frame does), and the bands launched A, B and C."""
    from optix_ray_tracer_tpu_torch.parallel.sharding import (
        make_mesh, render_sharded,
    )
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
    from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8

    scene, inter = setup[:2]
    mb = MaterialBuilder()
    mb.add_metal((0.8, 0.85, 0.88), 0.05)
    mats = mb.build(dev)
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    ref = wavefront.render(scene, mats, cam, 128, 128, spp=4, seed=2,
                           max_depth=3, intersector=inter)[0]
    for k in _lib.KERNELS:
        k.launches = 0
    img = render_sharded(scene, mats, cam, 128, 128, 4,
                         make_mesh(tile, sample, [dev] * (tile * sample)),
                         seed=2, max_depth=3, intersector=inter)
    launched = [_lib.TILE_RASTER.launches, _lib.BLOCK_MARCH.launches,
                _lib.PROBE.launches]
    assert min(launched) > 0, launched
    assert img.device == ref.device and torch.isfinite(img).all()
    qa, qb = (color_to_uint8(x)[..., :3].int() for x in (img, ref))
    assert float(((qa - qb).abs() > 2).float().mean()) < 0.01


def test_training_step_on_card(dev):
    """One Adam step of ``render/train_denoiser`` on the card against the
    same step on the CPU, from the same parameters on the same batch: the
    loss to relative 1e-4, the gradients to relative 1e-3 (cuDNN's and
    oneDNN's convolutions sum in their own orders), and the updated
    parameters to 1e-6 where |g| >= 1e-5.  The first Adam step is
    lr * g / (|g| + 1e-8): where |g| is near eps a relative 1e-3 in g
    moves the step by up to ~1e-5 of its 2e-3, so those entries are held
    by their gradients alone."""
    from optix_ray_tracer_tpu_torch.render import neural_denoise as nd
    from optix_ray_tracer_tpu_torch.render import train_denoiser as td

    r = np.random.default_rng(0)
    batch = [r.random((4, 32, 32, 3)).astype(np.float32) for _ in range(4)]
    out = []
    for device in (dev, torch.device("cpu")):
        model = nd.KPCN.from_arrays(nd.init_params(0), device).train()
        opt = td.make_optimizer(model, 2e-3)
        loss = td.loss_fn(model, *(torch.as_tensor(a, device=device)
                                   for a in batch))
        loss.backward()
        grads = {wk: conv.weight.grad.detach().permute(2, 3, 1, 0).cpu()
                 .numpy() for wk, _, conv in model._convs()}
        opt.step()
        out.append((float(loss.detach()), grads, model.arrays()))
    (la, ga, pa), (lb, gb, pb) = out
    assert abs(la - lb) <= 1e-4 * abs(lb)
    for k in gb:
        np.testing.assert_allclose(ga[k], gb[k], rtol=1e-3, atol=1e-7,
                                   err_msg=k)
        sure = np.abs(gb[k]) >= 1e-5
        np.testing.assert_allclose(pa[k][sure], pb[k][sure], atol=1e-6,
                                   err_msg=k)


# ---- the bounce loop's kernels: H (PCG4D), I (Sobol-Owen), J (scatter) ---

def _equal(kern, plain):
    """Element-wise equality of two tuples of tensors, NaN equal to NaN:
    the mismatched elements."""
    bad = 0
    for a, b in zip(kern, plain):
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        bad += int((~same).sum())
    return bad


@pytest.mark.parametrize("bounce", [-2, -1, 0, 64])
def test_rng_kernels_equal_plain(dev, bounce):
    """H (uniforms and integer lanes) and I against their plain versions
    on the card on 1M ids, bit for bit: seeds 0, 2^31 - 1 and 0xFFFFFFFF,
    a tensor sample and a scalar one, int64 and int32 pixel ids (negative
    ones among them); each call launches its kernel once."""
    from optix_ray_tracer_tpu_torch.utils import qmc, rng

    r = np.random.default_rng(11)
    pix = torch.as_tensor(r.integers(-(1 << 20), 1 << 24, 1 << 20),
                          device=dev)
    samp = torch.as_tensor(r.integers(0, 1 << 20, 1 << 20), device=dev)
    for seed in (0, 2 ** 31 - 1, 0xFFFFFFFF):
        for s in (samp, 12345):
            for p in (pix, pix.to(torch.int32)):
                before = (_lib.PCG4D.launches, _lib.SOBOL_OWEN4.launches)
                u = rng.uniform4(p, s, bounce, seed)
                lanes = rng.pcg4d(p, s, bounce, seed)
                so = rng.uniform4(p, s, bounce, seed, "sobol")
                assert (_lib.PCG4D.launches, _lib.SOBOL_OWEN4.launches) == (
                    before[0] + 2, before[1] + 1)
                assert _equal(u, rng.uniform4_plain(p, s, bounce, seed)) == 0
                assert _equal(lanes, rng.pcg4d_plain(p, s, bounce, seed)) == 0
                assert _equal(so, qmc.sobol_owen4_plain(p, s, bounce,
                                                        seed)) == 0
                assert u[0].shape == p.shape and so[3].dtype == torch.float32


def _scatter_wave(dev, n, seed):
    """A wave of n hits over every material type (ids past both ends
    clamp), unnormalised normals facing the ray, random front flags, some
    rays with a NaN direction and a zero normal (the +z fallback)."""
    from optix_ray_tracer_tpu_torch.scene.materials import (
        DIELECTRIC, EMISSIVE, METAL, ROUGH, MaterialBuilder,
    )
    mb = MaterialBuilder()
    mb.add(ROUGH, (0.7, 0.6, 0.5))
    mb.add(METAL, (0.8, 0.85, 0.88), 0.3)
    mb.add(METAL, (0.9, 0.9, 0.9), 0.0)
    mb.add(DIELECTRIC, (1, 1, 1), 1.5)
    mb.add(DIELECTRIC, (1, 1, 1), 0.0)
    mb.add(EMISSIVE, (0, 0, 0), 0.0, (4.0, 3.0, 2.0))
    r = np.random.default_rng(seed)
    mid = r.integers(-1, 7, n).astype(np.int32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    flip = (d * nrm).sum(-1) > 0
    nrm[flip] = -nrm[flip]
    d[:64] = np.nan
    nrm[:128:2] = 0.0
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    return (mb.build(dev), t(mid), t(d), t(nrm), t(r.random(n) < 0.5),
            t(r.integers(0, 1 << 22, n)), t(r.integers(0, 64, n)))


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_scatter_kernel_equal_plain(dev, sampler):
    """J against ``scatter_plain`` on the card on a 1M-ray wave with every
    material type, both faces, NaN directions and zero normals: every
    output bit for bit; J launches once."""
    from optix_ray_tracer_tpu_torch.render import wavefront

    args = _scatter_wave(dev, 1 << 20, 3)
    before = _lib.WHITTED_SCATTER.launches
    kern = wavefront.scatter(*args, 1, 0xFFFFFFF0, sampler)
    assert _lib.WHITTED_SCATTER.launches == before + 1
    plain = wavefront.scatter_plain(*args, 1, 0xFFFFFFF0, sampler)
    torch.cuda.synchronize()
    assert kern[3].dtype == torch.bool and kern[0].shape == (1 << 20, 3)
    assert torch.isfinite(kern[0]).all()
    assert _equal(kern, plain) == 0


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_whitted_frame_kernels_vs_cpu(dev, sampler):
    """A small Whitted frame (METAL, ROUGH, DIELECTRIC and EMISSIVE) on
    the card, bounce loop on H (I under Sobol) and J, against its CPU
    render: > 2 LSB on < 1% of channels."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
    from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8

    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.7, 0.6, 0.5))
    glass = mb.add_dielectric(1.5)
    lamp = mb.add_emissive((3.0, 3.0, 3.0))
    v, n = sphere_with_n_triangles(2500)
    qv, qn = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
    tris = Triangles.from_arrays(v, n, metal).concat(
        Triangles.from_arrays(qv, qn, ground))
    imgs = []
    for device in (dev, torch.device("cpu")):
        scene = Scene(Spheres.from_list(
            [((0.2, 1.5, -0.6), 0.4, glass), ((0.5, -1.4, -0.5), 0.3, lamp)],
            device), tris.to(device))
        inter = make_march_intersector(scene, raster=True)
        cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0), device=device)
        for k in _lib.KERNELS:
            k.reset()
        imgs.append(wavefront.render(scene, mb.build(device), cam, 64, 64,
                                     spp=4, seed=7, intersector=inter,
                                     sampler=sampler)[0].cpu())
        if device == dev:
            launched = (_lib.PCG4D.launches, _lib.SOBOL_OWEN4.launches,
                        _lib.WHITTED_SCATTER.launches)
    assert launched[2] == 5 and (launched[1] if sampler == "sobol"
                                 else launched[0]) > 0, launched
    qa, qb = (color_to_uint8(x)[..., :3].int() for x in imgs)
    assert float(((qa - qb).abs() > 2).float().mean()) < 0.01


def test_bounce_kernels_raise_when_the_build_fails(dev, monkeypatch,
                                                  tmp_path):
    """With no library and a build that fails, the public names raise on
    CUDA tensors and never run a plain version."""
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.render import pathtracer
    from optix_ray_tracer_tpu_torch.utils import qmc, rng

    def no_nvcc():
        raise RuntimeError("nvcc not found (forced)")

    def never(*a, **k):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_nvcc", no_nvcc)
    for module, name in ((rng, "uniform4_plain"), (rng, "pcg4d_plain"),
                         (qmc, "sobol_owen4_plain"),
                         (wavefront, "scatter_plain"),
                         (pathtracer, "bsdf_step_plain"),
                         (pathtracer, "nee_sample_plain"),
                         (pathtracer, "nee_add_plain"),
                         (pathtracer, "hit_radiance_plain")):
        monkeypatch.setattr(module, name, never)
    pix = torch.arange(1024, device=dev)
    with pytest.raises(RuntimeError, match="forced"):
        rng.uniform4(pix, pix, 0, 0)
    with pytest.raises(RuntimeError, match="forced"):
        rng.pcg4d(pix, pix, 0, 0)
    with pytest.raises(RuntimeError, match="forced"):
        qmc.sobol_owen4(pix, 3, 0, 0)
    args = _scatter_wave(dev, 1024, 1)
    with pytest.raises(RuntimeError, match="forced"):
        wavefront.scatter(*args, 0, 0)
    with pytest.raises(RuntimeError, match="forced"):
        pathtracer.bsdf_step(*_bsdf_wave(dev, 1024, 1), 3, 0, "sobol", 2)
    lights, maps = _nee_tables(dev)
    wave = _nee_wave(dev, 1024, 1)
    with pytest.raises(RuntimeError, match="forced"):
        pathtracer.nee_sample(*wave, 1, 0, "pcg", lights, maps["sky"])
    z = torch.zeros(1024, 3, device=dev)
    with pytest.raises(RuntimeError, match="forced"):
        pathtracer.nee_add(z, z, wave[2], wave[2], None, None, None)
    with pytest.raises(RuntimeError, match="forced"):
        pathtracer.hit_radiance(*_hit_wave(dev, 1024, 1, lights), 1,
                                torch.zeros(3, device=dev), lights)


# ---- kernel K: the path tracer's BSDF step --------------------------------

def _bsdf_wave(dev, n, seed):
    """The arguments of ``pathtracer.bsdf_step`` before (bounce, seed, ...)
    for a wave of n hits over every material type: unit normals facing
    the ray, random front flags (total internal reflection among them),
    metal fuzz 0 and > 0, ior 1.5 and 0 (the default), throughputs above 1
    (the roulette's clamp), dead lanes, some rays with a NaN direction and
    some with a zero normal."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    flip = (d * nrm).sum(-1) > 0
    nrm[flip] = -nrm[flip]
    d[:64] = np.nan
    nrm[64:128] = 0.0
    mtype = r.integers(0, 4, n).astype(np.int32)
    param = np.where(mtype == 1, r.choice([0.0, 0.05, 0.3], n),
                     r.choice([1.5, 0.0], n)).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    return (t(d), t(nrm), t(r.uniform(-5, 5, (n, 3)).astype(np.float32)),
            t(r.random(n) < 0.5), t(mtype),
            t(r.uniform(0, 1, (n, 3)).astype(np.float32)), t(param),
            t(r.uniform(0, 2.5, (n, 3)).astype(np.float32)),
            t(r.random(n) < 0.85),
            t(r.uniform(-5, 5, (n, 3)).astype(np.float32)),
            t(r.integers(0, 1 << 22, n)), t(r.integers(0, 64, n)))


@pytest.mark.parametrize("bounce", [1, 3])
@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_path_bsdf_kernel_equal_plain(dev, sampler, bounce):
    """K against ``bsdf_step_plain`` on the card on a 1M-ray wave with
    every material type, dead lanes, NaN directions and zero normals, at a
    bounce on each side of rr_start 2: every output bit for bit; K
    launches once."""
    from optix_ray_tracer_tpu_torch.render import pathtracer

    args = _bsdf_wave(dev, 1 << 20, 5)
    before = _lib.PATH_BSDF.launches
    kern = pathtracer.bsdf_step(*args, bounce, 0xFFFFFFF0, sampler, 2)
    assert _lib.PATH_BSDF.launches == before + 1
    plain = pathtracer.bsdf_step_plain(*args, bounce, 0xFFFFFFF0, sampler, 2)
    torch.cuda.synchronize()
    assert kern[4].dtype == torch.bool and kern[1].shape == (1 << 20, 3)
    assert _equal(kern, plain) == 0
    died = int((args[8] & ~kern[4]).sum())
    assert (died > 0) == (bounce >= 2)


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_path_frame_kernels_vs_cpu(dev, sampler):
    """A small path-traced frame (METAL, ROUGH, DIELECTRIC and an area
    light; Russian roulette from bounce 3) on the card, its BSDF steps on
    K and its NEE and MIS on L, M and N, against its CPU render: > 2 LSB
    on < 1% of channels."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.render import pathtracer
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
    from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8

    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.7, 0.6, 0.5))
    glass = mb.add_dielectric(1.5)
    lamp = mb.add_emissive((6.0, 6.0, 6.0))
    v, n = sphere_with_n_triangles(2500)
    qv, qn = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
    lv, ln = quad((-1, -1, 2), (-1, 1, 2), (1, 1, 2), (1, -1, 2))
    tris = Triangles.from_arrays(v, n, metal).concat(
        Triangles.from_arrays(qv, qn, ground)).concat(
        Triangles.from_arrays(lv, ln, lamp))
    imgs = []
    for device in (dev, torch.device("cpu")):
        scene = Scene(Spheres.from_list([((0.2, 1.5, -0.6), 0.4, glass)],
                                        device), tris.to(device))
        mats = mb.build(device)
        cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0), device=device)
        for k in _lib.KERNELS:
            k.reset()
        imgs.append(pathtracer.render_path(
            scene, mats, collect_area_lights(scene, mats), cam, 64, 64,
            spp=4, seed=7, max_depth=5, sampler=sampler,
            intersector=make_march_intersector(scene, raster=True))[0].cpu())
        if device == dev:
            launched = [k.launches for k in (
                _lib.PATH_BSDF, _lib.PATH_NEE_SAMPLE, _lib.PATH_NEE_ADD,
                _lib.PATH_HIT_RADIANCE)]
    assert launched == [4 * 5] * 4, launched
    qa, qb = (color_to_uint8(x)[..., :3].int() for x in imgs)
    assert float(((qa - qb).abs() > 2).float().mean()) < 0.01


# ---- kernels L, M, N: the path tracer's NEE and MIS ----------------------

def _nee_tables(dev):
    """A light table (a small bright and a large dim emitter quad over a
    floor, as tests/test_torch_pathtracer.py's two-light scene) and three
    maps: a sky with a sun, a 12 x 20 map (neither a power of two; its
    second CDF block half padding) and a constant one (no tables)."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.render import envmap
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mb = MaterialBuilder()
    mats = [mb.add_rough((0.7, 0.7, 0.7)), mb.add_emissive((80.0,) * 3),
            mb.add_emissive((0.4,) * 3)]
    parts = [quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]),
             quad([-1.1, 0.1, 2], [-0.9, 0.1, 2], [-0.9, -0.1, 2],
                  [-1.1, -0.1, 2]),
             quad([0, 1, 2], [2, 1, 2], [2, -1, 2], [0, -1, 2])]
    scene = Scene(Spheres.empty(dev), Triangles.from_arrays(
        np.concatenate([q[0] for q in parts]),
        np.concatenate([q[1] for q in parts]),
        np.repeat(np.int32(mats), 2), device=dev))
    img = np.random.default_rng(8).uniform(0.05, 4.0, (12, 20, 3))
    maps = {"sky": envmap.gradient_sky(sun_dir=(0.4, 0.25, 0.88),
                                       device=dev),
            "odd": envmap._with_tables(img.astype(np.float32), dev),
            "constant": envmap.constant_env((0.7, 0.8, 0.9), dev)}
    return collect_area_lights(scene, mb.build(dev)), maps


def _nee_wave(dev, n, seed):
    """The leading arguments of ``pathtracer.nee_sample`` for n shading
    points over the floor and in the lights' plane (edge-on), unit normals
    mostly up, every material type, dead lanes, a NaN point."""
    r = np.random.default_rng(seed)
    pts = np.concatenate([r.uniform(-3, 3, (n, 2)),
                          r.uniform(0, 1.9, (n, 1))], -1).astype(np.float32)
    pts[:256, 2] = 2.0
    pts[256:260] = np.nan
    nrm = r.normal(size=(n, 3)) + [0, 0, 1.5]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    return (t(pts), t(nrm.astype(np.float32)), t(r.random(n) < 0.85),
            t(r.integers(0, 4, n).astype(np.int32)),
            t(r.uniform(0, 2.5, (n, 3)).astype(np.float32)),
            t(r.uniform(0, 1, (n, 3)).astype(np.float32)),
            t(r.integers(0, 1 << 22, n)), t(r.integers(0, 64, n)))


def _hit_wave(dev, n, seed, lights):
    """The leading arguments of ``pathtracer.hit_radiance`` (to
    ``prim_diff``) for n ray ends: missed and hit lanes, prev_pdf 0 or >
    0, EMISSIVE hits on light triangles, other triangles and spheres."""
    from optix_ray_tracer_tpu_torch.ops.intersect import Hit
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    state = r.integers(0, 3, n)
    light_tris = lights.tri_id.cpu().numpy()
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    hit = Hit(t=t(np.where(state == 2, r.uniform(0.1, 5, n),
                           1e16).astype(np.float32)),
              prim_type=t(np.where(r.random(n) < 0.8, 2, 1).astype(
                  np.int32)),
              prim_id=t(np.where(r.random(n) < 0.6, r.choice(light_tris, n),
                                 r.integers(0, 6, n)).astype(np.int32)),
              u=t(np.zeros(n, np.float32)), v=t(np.zeros(n, np.float32)))
    return (t(r.uniform(0, 1, (n, 3)).astype(np.float32)),
            t(d.astype(np.float32)),
            t(np.where(r.random(n) < 0.3, 0.0,
                       r.uniform(0.01, 3, n)).astype(np.float32)),
            t(r.uniform(0, 2.5, (n, 3)).astype(np.float32)), t(state == 1),
            t(state == 2), hit, t(r.integers(0, 4, n).astype(np.int32)),
            t(r.uniform(0, 20, (n, 3)).astype(np.float32)),
            t(r.random(n) < 0.5))


@pytest.mark.parametrize("cap", [0.0, 0.5])
@pytest.mark.parametrize("parts", ["area", "odd", "sky", "both"])
@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_path_nee_kernels_equal_plain(dev, sampler, parts, cap):
    """L against ``nee_sample_plain`` and M against ``nee_add_plain`` on
    the card on a 1M-lane wave (dead, EMISSIVE and other non-ROUGH lanes,
    edge-on and NaN points): every output bit for bit; each launches
    once."""
    from optix_ray_tracer_tpu_torch.render import pathtracer

    lights, maps = _nee_tables(dev)
    n = 1 << 20
    wave = _nee_wave(dev, n, 7)
    lt = lights if parts in ("area", "both") else None
    env = maps["sky"] if parts in ("sky", "both") else (
        maps["odd"] if parts == "odd" else None)
    before = (_lib.PATH_NEE_SAMPLE.launches, _lib.PATH_NEE_ADD.launches)
    kern = pathtracer.nee_sample(*wave, 2, 0xFFFFFFF0, sampler, lt, env, cap)
    plain = pathtracer.nee_sample_plain(*wave, 2, 0xFFFFFFF0, sampler, lt,
                                        env, cap)
    flat = [[x[0]] + [y for part in x[1:] if part for y in part]
            for x in (kern, plain)]
    assert len(flat[0]) == len(flat[1]) == 1 + 4 * (1 + (parts == "both"))
    assert _equal(flat[0], flat[1]) == 0
    valid = [p[3] for p in kern[1:] if p]
    assert all(v.any() and not v.all() for v in valid)
    r = np.random.default_rng(2)
    occ = [torch.as_tensor(r.random(n) < 0.4, device=dev) if p else None
           for p in kern[1:]]
    rad = torch.rand(n, 3, device=dev)
    rad[:64] = -0.0
    args = (rad, *(kern[1][2:] if kern[1] else (None, None)), occ[0],
            *(kern[2][2:] if kern[2] else (None, None)), occ[1])
    got = pathtracer.nee_add(*args)
    want = pathtracer.nee_add_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (_lib.PATH_NEE_SAMPLE.launches, _lib.PATH_NEE_ADD.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("cap", [0.0, 0.5])
@pytest.mark.parametrize("bounce,restir", [(1, False), (0, True), (1, True),
                                           (2, True)])
@pytest.mark.parametrize("env,lights", [(None, True), ("constant", False),
                                        ("sky", True), ("odd", False)])
def test_hit_radiance_kernel_equal_plain(dev, env, lights, bounce, restir,
                                         cap):
    """N against ``hit_radiance_plain`` on the card on a 1M-lane wave: the
    background, a map without tables or with them, the light table's MIS
    or none, ReSTIR's bounce-0 and -1 rules, the clamp: bit for bit; N
    launches once."""
    from optix_ray_tracer_tpu_torch.render import pathtracer

    table, maps = _nee_tables(dev)
    args = _hit_wave(dev, 1 << 20, 3, table) + (
        bounce, torch.tensor([0.2, 0.3, 0.4], device=dev),
        table if lights else None, maps[env] if env else None, cap, restir)
    before = _lib.PATH_HIT_RADIANCE.launches
    got = pathtracer.hit_radiance(*args)
    want = pathtracer.hit_radiance_plain(*args)
    torch.cuda.synchronize()
    assert _lib.PATH_HIT_RADIANCE.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, args[0])


# ---- kernels O-R: the marcher's wave glue and the hit shading frame -------

def _bits(kern, plain):
    """Elements of two tuples of tensors whose bits differ: floats compared
    as int32 words (signed zeros count), any NaN equal to any NaN (its
    sign and payload are the code generator's: a negation may flip a
    NaN's sign bit or not)."""
    bad = 0
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            nan = torch.isnan(a) & torch.isnan(b)
            bad += int(((a.view(torch.int32) != b.view(torch.int32))
                        & ~nan).sum())
        else:
            bad += int((a != b).sum())
    return bad


def _where_bits(kern, plain, hit, o, d, most: int = 8) -> str:
    """The first mismatched elements of two tuples of (n, ...) outputs,
    with their rays and hits, for an assertion message."""
    lines = []
    for k, (a, b) in enumerate(zip(kern, plain)):
        ai, bi = ((a.view(torch.int32), b.view(torch.int32))
                  if a.is_floating_point() else (a, b))
        bad = (ai != bi) & ~(torch.isnan(a) & torch.isnan(b)
                             if a.is_floating_point() else False)
        bad = bad.reshape(a.shape[0], -1).any(-1)
        for i in torch.nonzero(bad)[:most, 0].tolist():
            lines.append(
                f"output {k} ray {i}: kernel {a[i].tolist()} "
                f"{ai[i].tolist()}, plain {b[i].tolist()} {bi[i].tolist()}; "
                f"t {hit.t[i].item()}, type {hit.prim_type[i].item()}, "
                f"id {hit.prim_id[i].item()}, o {o[i].tolist()}, "
                f"d {d[i].tolist()}")
    return "\n".join(lines)


def _glue_wave(dev, n, seed, scene_hi=1.0):
    """n rays around a unit-sized scene: origins in and outside its box,
    on its high corner (Morton cell 1024 clamps to 1023); unit directions
    with zero components among them; a few NaN origins and directions."""
    r = np.random.default_rng(seed)
    o = r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:64] = scene_hi
    d[64:128, 1] = 0.0
    d[128:192] = (0.0, 0.0, -1.0)
    o[192:200, 0] = np.nan
    d[200:208, 2] = np.nan
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    return t(o), t(d)


@pytest.mark.parametrize("mode", ["morton", "probe"])
def test_march_keys_kernel_equal_plain(setup, dev, mode):
    """O against ``march_keys_plain`` on 1M rays with the Morton edge
    values and NaN coordinates: every key bit for bit (Morton keys: the
    sign bit set on some and clear on others), the same stable argsort;
    O launches once."""
    from optix_ray_tracer_tpu_torch.ops.kernels import march_glue as mg
    _, inter, _, _, _, _ = setup
    o, d = _glue_wave(dev, 1 << 20, 1)
    if mode == "probe":
        n = o.shape[0]
        tmin = torch.full((n,), 1e-3, device=dev)
        tmax = torch.full((n,), 1e16, device=dev)
        args = dict(cid=bm.probe_first_cluster(inter.clusters, o, d, tmin,
                                               tmax))
    else:
        args = dict(o=o, lo=inter.scene_lo, hi=inter.scene_hi)
    before = _lib.MARCH_KEYS.launches
    got = mg.march_keys_call(d, **args)
    assert _lib.MARCH_KEYS.launches == before + 1
    want = mg.march_keys_plain(d, **args)
    torch.cuda.synchronize()
    assert _bits((got,), (want,)) == 0
    if mode == "morton":
        assert 0 < int((got >= 0).sum()) < got.numel()
    assert torch.equal(torch.argsort(got, stable=True),
                       torch.argsort(want, stable=True))


@pytest.mark.parametrize("bounds", ["per_ray", "scalar"])
@pytest.mark.parametrize("w", [1, 128, 512])
@pytest.mark.parametrize("perm", [False, True], ids=["identity", "perm"])
def test_gather_rays_kernel_equal_plain(dev, perm, w, bounds):
    """P against ``gather_rays_plain``: a permutation or none, padding
    tails of every width, NaN t_min and +-inf and NaN t_max carried bit
    for bit, bounds per ray or one value broadcast; P launches once."""
    from optix_ray_tracer_tpu_torch.ops.kernels import march_glue as mg
    n = 100_003
    o, d = _glue_wave(dev, n, 2)
    if bounds == "scalar":
        tmin = torch.tensor(1e-3, device=dev).expand(n)
        tmax = torch.tensor(float("inf"), device=dev).expand(n)
    else:
        r = np.random.default_rng(3)
        tmin = torch.as_tensor(r.uniform(0, 1e-2, n).astype(np.float32),
                               device=dev)
        tmax = torch.as_tensor(r.uniform(0, 50, n).astype(np.float32),
                               device=dev)
        tmin[:50] = float("nan")
        tmax[50:100] = float("inf")
        tmax[100:150] = -float("inf")
        tmax[150:160] = float("nan")
    p = torch.randperm(n, device=dev) if perm else None
    before = _lib.GATHER_RAYS.launches
    got = mg.gather_rays_call(o, d, tmin, tmax, p, w)
    assert _lib.GATHER_RAYS.launches == before + 1
    want = mg.gather_rays_plain(o, d, tmin, tmax, p, w)
    torch.cuda.synchronize()
    assert got[0].shape == (8, n + (-n) % w)
    assert (got[1] is None) == (want[1] is None) == (not perm)
    assert _bits([x for x in got if x is not None],
                 [x for x in want if x is not None]) == 0


@pytest.mark.parametrize("perm", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("mode", ["recompute", "any_hit", "given"])
def test_finish_hits_kernel_equal_plain(setup, dev, mode, perm):
    """Q against ``finish_hits_plain`` on a march's (t, slot) over the
    setup's clusters (misses, a padded tail, NaN rays): every Hit field bit
    for bit, read through the inverse of a permutation or in place; Q
    launches once."""
    from optix_ray_tracer_tpu_torch.ops.kernels import march_glue as mg
    _, inter, _, _, _, _ = setup
    cs = inter.clusters
    r = np.random.default_rng(5)
    n, n_pad = 1_000_000, 1_000_448
    slot = r.integers(0, cs.woop.shape[0], n_pad).astype(np.int32)
    slot[r.random(n_pad) < 0.3] = -1
    t = r.uniform(0.01, 9.0, n_pad).astype(np.float32)
    if mode == "any_hit":
        t[slot >= 0] = -1e16
    o = r.normal(size=(n, 3)).astype(np.float32)
    o[:64, 0] = np.nan
    dv = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    uv = {}
    if mode == "given":
        uv = dict(u=dv(r.random(n_pad).astype(np.float32)),
                  v=dv(r.random(n_pad).astype(np.float32)))
    inv = torch.randperm(n, device=dev).to(torch.int32) if perm else None
    args = dict(o=dv(o), d=dv(r.normal(size=(n, 3)).astype(np.float32)),
                woop=cs.woop, inv=inv, any_hit=mode == "any_hit", **uv)
    before = _lib.FINISH_HITS.launches
    got = mg.finish_hits_call(dv(t), dv(slot), cs.prim_index, n, **args)
    assert _lib.FINISH_HITS.launches == before + 1
    want = mg.finish_hits_plain(dv(t), dv(slot), cs.prim_index, n, **args)
    torch.cuda.synchronize()
    assert _bits(got, want) == 0


@pytest.mark.parametrize("tables", ["both", "spheres", "triangles"])
def test_shading_frame_kernel_equal_plain(setup, dev, tables):
    """R against ``shading_frame_plain`` on 1M hits over a scene with
    spheres and triangles, spheres only, triangles only: triangle and
    sphere hits, misses, ids beyond each table, NaN directions; every
    output bit for bit; R launches once."""
    from optix_ray_tracer_tpu_torch.ops import intersect as isect
    scene = setup[0]
    sph = Spheres.from_list([((0.2, 1.5, -0.6), 0.4, 2),
                             ((-1.0, 0.0, 0.3), 0.0, 1),
                             ((0.0, -1.5, 0.0), 0.7, 3)])
    tri = scene.triangles
    if tables == "spheres":
        tri = Triangles.empty()
    scene = Scene(Spheres.empty() if tables == "triangles" else sph, tri)
    n = 1 << 20
    o, d = _glue_wave(dev, n, 6)
    r = np.random.default_rng(7)
    ptype = r.integers(0, 3, n).astype(np.int32)
    pid = r.integers(0, max(scene.sphere_count, scene.triangle_count) + 5,
                     n).astype(np.int32)
    t = np.where(ptype == 0, np.float32(1e16),
                 r.uniform(0.01, 5.0, n)).astype(np.float32)
    dv = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    hit = Hit(dv(t), dv(ptype), dv(pid), dv(r.random(n).astype(np.float32)),
              dv(r.random(n).astype(np.float32)))
    before = _lib.SHADING_FRAME.launches
    got = isect.shading_frame(scene, o, d, hit)
    assert _lib.SHADING_FRAME.launches == before + 1
    want = isect.shading_frame_plain(scene, o, d, hit)
    torch.cuda.synchronize()
    assert _bits(got, want) == 0, _where_bits(got, want, hit, o, d)
    assert got[2].dtype == torch.bool and got[3].dtype == torch.int32


def _twin_route(monkeypatch):
    """The glue of ``MarchIntersector`` and ``shading_frame`` on the twins,
    called explicitly on CUDA tensors."""
    from optix_ray_tracer_tpu_torch.ops import intersect as isect
    from optix_ray_tracer_tpu_torch.ops.kernels import march_glue as mg
    for module, name in ((mg, "march_keys"), (mg, "gather_rays"),
                         (mg, "finish_hits"), (isect, "shading_frame")):
        monkeypatch.setattr(module, name, getattr(module, f"{name}_plain"))


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest",
                                                        "any_hit"])
@pytest.mark.parametrize("route", ["morton", "morton_F", "probe",
                                   "sort_free", "spheres"])
def test_intersect_kernels_equal_twins(setup, dev, monkeypatch, route,
                                       any_hit):
    """``MarchIntersector.intersect`` routed through O, P and Q equals the
    same query with the glue on its twins, every Hit field bit for bit:
    Morton-sorted camera waves on B and on F (HIER_MIN_CLUSTERS lowered),
    probe-sorted incoherent waves (P twice), sort-free waves of a
    1,000-triangle sphere, and a scene with analytic spheres; 8,191 rays,
    dead lanes and NaN t_min among them."""
    scene, inter, o, d, oi, di = setup
    if route == "morton_F":
        monkeypatch.setattr(bm, "HIER_MIN_CLUSTERS", 8)
    if route == "sort_free":
        v, n_ = sphere_with_n_triangles(1000)
        scene = Scene(Spheres.empty(), Triangles.from_arrays(v, n_))
        inter = make_march_intersector(scene)
    if route == "spheres":
        scene = Scene(Spheres.from_list([((0.0, 0.0, 1.1), 0.3, 0)]),
                      scene.triangles)
    if route in ("probe", "spheres"):
        inter = inter.for_incoherent()
    wo, wd = (o, d) if route.startswith("morton") else (oi, di)
    wo, wd = wo[:8191], wd[:8191]
    n = wo.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmin[::97] = float("nan")
    camera = route.startswith("morton")
    tmax = torch.full((n,), (2.5 if camera else 0.8) if any_hit else 1e16,
                      device=dev)
    tmax[::7] = 0.0
    counts = lambda: [k.launches for k in (   # noqa: E731
        _lib.MARCH_KEYS, _lib.GATHER_RAYS, _lib.FINISH_HITS, _lib.PROBE,
        _lib.BLOCK_MARCH, _lib.BLOCK_MARCH_HIER)]
    before = counts()
    got = inter.intersect(scene, wo, wd, tmin, tmax, _any_hit=any_hit)
    ran = [a - b for a, b in zip(counts(), before)]
    sort = route != "sort_free"
    probe = route in ("probe", "spheres")
    assert ran == [int(sort), 1 + int(probe), 1, int(probe),
                   int(route != "morton_F"), int(route == "morton_F")]
    with monkeypatch.context() as m:
        _twin_route(m)
        want = inter.intersect(scene, wo, wd, tmin, tmax, _any_hit=any_hit)
        assert counts()[:3] == [b + r for b, r in zip(before, ran)][:3]
    torch.cuda.synchronize()
    fields = lambda h: (h.t, h.prim_type, h.prim_id, h.u, h.v)  # noqa: E731
    assert _bits(fields(got), fields(want)) == 0
    assert 0 < int(got.is_hit.sum()) < n


def test_glue_kernels_raise_when_the_build_fails(setup, dev, monkeypatch,
                                                 tmp_path):
    """With no library and a build that fails, intersect and shading_frame
    raise on CUDA tensors and never run a twin of O-R."""
    from optix_ray_tracer_tpu_torch.ops import intersect as isect
    from optix_ray_tracer_tpu_torch.ops.kernels import march_glue as mg

    def no_nvcc():
        raise RuntimeError("nvcc not found (forced)")

    def never(*a, **k):
        raise AssertionError("a plain version ran")

    scene, inter, o, d, oi, di = setup
    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_nvcc", no_nvcc)
    for module, name in ((mg, "march_keys_plain"), (mg, "gather_rays_plain"),
                         (mg, "finish_hits_plain"),
                         (isect, "shading_frame_plain")):
        monkeypatch.setattr(module, name, never)
    with pytest.raises(RuntimeError, match="forced"):
        inter.intersect(scene, o, d)
    with pytest.raises(RuntimeError, match="forced"):
        inter.for_incoherent().any_hit(scene, oi, di)
    n = oi.shape[0]
    f = torch.zeros(n, device=dev)
    i = torch.zeros(n, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="forced"):
        isect.shading_frame(scene, oi, di, Hit(f, i, i, f, f))


# ---- S, T, U: the raster binning -------------------------------------------

def _bin_equal(kern, plain):
    """Two binning outputs (tensors, tuples of them or stage dicts) equal
    element for element: floats by value, NaN equal to NaN (a zero's sign
    is a reduction's choice of operand, which compares equal)."""
    if isinstance(kern, dict):
        assert kern.keys() == plain.keys()
        for k in kern:
            _bin_equal(kern[k], plain[k])
        return
    if isinstance(kern, (tuple, list)):
        for a, b in zip(kern, plain, strict=True):
            _bin_equal(a, b)
        return
    if not isinstance(kern, torch.Tensor):
        assert kern == plain
        return
    assert kern.shape == plain.shape and kern.dtype == plain.dtype
    same = kern == plain
    if kern.is_floating_point():
        same |= torch.isnan(kern) & torch.isnan(plain)
    assert bool(same.all()), (kern[~same][:8], plain[~same][:8])


def _bin_counts():
    return [k.launches for k in (_lib.BIN_RECTS, _lib.BIN_COUNT,
                                 _lib.BIN_EMIT)]


def _stage_both(monkeypatch, run):
    """(the stage ``run()`` on S, T and U, the same with their twins called
    explicitly on the same CUDA tensors, the kernels' launches)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    before = _bin_counts()
    got = run()
    ran = [a - b for a, b in zip(_bin_counts(), before)]
    with monkeypatch.context() as m:
        for name, twin in binning.TWINS.items():
            m.setattr(binning, name, getattr(binning, twin))
        want = run()
    assert _bin_counts() == [b + r for b, r in zip(before, ran)]
    torch.cuda.synchronize()
    return got, want, ran


def _bin_wave(setup, dev, mode):
    """A 16,384-ray wave of the 20k-triangle sphere in 32x32 tiles, block
    3 dead and every 13th ray dead: the camera wave ("origin"), segments
    from its hits toward a point light ("target", "bundle") or along a
    sun direction ("ortho").  (o, d, t_min, t_max, point)."""
    scene, inter, o, d, _, _ = setup
    n = o.shape[0]
    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    dead[3 * 1024:4 * 1024] = True
    dead[::13] = True
    tmin = torch.full((n,), 1e-3, device=dev)
    if mode == "origin":
        return o, d, tmin, torch.where(dead, 0.0, 1e16), o[0]
    h = inter.intersect(scene, o, d)
    p = torch.where(h.is_hit[:, None], o + h.t[:, None] * d, o)
    if mode == "ortho":
        sun = torch.tensor([0.3, 0.2, 0.9], device=dev)
        sun = sun / torch.linalg.norm(sun)
        return (p + sun * 1e-3, sun.expand(n, 3), tmin,
                torch.where(dead | ~h.is_hit, 0.0, 1e16), None)
    light = torch.tensor([2.0, 1.5, 2.5], device=dev)
    wl = light - p
    dist = torch.linalg.norm(wl, dim=-1)
    wl = wl / dist[:, None]
    return (p + wl * 1e-3, wl, tmin, torch.where(dead, 0.0, dist - 1e-3),
            light)


@pytest.mark.parametrize("pc", ["fits", "overflows"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("mode", ["origin", "target", "ortho", "bundle",
                                  "bundle_flat"])
def test_binning_kernels_equal_plain(setup, dev, monkeypatch, mode, g, pc):
    """S, T and U against their twins on the same CUDA inputs, every
    output equal: each kernel alone (S's rects, T's ray pack, bounds,
    counts, offsets and hit mask, U's schedule from T's outputs), then
    the whole stage (``_coarse_stage`` or ``bundle_stage``), one launch
    of each, at a capacity above the pair count (the padded tail) and
    below it (the cut)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    scene, inter, *_ = setup
    o, d, tmin, tmax, point = _bin_wave(setup, dev, mode)
    bundle = mode.startswith("bundle")
    octants = mode == "bundle"
    W = 1024
    if bundle:
        run = lambda pc_max: raster.bundle_stage(   # noqa: E731
            inter.clusters, o, d, tmin, tmax, W, pc_max,
            dir_octants=octants, granularity=g)
    else:
        run = lambda pc_max: raster._coarse_stage(   # noqa: E731
            inter.raster, inter.clusters, o, d, tmin, tmax, mode, point, W,
            pc_max, g)
    total = int(run(8)["pc_total"])
    assert total > 0
    pc_max = total + 517 if pc == "fits" else total * 2 // 3
    got, want, ran = _stage_both(monkeypatch, lambda: run(pc_max))
    assert ran == [1, 1, 1]
    _bin_equal(got, want)
    assert int(got["cnt_b"][3]) == 0
    if pc == "fits":
        assert not bool(got["validc"][total:].any())
    # each kernel alone on the same inputs (S with its own basis)
    if bundle:
        args = (binning.RECTS_BOX, inter.clusters.sub_min,
                inter.clusters.sub_max)
        p = None
    else:
        p = None if mode == "ortho" else point
        args = (binning.RECTS_CLUSTER, inter.raster.verts)
    kw = dict(point=p, granularity=g, d=d)
    *rects, basis = binning.bin_rects_call(*args, **kw)
    _bin_equal((*rects, basis), binning.bin_basis_rects_plain(*args, **kw))
    tm = "bundle" if bundle else mode
    counted = binning.bin_count_call(o, d, tmin, tmax, W, tm, *rects,
                                     basis, p if mode == "target" else None,
                                     octants)
    _bin_equal(counted, binning.bin_count_plain(
        o, d, tmin, tmax, W, tm, *rects, basis,
        p if mode == "target" else None, octants))
    _, cnt_b, offs, bounds, mask = counted
    _bin_equal(binning.bin_emit_call(rects[0], bounds, cnt_b, offs, mask,
                                     pc_max, tm),
               binning.bin_emit_plain(rects[0], bounds, cnt_b, offs, mask,
                                      pc_max, tm))


@pytest.mark.parametrize("mode", ["origin", "target", "ortho"])
def test_binning_pair_kernels_equal_plain(tlas, dev, monkeypatch, mode):
    """The TLAS pair stage (``instanced_coarse_stage`` with the pairs'
    tables: S on the pairs' box corners, an invalid instance's NaN box
    among them; U's pair_libs and pair_insts) equals its twins'."""
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    inter = tlas[0]
    cam = Camera.look_at((16.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = (raster.to_tiles(x.reshape(-1, 3), 1, 64, 64, 32, 32)
            for x in cam.generate_rays(64, 64))
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    tmax = torch.full((n,), 1e16, device=dev)
    point = None if mode == "ortho" else (
        o[0] if mode == "origin" else torch.tensor([3.0, 4.0, 9.0],
                                                   device=dev))
    if mode == "target":
        o = o + d * 20.0
    if mode == "ortho":
        d = d[0].expand(n, 3)
        o = o + torch.linspace(-6, 6, n, device=dev)[:, None] * torch.tensor(
            [0.0, 1.0, 0.3], device=dev)

    def run():
        return ri.instanced_coarse_stage(
            inter.pair_min, inter.pair_max, o, d, tmin, tmax, mode, point,
            1024, 1 << 14, inter.pair_shape, inter.pair_inst)

    got, want, ran = _stage_both(monkeypatch, run)
    assert ran == [1, 1, 1]
    _bin_equal(got, want)
    assert 0 < int(got["pc_total"]) <= 1 << 14
    assert "pair_libs" in got


@pytest.mark.parametrize("cut", ["whole", "straddles"])
def test_bin_emit_long_rows(dev, cut):
    """U on rows longer than its shared-memory sort (20,000 windows, all
    admitted by blocks 0 and 2, none by block 1): sorted in place in their
    output segments, keys with many ties, -0.0 and +0.0 among them, equal
    to the twin; with a capacity that cuts block 2's row, its lowest
    windows, sorted."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    C = 20_000
    r = np.random.default_rng(8)
    keys = r.integers(-40, 40, C).astype(np.float32) / 8
    keys[::7] = -0.0
    keys[3::7] = 0.0
    keys[5] = np.nan          # a NaN window: never admitted
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    rects = torch.stack([t(np.full(C, -1.0, np.float32)),
                         t(np.full(C, 1.0, np.float32)),
                         t(np.full(C, -1.0, np.float32)),
                         t(np.full(C, 1.0, np.float32)), t(keys),
                         t(keys + 10)])
    cfull = torch.zeros(C, dtype=torch.bool, device=dev)
    bounds = t(np.array([[-0.5, 0.5, -0.5, 0.5, -9.0, 90.0, 1.0, 0.0],
                         [-0.5, 0.5, -0.5, 0.5, -9.0, 90.0, 0.0, 0.0],
                         [-0.5, 0.5, -0.5, 0.5, -9.0, 90.0, 1.0, 0.0]],
                        np.float32))
    cnt_b = t(np.array([C - 1, 0, C - 1], np.int32))
    offs = t(np.array([0, C - 1, C - 1, 2 * C - 2], np.int32))
    mask = binning.pack_mask(binning._overlap("origin", rects, cfull,
                                              bounds)[0])
    pc_max = 2 * C + 300 if cut == "whole" else C + 12_345
    assert binning.shared_row(C) < C - 1
    got = binning.bin_emit_call(rects, bounds, cnt_b, offs, mask, pc_max,
                                "origin")
    want = binning.bin_emit_plain(rects, bounds, cnt_b, offs, mask, pc_max,
                                  "origin")
    torch.cuda.synchronize()
    _bin_equal(got, want)
    assert bool((got["b_i"][:C - 1] == 0).all())
    k = rects[4][got["c_i"][:C - 1].long()]
    assert bool((k[1:] >= k[:-1]).all())


def _t_and_u(o, d, tmin, tmax, W, mode, rects, cfull=None, basis=None,
             point=None, octants=True, pc_fits=True):
    """T on a wave against its twin (ray pack, bounds, counts, offsets,
    mask; one launch), then U on T's outputs against its twin, at a
    capacity above the pair count or at two thirds of it.  Returns T's
    outputs."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    before = _lib.BIN_COUNT.launches
    got = binning.bin_count_call(o, d, tmin, tmax, W, mode, rects, cfull,
                                 basis, point, octants)
    assert _lib.BIN_COUNT.launches == before + 1
    want = binning.bin_count_plain(o, d, tmin, tmax, W, mode, rects, cfull,
                                   basis, point, octants)
    torch.cuda.synchronize()
    _bin_equal(got, want)
    _, cnt_b, offs, bounds, mask = got
    total = int(offs[-1])
    pc_max = total + 300 if pc_fits else max(total * 2 // 3, 1)
    _bin_equal(binning.bin_emit_call(rects, bounds, cnt_b, offs, mask,
                                     pc_max, mode),
               binning.bin_emit_plain(rects, bounds, cnt_b, offs, mask,
                                      pc_max, mode))
    return got


@pytest.mark.parametrize("layout", ["contiguous", "broadcast", "unaligned",
                                    "W1500", "W37"])
@pytest.mark.parametrize("mode", ["origin", "target", "ortho", "bundle",
                                  "bundle_flat"])
def test_bin_count_staging(setup, dev, mode, layout):
    """T's staging of the block's rays: contiguous rows (16-byte copies),
    one broadcast row of o (or d) and broadcast bounds, rows whose start
    is not 16-byte aligned (4-byte copies), blocks longer than the 1,024 rays
    staged at a time (W = 1,500: two chunks, the wave's end inside a
    block) and of a W that is no multiple of 4 (37); every output equal
    to the twin's, then U's on them, at a fitting and a cut capacity."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    scene, inter, *_ = setup
    bundle = mode.startswith("bundle")
    o, d, tmin, tmax, point = _bin_wave(setup, dev,
                                        "target" if bundle else mode)
    W = {"W1500": 1500, "W37": 37}.get(layout, 1024)
    if layout == "broadcast":
        # the camera's origin, or one direction for the other waves (the
        # sun wave's is broadcast already)
        if mode == "origin":
            o = o[:1].expand(o.shape[0], 3)
        else:
            d = d[:1].expand(d.shape[0], 3)
        tmin = 1e-3
        tmax = torch.tensor(7.5, device=dev).expand(o.shape[0])
    elif layout == "unaligned":
        o, d = (torch.cat([torch.zeros((1, 3), device=dev), x])[1:]
                for x in (o, d))
        tmin, tmax = (torch.cat([torch.zeros(1, device=dev), x])[1:]
                      for x in (tmin, tmax))
        assert o.data_ptr() % 16 and tmax.data_ptr() % 16
    if bundle:
        rects, cfull, basis = binning.bin_rects_call(
            binning.RECTS_BOX, inter.clusters.sub_min, inter.clusters.sub_max,
            granularity=2)
        p = None
    else:
        p = None if mode == "ortho" else point
        rects, cfull, basis = binning.bin_rects_call(
            binning.RECTS_CLUSTER, inter.raster.verts, point=p,
            granularity=2, d=d)
    tm = "bundle" if bundle else mode
    for fits in (True, False):
        got = _t_and_u(o, d, tmin, tmax, W, tm, rects, cfull, basis,
                       p if mode == "target" else None, mode == "bundle",
                       fits)
    assert int(got[2][-1]) > 0


def _octant_wave(dev, W):
    """Bundle blocks of W rays with 0, 1, 2 and 8 live direction octants,
    then a block of NaN and +-inf rays among live ones: origins in a unit
    box, unit directions of the chosen sign patterns, t in [1e-3, 4];
    block 0 all dead."""
    r = np.random.default_rng(21)
    n = 5 * W
    o = r.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = np.abs(r.normal(size=(n, 3))).astype(np.float32) + 0.05
    sign = np.ones((n, 3), np.float32)
    octs = [np.zeros(W, int), np.full(W, 3), r.choice([1, 6], W),
            np.arange(W) % 8, r.integers(0, 8, W)]
    for blk, oc in enumerate(octs):
        for ax in range(3):
            sign[blk * W:(blk + 1) * W, ax] = np.where((oc >> ax) & 1, 1, -1)
    d = d * sign
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = r.uniform(0.5, 4.0, n).astype(np.float32)
    tmax[:W] = 0.0                                   # block 0 dead
    odd = slice(4 * W, 5 * W, 7)
    o[odd][::3, 0] = np.nan
    d[odd][1::3, 1] = np.inf
    d[odd][2::3, 2] = -np.inf
    tmax[4 * W + 3::11] = np.inf
    tmin[4 * W + 5::13] = np.nan
    return tuple(torch.as_tensor(x, device=dev) for x in (o, d, tmin, tmax))


@pytest.mark.parametrize("octants", [True, False], ids=["octants", "flat"])
@pytest.mark.parametrize("W", [512, 1024])
def test_bin_count_live_octants(setup, dev, W, octants):
    """T and U on bundle blocks with 0, 1, 2 and 8 live direction octants
    (one warp reduces each octant; the window loop runs the live ones
    only) and a block with NaN and +-inf rays, against the sphere's
    windows at g = 1 and 4: equal to the twins bit for bit, NaN to NaN."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    inter = setup[1]
    o, d, tmin, tmax = _octant_wave(dev, W)
    for g in (1, 4):
        rects = binning.bin_rects_call(
            binning.RECTS_BOX, inter.clusters.sub_min, inter.clusters.sub_max,
            granularity=g)[0]
        got = _t_and_u(o, d, tmin, tmax, W, "bundle", rects,
                       octants=octants)
        bounds = got[3]
        if octants:
            live = (bounds[..., 12] < 1e16).sum(1).tolist()
            assert live[:4] == [0, 1, 2, 8], live
        assert int(got[1][0]) == 0 and int(got[1][1:4].min()) > 0


@pytest.mark.parametrize("tables", [False, True], ids=["plain", "tables"])
@pytest.mark.parametrize("pc", ["fits", "cuts_warp_row", "cuts_long_row"])
def test_bin_emit_row_lengths(dev, pc, tables):
    """U on rows of 0, 1, 31, 32, 33, 64, 65, 128, 129, 8,192, 8,193 and
    20,000 kept pairs (one warp up to 32, 64 and 128; the CTA's shared
    sort up to 8,192; in place beyond), windows drawn at random from a
    mask, keys with ties and -0.0 / +0.0, at a capacity above the total
    and cutting a warp row and a long row; with and without the TLAS
    tables (pair_libs, pair_insts): equal to the twin."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    lengths = [0, 1, 31, 32, 33, 64, 65, 128, 129, 8192, 8193, 20_000, 5, 0]
    C = 20_001
    r = np.random.default_rng(9)
    keys = r.integers(-40, 40, C).astype(np.float32) / 8
    keys[::7] = -0.0
    keys[3::7] = 0.0
    keys[5] = np.nan
    t = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    rects = t(np.stack([np.full(C, -1.0, np.float32),
                        np.full(C, 1.0, np.float32),
                        np.full(C, -1.0, np.float32),
                        np.full(C, 1.0, np.float32), keys, keys + 10]))
    ov = np.zeros((len(lengths), C), bool)
    pool = np.delete(np.arange(C), 5)
    for row, n in enumerate(lengths):
        ov[row, r.choice(pool, n, replace=False)] = True
    mask = binning.pack_mask(t(ov))
    nb = len(lengths)
    bounds = t(np.tile(np.array([-0.5, 0.5, -0.5, 0.5, -9.0, 90.0, 1.0, 0.0],
                                np.float32), (nb, 1)))
    cnt = np.array(lengths, np.int32)
    offs = np.r_[0, np.cumsum(cnt)].astype(np.int32)
    pc_max = {"fits": int(offs[-1]) + 777,
              "cuts_warp_row": int(offs[lengths.index(33)]) + 17,
              "cuts_long_row": int(offs[lengths.index(8193)]) + 5000}[pc]
    lib_of = inst_of = None
    if tables:
        lib_of = t(r.integers(0, 9, C).astype(np.int32))
        inst_of = t(r.integers(0, 999, C).astype(np.int32))
    args = (rects, bounds, t(cnt), t(offs), mask, pc_max, "origin", lib_of,
            inst_of)
    got = binning.bin_emit_call(*args)
    want = binning.bin_emit_plain(*args)
    torch.cuda.synchronize()
    _bin_equal(got, want)
    assert ("pair_libs" in got) == tables


# ---- S: the projection basis with the rects ---------------------------------

def _s_both(args, kw):
    """Kernel S (two launches) against its twin on the same CUDA inputs:
    the basis bit for bit, the rects and full-plane flags equal (NaN to
    NaN), the second launch bit for bit the first.  Returns S's
    outputs."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    before = _lib.BIN_RECTS.launches
    got = binning.bin_rects_call(*args, **kw)
    again = binning.bin_rects_call(*args, **kw)
    assert _lib.BIN_RECTS.launches == before + 2
    want = binning.bin_basis_rects_plain(*args, **kw)
    torch.cuda.synchronize()
    _bin_equal(got, want)
    if want[2] is not None:
        assert torch.equal(got[2].view(torch.int32),
                           want[2].view(torch.int32)), (got[2], want[2])
    for x, y in zip(got, again, strict=True):
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    return got


def _sun_wave(n, dev):
    sun = torch.tensor([0.3, 0.2, 0.9], device=dev)
    return (sun / torch.linalg.norm(sun)).expand(n, 3)


@pytest.mark.parametrize("view", ["device_point", "host_point", "ortho"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_bin_rects_clusters(setup, dev, g, view):
    """S on the 20k-triangle sphere's RasterSet (NaN-padded rows in its
    last cluster) at g 1, 2, 4: seen from a point in device memory (the
    camera wave's origin), from a host point (by value), and along a sun
    direction read from the wave's first row."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    _, inter, o, d, _, _ = setup
    verts = inter.raster.verts
    assert bool(torch.isnan(verts).any())
    point = {"device_point": o[0], "host_point": (0.4, -2.5, 1.5),
             "ortho": None}[view]
    if view == "ortho":
        d = _sun_wave(o.shape[0], dev)
    rects, cfull, basis = _s_both((binning.RECTS_CLUSTER, verts),
                                  dict(point=point, granularity=g, d=d))
    assert rects.shape[1] == inter.clusters.num_clusters * g
    assert bool(torch.isfinite(basis).all())


@pytest.mark.parametrize("view", ["device_point", "host_point", "ortho"])
def test_bin_rects_pairs(tlas, dev, view):
    """S on the TLAS pairs' world boxes (an invalid instance's NaN boxes
    among them): the centroid of the pair centers from a point in device
    memory or on the host, or a sun direction."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    inter = tlas[0]
    n = 64
    point = {"device_point": torch.tensor([16.0, 2.0, 3.0], device=dev),
             "host_point": (3.0, 4.0, 9.0), "ortho": None}[view]
    rects, _, _ = _s_both((binning.RECTS_PAIR, inter.pair_min,
                           inter.pair_max),
                          dict(point=point, d=_sun_wave(n, dev)))
    assert bool(torch.isnan(rects[0]).any())


@pytest.mark.parametrize("g", [1, 2, 4])
def test_bin_rects_boxes(setup, dev, g):
    """S on the bundle windows' sub boxes at g 1, 2, 4 (no basis)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    clusters = setup[1].clusters
    got = _s_both((binning.RECTS_BOX, clusters.sub_min, clusters.sub_max),
                  dict(granularity=g))
    assert got[1] is None and got[2] is None
    assert got[0].shape[1] == clusters.num_clusters * g


def _symmetric(n, seed, dev):
    """n rows (a power of two, or 3 times one) whose halving tree sums to
    exactly 0 (tests/test_torch_binning.py's ``_symmetric_rows``)."""
    r = np.random.default_rng(seed)
    if n & (n - 1) == 0:
        x = r.uniform(-3, 3, (n // 2, 3)).astype(np.float32)
        rows = np.concatenate([x, -x])
    else:
        a = r.uniform(-3, 3, (n // 3, 3)).astype(np.float32)
        c = r.uniform(-3, 3, (n // 6, 3)).astype(np.float32)
        rows = np.concatenate([a, c, -c, -a])
    return torch.as_tensor(rows, device=dev)


@pytest.mark.parametrize("geometry", ["point_at_centroid", "all_nan"])
@pytest.mark.parametrize("source", ["cluster", "pair"])
def test_bin_rects_fallback_axis(dev, source, geometry):
    """The axis falls back to (0, 0, 1) on the card as in the twin: the
    shared point on the geometry's centroid (a sum of exactly 0), and
    geometry whose every row is NaN (no row kept, the count clamped to
    1)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    nan = geometry == "all_nan"
    if source == "cluster":
        verts = _symmetric(3 * 512, 3, dev).reshape(512, 3, 3)
        args = (binning.RECTS_CLUSTER, torch.full_like(verts, float("nan"))
                if nan else verts)
    else:
        c = _symmetric(32, 5, dev)
        args = ((binning.RECTS_PAIR, torch.full_like(c, float("nan")),
                 torch.full_like(c, float("nan"))) if nan else
                (binning.RECTS_PAIR, c - 0.25, c + 0.25))
    point = torch.zeros(3, device=dev)
    _, _, basis = _s_both(args, dict(point=point))
    assert basis.tolist() == [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0],
                              [0.0, 0.0, 1.0]]


def test_bin_rects_many_levels(dev):
    """S over 1,048,576 triangles, every 97th NaN, from a host point: its
    centroid over 3,145,728 vertex rows (several 8-row trees a thread, in
    its counter) and its 4,096 clusters' rects on a grid of the CTAs the
    card holds at once (each CTA loops over clusters), bit for bit the
    twin's."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    r = np.random.default_rng(31)
    v = r.normal(size=(1 << 20, 3, 3)).astype(np.float32) * 4 + 1.5
    v[::97] = np.nan
    verts = torch.as_tensor(v, device=dev)
    _s_both((binning.RECTS_CLUSTER, verts),
            dict(point=(0.5, -7.0, 2.0), granularity=4))


@pytest.mark.parametrize("mode", ["origin", "ortho"])
def test_binning_one_ray(setup, dev, monkeypatch, mode):
    """A wave of one ray through ``_coarse_stage`` (S, T and U, one launch
    each) equals its twins' stage."""
    scene, inter, o, d, _, _ = setup
    o, d = o[:1], (d[:1] if mode == "origin" else _sun_wave(1, dev))
    tmin = torch.full((1,), 1e-3, device=dev)
    tmax = torch.full((1,), 1e16, device=dev)
    got, want, ran = _stage_both(monkeypatch, lambda: raster._coarse_stage(
        inter.raster, inter.clusters, o, d, tmin, tmax, mode,
        o[0] if mode == "origin" else None, 1024, 4096, 2))
    assert ran == [1, 1, 1]
    _bin_equal(got, want)
    assert got["nb"] == 1


@pytest.mark.parametrize("traffic", ["whitted_stream", "path_stream"])
def test_pile_frames_wait_only_at_real_reads(dev, monkeypatch, traffic):
    """The benchmark's pile (``portbench`` driver, 320x240, 512 particles)
    through the fused loop after its set-up's warm loop: one more loop over
    the files (a device rebuild a file, a 4-frame chunk, a refit a frame)
    under ``torch.cuda.set_sync_debug_mode("error")``, relaxed only inside
    the two real reads, ``sync.pair_count`` and ``sync.fetch``.  No other
    call waits for the stream, and the loop takes every device constant
    from the cache without building one."""
    import contextlib

    from optix_ray_tracer_tpu_torch.utils import profiling
    from optix_ray_tracer_tpu_torch.utils.tensors import CONSTANTS
    from portbench import harness
    from portbench.drivers import time_stream

    run = time_stream.Run(harness.config("dem_pile"),
                          harness.traffic(traffic), 3_000_000_019, dev,
                          size=dict(width=320, height=240, particles=512))
    run.setup()
    real = profiling.span

    @contextlib.contextmanager
    def relaxed(name):
        wait = name in ("sync.pair_count", "sync.fetch")
        if wait:
            torch.cuda.set_sync_debug_mode("default")
        try:
            with real(name):
                yield
        finally:
            if wait:
                torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(profiling, "span", relaxed)
    CONSTANTS.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(run.loop):
            run._take()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        run.release()
    assert run.failed == 0
    assert CONSTANTS.built == 0 and CONSTANTS.reused > 0


@pytest.fixture(scope="module")
def chute_shapes(dev):
    """Waves at the chute cell's shapes: 16,900 UV spheres of 396
    triangles (6,692,400 triangles, 26,143 clusters, the device median
    build a scene past MAX_CLUSTERS gets first) in a 130 x 130 grid of
    layers, a 1200x800 camera wave from above (Morton-sorted) and a
    960,000-ray incoherent wave inside the bed, a third of it dead."""
    from optix_ray_tracer_tpu_torch.ops.sweep import rebuild_clusters
    v, _ = sphere_with_n_triangles(450)
    k = np.arange(16900)
    centers = np.stack([k % 130, k // 130, np.zeros(16900)], -1) * 2.2
    tri = torch.as_tensor((v[None] + centers[:, None, None].astype(
        np.float32)).reshape(-1, 3, 3), device=dev)
    cs = rebuild_clusters(None, tri)
    assert bm.is_deep(cs.num_clusters) and cs.num_clusters == 26143
    cam = Camera.look_at((-30.0, -30.0, 60.0), (143.0, 143.0, 0.0),
                         (0.0, 0.0, 1.0))
    o, d = (x.reshape(-1, 3).to(dev) for x in cam.generate_rays(1200, 800))
    lo, hi = tri.reshape(-1, 3).amin(0), tri.reshape(-1, 3).amax(0)
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
    perm = torch.argsort(ray_sort_keys(o, d, lo, hi), stable=True)
    r = np.random.default_rng(8)
    n = 960000
    oi = torch.as_tensor(np.concatenate([
        r.uniform(0.0, 286.0, (n, 2)), r.uniform(-1.2, 1.2, (n, 1))],
        -1).astype(np.float32), device=dev)
    di = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32),
                         device=dev)
    di = di / torch.linalg.norm(di, dim=-1, keepdim=True)
    tmax = torch.full((n,), 1e16, device=dev)
    tmax[::3] = 0.0
    return cs, {"coherent": (o[perm], d[perm], torch.full_like(tmax, 1e16)),
                "incoherent": (oi, di, tmax)}


@pytest.mark.parametrize("wave,any_hit", [("coherent", False),
                                          ("incoherent", False),
                                          ("incoherent", True)])
def test_deep_march_kernel_at_chute_shapes(chute_shapes, dev, wave,
                                           any_hit):
    """Kernel F2 against its plain version on full waves past the cap:
    0 mismatches under the hit rule (hit / miss for occlusion)."""
    cs, waves = chute_shapes
    o, d, tmax = waves[wave]
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    if any_hit:
        tmax = torch.where(tmax > 0, torch.full_like(tmax, 1.5), tmax)
    inp = bm.deep_inputs(cs, o, d, tmin, tmax, wave == "coherent")
    before = _lib.BLOCK_MARCH_DEEP.launches
    kern = bm.march_deep_call(**inp, any_hit=any_hit)
    assert _lib.BLOCK_MARCH_DEEP.launches == before + 1
    assert kern[2].shape == (inp["rays"].shape[1] // 32,)
    plain = bm.march_deep_plain(**_plain_args(inp), any_hit=any_hit)
    _hold(kern, plain, any_hit)
    assert int((kern[1] >= 0).sum()) > n // 8
    assert bm.deep_occupancy(any_hit=any_hit) >= 24


def test_deep_probe_kernel_at_chute_shapes(chute_shapes, dev):
    """Kernel C2 against its plain version on the incoherent wave (ids
    equal, the lowest id on ties), and against the flat plain probe on a
    slice of it."""
    cs, waves = chute_shapes
    o, d, tmax = waves["incoherent"]
    inp = bm.probe_inputs(cs, o, d, torch.full_like(tmax, 1e-3), tmax)
    before = _lib.PROBE_DEEP.launches
    ids, tests = bm.probe_call(**inp)
    assert _lib.PROBE_DEEP.launches == before + 1
    assert torch.equal(ids, bm.probe_deep_plain(**inp))
    part = dict(inp, rays=inp["rays"][:, :65536].contiguous())
    assert torch.equal(ids[:65536], bm.probe_plain(
        part["rays"], part["boxes"], part["n_clusters"], part["c_pad"]))
    assert int((ids < cs.num_clusters).sum()) > 0 and int(tests) > 0
    assert bm.deep_occupancy(probe=True) >= 32


def test_deep_routing_on_card(setup, dev, monkeypatch):
    """Below the cap the intersector launches C and B or F, never C2 or
    F2; with the cap lowered under the scene's 80 clusters, C2 and F2 and
    nothing else of the marcher, with the same hits."""
    scene, inter, o, d, oi, di = setup
    old = (_lib.PROBE, _lib.BLOCK_MARCH, _lib.BLOCK_MARCH_HIER)
    new = (_lib.PROBE_DEEP, _lib.BLOCK_MARCH_DEEP)
    inc = inter.for_incoherent()

    def count(fn):
        before = [k.launches for k in old + new]
        out = fn()
        return out, [k.launches - b for k, b in zip(old + new, before)]

    h0, n0 = count(lambda: inc.intersect(scene, oi, di))
    assert n0 == [1, 1, 0, 0, 0]
    monkeypatch.setattr(bm, "MAX_CLUSTERS", 8)
    h1, n1 = count(lambda: inc.intersect(scene, oi, di))
    assert n1 == [0, 0, 0, 1, 1]
    assert hit_mismatches(h0.prim_id, h0.t, h1.prim_id, h1.t) == 0
    h2, n2 = count(lambda: inter.intersect(scene, oi, di))
    assert n2 == [0, 0, 0, 0, 1]
