"""Kernels A-G on the card against their plain PyTorch versions, on the
same CUDA inputs at a small scene size; the sweep intersector against the
marcher, and the denoisers against their CPU runs.  Marked ``cuda``: they skip
where no CUDA device is present; on a machine with one, run

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures jax, which a machine for
the port need not have.)

Tolerance: the hit rule (prim ids equal, or |dt| <= 1e-5 |t| + 1e-6)
with no exceptions, and equal hit / miss for occlusion waves; u and v to
1e-6; G exact.  (The kernels and the
plain versions round every operation alike, so the expected difference
is zero.)  Denoisers, card against CPU: the tolerances of
tests/test_torch_denoise.py."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.ops import raster
from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
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
    """A tiny pair capacity sends the camera wave to kernel B (coherent);
    the hits equal the raster route's under the hit rule."""
    scene, inter, o, d, _, _ = setup
    before = (_lib.TILE_RASTER.launches, _lib.BLOCK_MARCH.launches)
    h_f = inter.intersect_from(scene, o, d, mode="origin", point=o[0],
                               pc_max=64)
    assert _lib.TILE_RASTER.launches == before[0]
    assert _lib.BLOCK_MARCH.launches == before[1] + 1
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
@pytest.mark.parametrize("kernel", ["B", "E"])
def test_march_edge_waves(setup, tlas, dev, kernel, wave):
    """B and E against their plain versions on a wave with dead (t_max 0)
    rays among live ones and NaN cull rows and sub boxes among live rows,
    and on a wave that misses everything (every slot -1, t = t_max)."""
    n = 4096
    r = np.random.default_rng(6)
    if kernel == "B":
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
    else:
        inp = _instanced_inputs(inter, o, d, tmin, tmax)
        call, plain_fn = bm.march_instanced_call, bm.march_instanced_plain
    if wave != "all_miss":
        boxes, subs = inp["boxes"].clone(), inp["sub_boxes"].clone()
        boxes[1::5] = float("nan")
        subs[2::3, 1] = float("nan")
        inp = dict(inp, boxes=boxes, sub_boxes=subs)
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


@pytest.mark.parametrize("kernel", ["B", "E"])
def test_march_refuses_partial_cta(setup, tlas, dev, kernel):
    """B and E launch 4-warp CTAs: a block width that is not a multiple of
    BLOCK_RAYS raises before any launch."""
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
                                  "origin", o[0], 1024, 1 << 16)
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
                                          1 << 17)
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
            for common in (None, "origin"):
                assert tr.raster_occupancy(instanced, any_hit, common) >= 16


@pytest.mark.parametrize("coherent", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_hier_kernel(setup, dev, coherent, any_hit):
    """Kernel F against its plain version, and against kernel B, on the
    same sorted wave."""
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
    plain = bm.march_hier_plain(**{k: v for k, v in inp.items() if k != "w"},
                                any_hit=any_hit)
    flat = bm.march_call(**bm.march_inputs(cs, wo[perm], wd[perm], tmin,
                                           tmax, coherent, 128),
                         any_hit=any_hit)
    if any_hit:
        assert torch.equal(kern[1] >= 0, plain[1] >= 0)
        assert torch.equal(kern[1] >= 0, flat[1] >= 0)
    else:
        _check(cs, kern, plain)
        _check(cs, kern, flat)


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
    blocks (as chip_smoke.py builds them): t, slot, u and v equal."""
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
