#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (optix_ray_tracer_tpu_torch) on
one NVIDIA GPU.  From the repository root:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to the plain versions):

1. build the CUDA kernels from optix_ray_tracer_tpu_torch/csrc into
   build/kernels/;
2. check each hit-path kernel against its plain PyTorch version at the
   main path's shapes: A (tile raster) on the bench camera wave (g=4,
   gated on 8x4 pixel blocks of its 32x32 tiles) and the flipped
   point-light shadow wave (g=2, in the camera wave's tile order, so on
   8x4 blocks too), whole waves,
   t, slot, u, v and the Woop-tested rows per warp equal
   (:func:`raster_wave`); B (block march) and C (cluster probe, 388
   clusters) on 1M random rays and on the camera wave, on 65,536 rays
   (2,048 warps spread over the wave), with the hit rule (prim ids
   equal, or |dt| <= 1e-5 |t| + 1e-6) and no exceptions, C's ids
   exactly; resident warps per SM (the runtime's occupancy number) of
   A, B and C; B's Woop-tested rows per warp and Woop tests beside the
   ones the subset needs (:func:`needed_work`), C's box tests beside the
   ones its answers need (:func:`needed_probe_work`) and the flat
   scan's; A's Woop tests beside the per-ray gate's and the whole-tile
   gate's (the plain version gated on 1 and on 1,024 rays), the needed
   ones (:func:`needed_raster_work`) and the scheduled ones;
3. the bench step of bench.py: a 1024x1024 camera wave plus a point-light
   shadow wave over a 100k-triangle sphere, per-wave calibrated pair
   capacities, both exactness guards, timed with CUDA events (best of 5
   runs, each the mean of 5 back-to-back steps), and the incoherent
   1M-ray metric;
4. a 1024x1024, spp=4, depth-5 Whitted frame through wavefront.render with
   a raster-enabled MarchIntersector; the launch counts of A, B and C are
   zeroed just before and read just after it, and each must be > 0;
5. the Time scene (models/renderer_time.py): a 4,096-particle DEM pile of
   three sphere shapes as instances over a static ground quad, its TLAS
   library and pairs (<= 8192) and its flatten route (>= 3072 clusters, so
   coherent waves take kernel F);
6. kernels D (instanced tile raster: the 1024x1024 camera wave and a
   flipped point-light shadow wave in its tile order, gated on 8x4
   blocks, calibrated capacities, no overflow; whole waves, as A in
   phase 2),
   E (instanced block march: 1M incoherent rays inside the pile, nearest
   and any-hit, and the TLAS frame's own first bounce wave, captured from
   a depth-2 render of frame 0) and F (hierarchical block march: the
   flatten route's Morton-sorted camera wave through block_march's
   routing, nearest and any-hit, timed beside kernel B) against their
   plain versions on subsets (E: 8,192 rays, F: 16,384; warps spread
   over each wave), with the hit rule and no exceptions; and C on the
   flatten frame's own first bounce wave
   (3,368 clusters, captured from a depth-2 render of flatten frame 0),
   its ids against the plain version's on 65,536 rays spread over it;
7. the slice's main path: the camera wave's primary hits through both
   routes (counts zeroed, then D and F > 0; the hit rule on all but 1e-4
   of the rays), then frames 0 and 1 (poses refit between them) through
   the TLAS route and frame 0 through the flatten route at 1024x1024, spp
   4, depth 5 (counts zeroed before the TLAS frames, then D and E > 0);
   the TLAS and flatten images agree, both are finite, sky pixels are the
   background; the live share (t_max > t_min) of each bounce wave of
   the TLAS and flatten frames, as phase 4 prints the Whitted frame's;
8. the sweep path on the bench scene (388 clusters): kernel G (leaf
   sweep) against its plain version on the first pass's blocks of the 1M
   camera wave and the 1M incoherent wave (65,536-ray subsets, exact
   equality); SweepIntersector on both full waves against the marcher's
   hits (the hit rule on all but 1e-5 of the rays, no ray active at the
   pass cap); then phase 4's frame through SweepIntersector (G's count
   zeroed before, > 0 after), held to phase 4's marcher frame;
9. the frame's tail on phase 4's frame: render_frame with the a-trous and
   the neural denoiser (committed weights), each against the same
   denoiser on the CPU copy of the frame, accumulated into a Film and
   written as PNGs.

Every kernel's row in the kernels' JSON object is one whole main-path
wave (a subset would leave most of the card idle): A the bench camera
wave, B and E their 1M-ray incoherent waves, C the flatten frame's first
bounce wave, D the TLAS camera wave, F the flatten camera wave, G the
camera wave's first sweep pass.  It carries the kernel's launches on the
main path, its error against its plain version, the whole wave's time,
the plain version's time on what it compared (A, D: the whole wave), and
the bound: the larger of the bytes the wave's inputs and outputs take
over 3.35 TB/s and the float operations its answers need over 67 TFLOP/s
FP32, the H100 SXM's published peaks.  The work is counted from this
run's data, whatever the kernel did: A and D :func:`needed_raster_work`
on the whole wave (a Woop test at WOOP_SHARED_ORIGIN_OPS: the tile shares
its origin), C :func:`needed_probe_work` on the whole wave, B, E and F
:func:`needed_work` on the subset scaled by the rays of the wave over the
subset's (its warps spread evenly over the wave), G every (ray, row)
test of the pass.  The last two lines of standard output are the
kernels' JSON object and the device JSON object.
``tools/prof_port.py`` profiles the same cells through
:func:`bench_setup`, :func:`bench_step`, :func:`whitted_setup`,
:func:`time_setup`, :func:`time_frame` and :func:`tail_setup`.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

N_TRIS = 100_000
WIDTH = HEIGHT = 1024
SPP = 4
DEPTH = 5
TILE = 32
REPS = 5
SUBSET = 65_536
LIGHT = (3.0, 3.0, 3.0)
SKY = (218, 232, 244)     # sRGB of the default background (0.7, 0.8, 0.9)
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the Time scene (phases 5-7)
N_PARTICLES = 4096
TIME_LIBRARY = (80, 200, 450)      # sphere shapes of 60, 168, 396 triangles
TIME_EYE = (45.0, 3.0, 5.0)
TIME_FOCAL = 2.25                  # view axis length: a 48-degree view
TIME_LIGHT = (30.0, 20.0, 40.0)
TIME_DURATION = 1.0
TIME_FRAMES = 2
SUBSET_TIME = 16_384
SUBSET_E = 8_192          # the plain E visits every pair: the slowest twin
SWEEP_HIT_EXCEPTIONS = 1e-5   # sweep vs marcher: allowed share of rays
# card vs CPU, relative: tests/test_torch_denoise.py's tolerances
DENOISE_RTOL = {"atrous": 8e-6, "neural": 2.4e-5}
# the bound: float operations per unit of work (a compare, abs or negate
# counts as one) over the H100 SXM's published peaks
WOOP_OPS = 47     # one (ray, triangle) Woop test: projections, t, u, v, test
# the same test when the tile shares its origin: the row's three
# o-projections (18 operations) are the tile's, computed once per row
WOOP_SHARED_ORIGIN_OPS = WOOP_OPS - 18
SLAB_OPS = 26     # one (ray, box) slab entry
INST_OPS = 33     # one ray moved into an instance's space
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
CHUNK = 256       # triangles per cluster (ops/sweep.CHUNK)
#: the kernels by letter, filled in by main()
K: dict = {}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` back-to-back calls after one warm-up call, by
    CUDA events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (dicts, tuples and lists are
    searched), each counted once."""
    import torch
    seen, total = set(), 0
    stack = list(objs)
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()
    return total


def needed_ops(work: dict) -> int:
    """Float operations of ``block_march.needed_work``'s counts."""
    return (work["slab"] * SLAB_OPS + work["inst"] * INST_OPS
            + work["woop"] * WOOP_OPS)


def march_work(label: str, visits, work: dict) -> None:
    """Print a warp marcher's Woop tests (its per-warp Woop-tested rows x
    32 lanes) beside the ones the answers need."""
    run = int(visits.sum()) * 32
    print(f"    {label}: {visits.float().mean().item():.1f} Woop-tested "
          f"rows per warp; Woop tests run {run} vs needed {work['woop']} "
          f"({run / max(work['woop'], 1):.2f}x); needed slab tests "
          f"{work['slab']}, ray transforms {work['inst']}")


def warp_rays(R: int, n: int):
    """Indices of n rays: n // 32 warps spread evenly over R rays."""
    import torch
    starts = torch.linspace(0, R // 32 - 1, n // 32).round().long() * 32
    return (starts[:, None] + torch.arange(32)).reshape(-1)


def row(err: float, ms: float, plain_ms: float, io_bytes: int,
        ops: float) -> dict:
    """A kernel's JSON row from its measurements and its work: the bound
    is the larger of bytes over the memory rate and operations over the
    FP32 rate."""
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def wave_row(name: str, err: float, full_ms: float, plain_ms: float,
             io_bytes: int, work: dict, n_sub: int, n_full: int) -> dict:
    """A marcher's JSON row for a whole wave: its time, and the bound of
    its bytes and of the needed work of a subset of ``n_sub`` of its
    ``n_full`` rays (warps spread evenly over the wave) scaled to the
    wave; ``plain_ms`` is the plain version's on the subset."""
    r = row(err, full_ms, plain_ms, io_bytes,
            needed_ops(work) * n_full / n_sub)
    print(f"    {name}: full-wave bound {r['bound_ms']:.4f} ms, by "
          f"{r['bound_by']} (needed work scaled {n_full / n_sub:.0f}x from "
          f"the subset), {100 * r['bound_ms'] / full_ms:.2f}% of the "
          f"{full_ms:.3f} ms wave")
    return r


def raster_wave(name: str, call, plain, inp: dict, W: int, any_hit: bool,
                keys, card: str) -> dict:
    """A raster kernel (A or D: ``call``, its plain version ``plain``) on
    one whole schedule ``inp`` of a common-origin wave in W-ray tiles in
    ``raster.to_tiles`` order (a warp's 32 rays are an 8x4 pixel block):
    the kernel against its plain version on the whole wave (0 mismatches,
    max |dt|, |du|, |dv| 0, the same Woop-tested rows per warp), its
    time, and its Woop tests beside the per-ray gate's and the whole-tile
    gate's (the kernels' first, CTA-wide design) from the plain version,
    the needed ones (:func:`needed_raster_work`) and the scheduled ones.
    Returns the JSON row: the bound counts the needed work at
    WOOP_SHARED_ORIGIN_OPS per Woop test."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    args = dict(w=W, any_hit=any_hit, common="origin")
    kern = call(**inp, **args, visits=True)
    ms = time_ms(lambda: call(**inp, **args), REPS)
    ref, p_ms = time_once(lambda: plain(**inp, **args, visits=True))
    err = compare(name, keys, kern, ref, any_hit)
    duv = max(float((kern[i] - ref[i]).abs().max()) for i in (2, 3))
    run, twin = (int(x[4].sum()) * 32 for x in (kern, ref))
    rows_equal = bool(torch.equal(kern[4], ref[4]))
    print(f"    max |du|, |dv| {duv:.3g}; Woop-tested rows per warp equal: "
          f"{rows_equal}")
    if err or duv or not rows_equal:
        raise AssertionError(f"{name}: kernel and plain version differ")
    per_ray = int(tr._raster_plain(inp, W, any_hit, "origin", 1)[4].sum())
    tile = int(tr._raster_plain(inp, W, any_hit, "origin", W)[4].sum()) * W
    # the needed work counts to each ray's nearest hit (in the segment for
    # an occlusion wave: an upper estimate)
    near = call(**inp, **dict(args, any_hit=False)) if any_hit else kern
    work = tr.needed_raster_work(inp, W, near[0], near[1])
    n_pairs = int((inp["pair_tiles"] < inp["n_blocks"]).sum())
    g = inp.get("granularity", 1)
    scheduled = n_pairs * W * (CHUNK // g)
    r = row(err, ms, p_ms, tensor_bytes(inp, kern),
            work["slab"] * SLAB_OPS + work["inst"] * INST_OPS
            + work["woop"] * WOOP_SHARED_ORIGIN_OPS)
    print(f"    {name}: {inp['n_blocks']} tiles of {W} rays, {n_pairs} "
          f"pairs, warps of 8x4-pixel blocks; kernel {ms:.3f} ms [{card}], "
          f"plain {p_ms:.1f} ms; "
          f"{tr.raster_occupancy('pair_insts' in inp, any_hit)} resident "
          f"warps per SM")
    print(f"    {name}: Woop tests run {run} (plain {twin}), per-ray gate "
          f"{per_ray} ({run / max(per_ray, 1):.3f}x), whole-tile gate "
          f"{tile} ({tile / max(run, 1):.2f}x run), needed {work['woop']}, "
          f"scheduled {scheduled}; slab tests {work['slab']}, ray "
          f"transforms {work['inst']}; bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}, {100 * r['bound_ms'] / ms:.2f}% of the wave")
    return r


def prim_keys(clusters):
    """slot -> triangle id (-1 for a miss) of a flat ClusterSet."""
    import torch
    return lambda s: torch.where(
        s < 0, -1, clusters.prim_index[s.clamp(min=0).long()])


def compare(name: str, keys, kern, plain, any_hit: bool) -> float:
    """Hold a kernel's (t, slot) against its plain version's: hit/miss for
    occlusion waves, the hit rule on the hit identities ``keys(slot)``
    otherwise.  Returns max |dt| over rays both hit (0 for occlusion
    waves, whose t is the -INF hit marker)."""
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    tk, sk = kern[0].reshape(-1), kern[1].reshape(-1)
    tp, sp = plain[0].reshape(-1), plain[1].reshape(-1)
    if any_hit:
        bad = int(((sk >= 0) != (sp >= 0)).sum())
        err = 0.0
    else:
        bad = hit_mismatches(keys(sk), tk, keys(sp), tp)
        both = (sk >= 0) & (sp >= 0)
        err = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    print(f"  {name}: {bad} mismatches of {sk.numel()} rays (slots "
          f"identical on {int((sk == sp).sum())}, {int((sk >= 0).sum())} "
          f"hits), max |dt| {err:.3g}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version on {bad} rays")
    return err


def build_kernels() -> None:
    """Phase 1: build (or load) the kernel library and report ptxas."""
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    t0 = time.perf_counter()
    _lib.load()
    nvcc = ("cached" if _lib.build_seconds is None
            else f"nvcc {_lib.build_seconds:.2f} s")
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"({nvcc})")
    for line in (_lib.build_log or "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def bench_setup(device) -> SimpleNamespace:
    """bench.py's scene, camera wave (in tile order), point-light shadow
    wave (as the flipped occlusion wave intersect_from traces), per-wave
    calibrated pair capacities and the 1M incoherent rays."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY,
        make_march_intersector,
    )
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )

    v, n = sphere_with_n_triangles(N_TRIS)
    scene = Scene(Spheres.empty(device), Triangles.from_arrays(v, n,
                                                               device=device))
    t0 = time.perf_counter()
    inter = make_march_intersector(scene, raster=True)
    print(f"[scene] {scene.triangle_count} triangles, "
          f"{inter.clusters.num_clusters} clusters (host SAH build "
          f"{time.perf_counter() - t0:.2f} s)")
    cs = inter.clusters
    cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=device)
    o, d = (raster.to_tiles(x.reshape(-1, 3), 1, HEIGHT, WIDTH, TILE, TILE)
            for x in cam.generate_rays(WIDTH, HEIGHT))
    R = o.shape[0]
    light = torch.tensor(LIGHT, device=device)
    G, GS = DEFAULT_GRANULARITY, DEFAULT_ANYHIT_GRANULARITY
    tmin0 = torch.full((R,), 1e-3, device=device)
    tmax_inf = torch.full((R,), 1e16, device=device)
    pc1 = raster.measure_pair_count(inter.raster, cs, o, d, tmin0, tmax_inf,
                                    "origin", o[0], granularity=G)
    hit0 = inter.intersect_from(scene, o, d, mode="origin", point=o[0])
    p0 = torch.where(hit0.is_hit[:, None], o + hit0.t[:, None] * d, o)
    dist0 = torch.linalg.norm(light - p0, dim=-1)
    wl0 = (light - p0) / torch.clamp(dist0[:, None], min=1e-6)
    # the flipped occlusion wave intersect_from traces (from the light)
    so0 = light.expand(R, 3).contiguous()
    sd0 = -wl0
    d0 = ((light - (p0 + wl0 * 1e-3)) * wl0).sum(-1)
    s_tmin, s_tmax = d0 - dist0, d0 - 1e-3
    pc2 = raster.measure_pair_count(inter.raster, cs, so0, sd0, s_tmin,
                                    s_tmax, "origin", light, granularity=GS)
    pc_max1, pc_max2 = raster.round_pc_max(pc1), raster.round_pc_max(pc2)
    print(f"[calibrate] primary g={G}: {pc1} pairs -> pc_max {pc_max1}; "
          f"shadow g={GS}: {pc2} pairs -> pc_max {pc_max2}")

    gen = np.random.default_rng(11)
    oi = torch.as_tensor(gen.uniform(-0.9, 0.9, (R, 3)).astype(np.float32),
                         device=device)
    di = gen.normal(size=(R, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    di = torch.as_tensor(di, device=device)
    return SimpleNamespace(
        scene=scene, inter=inter, cs=cs, o=o, d=d, R=R, light=light,
        tmin0=tmin0, tmax_inf=tmax_inf, shadow=(so0, sd0, s_tmin, s_tmax),
        pc_max1=pc_max1, pc_max2=pc_max2, oi=oi, di=di)


def bench_step(b: SimpleNamespace):
    """bench.py's step: the camera wave, then the point-light shadow wave
    from its hit points, each at its calibrated pair capacity."""
    import torch
    hit = b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                 point=b.o[0], pc_max=b.pc_max1)
    point = torch.where(hit.is_hit[:, None], b.o + hit.t[:, None] * b.d, b.o)
    to_light = b.light - point
    dist = torch.linalg.norm(to_light, dim=-1, keepdim=True)
    wl = to_light / torch.clamp(dist, min=1e-6)
    # the shadow rays keep the camera wave's tile order
    shadowed = b.inter.any_hit_from(
        b.scene, point + wl * 1e-3, wl, mode="target", point=b.light,
        t_max=dist[:, 0], pc_max=b.pc_max2)
    return hit.t, shadowed


def b_waves(b: SimpleNamespace) -> dict:
    """Kernel B's 1M-ray waves of the bench scene, sorted as the marcher
    sorts them: label -> (march_call arguments, the unsorted (o, d))."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.march import ray_probe_keys
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
    waves = {
        "incoherent": (b.oi, b.di, ray_probe_keys(b.cs, b.oi, b.di, b.tmin0,
                                                  b.tmax_inf), False),
        "camera": (b.o, b.d, ray_sort_keys(b.o, b.d, b.inter.scene_lo,
                                           b.inter.scene_hi), True)}
    out = {}
    for label, (wo, wd, keys, coherent) in waves.items():
        perm = torch.argsort(keys, stable=True)
        out[label] = (bm.march_inputs(b.cs, wo[perm], wd[perm], b.tmin0,
                                      b.tmax_inf, coherent), (wo, wd))
    return out


def e_waves(t: SimpleNamespace, inter) -> dict:
    """Kernel E's 1M-ray waves: random rays inside the particle cloud,
    Morton-sorted as the TLAS marcher sorts them, nearest (t_max INF) and
    occlusion (t_max 2): any_hit -> march_instanced_call arguments."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
    R, dev = t.o.shape[0], t.device
    gen = np.random.default_rng(11)
    oi = torch.as_tensor(gen.uniform(-15, 15, (R, 3)).astype(np.float32),
                         device=dev)
    di = gen.normal(size=(R, 3)).astype(np.float32)
    di = torch.as_tensor(di / np.linalg.norm(di, axis=-1, keepdims=True),
                         device=dev)
    perm = torch.argsort(ray_sort_keys(oi, di, inter.scene_lo,
                                       inter.scene_hi), stable=True)
    return {any_hit: bm.march_instanced_inputs(
        inter.pair_min, inter.pair_max, inter.sub_min, inter.sub_max,
        inter.pair_shape, inter.pair_inst, inter.inst_rows,
        inter.library.woop_t, oi[perm], di[perm], t.tmin,
        torch.full((R,), 2.0 if any_hit else 1e16, device=dev))
        for any_hit in (False, True)}


def check_kernels(b: SimpleNamespace) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns {name: JSON row (see :func:`row`)}."""
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY,
    )

    print(f"[kernels vs plain] hit rule, no exceptions, C's ids exactly; "
          f"A on the whole waves; B, C on {SUBSET} rays (warps spread over "
          f"the wave)")
    cs, R = b.cs, b.R
    W = TILE * TILE
    rows = {}

    def raster_case(label, S, g, any_hit):
        return raster_wave(f"A {label}", tr.raster_cluster_call,
                           tr.raster_cluster_plain,
                           raster.schedule_inputs(cs, S, S["nb"], g), W,
                           any_hit, prim_keys(cs), b.card)

    G, GS = DEFAULT_GRANULARITY, DEFAULT_ANYHIT_GRANULARITY
    S1 = raster._coarse_stage(b.inter.raster, cs, b.o, b.d, b.tmin0,
                              b.tmax_inf, "origin", b.o[0], W, b.pc_max1, G)
    S2 = raster._coarse_stage(b.inter.raster, cs, *b.shadow, "origin",
                              b.light, W, b.pc_max2, GS)
    r1 = raster_case("camera wave", S1, G, False)
    r2 = raster_case("shadow wave", S2, GS, True)
    rows["tile_raster"] = dict(r1, max_abs_err=max(r1["max_abs_err"],
                                                   r2["max_abs_err"]))

    march_rows = []
    print(f"  B: {bm.march_occupancy()} resident warps per SM (occupancy)")
    for label, (inp, (wo, wd)) in b_waves(b).items():
        full = bm.march_call(**inp)
        full_ms = time_ms(lambda: bm.march_call(**inp), REPS)
        pick = warp_rays(inp["rays"].shape[1], SUBSET).to(b.o.device)
        sub = dict(inp, rays=inp["rays"][:, pick].contiguous())
        plain_args = {k: v for k, v in sub.items() if k != "w"}
        kern = bm.march_call(**sub)
        plain = bm.march_plain(**plain_args, any_hit=False)
        err = compare(f"B {label}", prim_keys(cs), kern, plain, False)
        ms = time_ms(lambda: bm.march_call(**sub), REPS)
        p_ms = time_ms(lambda: bm.march_plain(**plain_args,
                                               any_hit=False), 1)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms "
              f"on {SUBSET} rays; full wave ({R} rays, W={inp['w']}, "
              f"n_subs={inp['n_subs']}) {full_ms:.3f} ms, "
              f"{full[2].float().mean().item() / CHUNK:.2f} cluster-"
              f"equivalent visits per warp")
        work = bm.needed_work(sub["rays"], *plain, sub["boxes"],
                              sub["sub_boxes"], inp["n_clusters"],
                              inp["n_subs"])
        march_work(f"{label} subset", kern[2], work)
        march_rows.append(wave_row(f"B {label}", err, full_ms, p_ms,
                                   tensor_bytes(inp, full), work,
                                   SUBSET, inp["rays"].shape[1]))

        probe_case(f"C {label}", bm.probe_inputs(cs, wo, wd, b.tmin0,
                                                 b.tmax_inf), b.card)
    rows["block_march"] = dict(march_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in march_rows))
    return rows


def probe_case(label: str, pin: dict, card: str) -> dict:
    """Kernel C on the wave ``pin`` (``probe_call``'s arguments): its ids
    against the plain version's on SUBSET rays spread over the wave (0
    mismatches), the whole wave timed, its live share (t_max > t_min),
    and the box tests the kernel ran beside the ones the answers need
    (:func:`needed_probe_work`) and the flat scan's.  Returns the whole
    wave's JSON row."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    rays = pin["rays"]
    R, C = rays.shape[1], pin["n_clusters"]
    pick = warp_rays(R, SUBSET).to(rays.device)
    psub = dict(pin, rays=rays[:, pick].contiguous())
    kern = bm.probe_call(**psub)[0]
    plain, p_ms = time_once(lambda: bm.probe_plain(**psub))
    bad = int((kern != plain).sum())
    print(f"  {label}: {bad} id mismatches of {SUBSET} rays spread over the "
          f"wave ({int((plain < pin['c_pad']).sum())} entered a cluster)")
    if bad:
        raise AssertionError(f"{label}: {bad} ids differ")
    ids, tests = bm.probe_call(**pin)
    ms = time_ms(lambda: bm.probe_call(**pin), REPS)
    work = bm.needed_probe_work(rays, ids, pin["boxes"], C)
    live = int((rays[7] > rays[6]).sum())
    run = int(tests)
    print(f"    {label}: full wave {R} rays, live share {live / R:.4f}, {C} "
          f"clusters: kernel {ms:.3f} ms [{card}], plain {p_ms:.1f} ms "
          f"on the subset; box tests run {run} vs needed {work['slab']} "
          f"({run / max(work['slab'], 1):.2f}x) vs the flat scan's "
          f"{work['flat']}; {bm.probe_occupancy()} resident warps per SM")
    return row(0.0, ms, p_ms, tensor_bytes(pin, ids),
               work["slab"] * SLAB_OPS)


def bench(b: SimpleNamespace, card: str) -> None:
    """Phase 3: both exactness guards, the no-overflow check and the
    bench's two rates."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.intersect import (
        hit_mismatches, intersect_scene_bruteforce,
    )
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib

    gen7 = np.random.default_rng(7)
    og = torch.as_tensor(gen7.uniform(-1.5, 1.5, (1024, 3)).astype(
        np.float32), device=b.o.device)
    dg = gen7.normal(size=(1024, 3)).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=-1, keepdims=True)
    dg = torch.as_tensor(dg, device=b.o.device)
    h1 = b.inter.intersect(b.scene, og, dg)
    h2 = intersect_scene_bruteforce(b.scene, og, dg)
    bad = int((h1.prim_id != h2.prim_id).sum())
    if bad:
        raise AssertionError(f"bench exactness guard: {bad}/1024 prim ids "
                             f"differ from the brute-force oracle")
    print("[bench] exactness: 1024/1024 prim ids match the oracle")
    o, d = b.o[:1024], b.d[:1024]
    h_r = b.inter.intersect_from(b.scene, o, d, mode="origin", point=b.o[0])
    h_o = intersect_scene_bruteforce(b.scene, o, d)
    bad = hit_mismatches(h_r.prim_id, h_r.t, h_o.prim_id, h_o.t)
    flips = int((h_r.prim_id != h_o.prim_id).sum())
    if bad:
        raise AssertionError(f"raster exactness guard: {bad}/1024")
    print(f"[bench] raster exactness: {1024 - flips}/1024 prim ids match "
          f"the oracle ({flips} fp-tie flips)")

    for k in _lib.KERNELS:
        k.launches = 0
    bench_step(b)
    torch.cuda.synchronize()
    if _lib.TILE_RASTER.launches != 2 or _lib.BLOCK_MARCH.launches != 0:
        raise AssertionError(
            f"bench step: raster launches {_lib.TILE_RASTER.launches} "
            f"(want 2), march launches {_lib.BLOCK_MARCH.launches} (want 0: "
            f"a schedule overflowed)")
    print("[bench] both waves ran the raster kernel without overflow")
    dt = min(time_ms(lambda: bench_step(b), REPS) for _ in range(5))
    mrays = 2 * b.R / (dt * 1e-3) / 1e6
    inc = b.inter.for_incoherent()
    dti = min(time_ms(lambda: inc.intersect(b.scene, b.oi, b.di).t, REPS)
              for _ in range(5))
    mrays_inc = b.R / (dti * 1e-3) / 1e6
    print(f"[bench] primary+shadow: {mrays:.2f} Mrays/s ({dt:.3f} ms/step) "
          f"[{card}]")
    print(f"[bench] incoherent: {mrays_inc:.2f} Mrays/s ({dti:.3f} ms per "
          f"{b.R}-ray wave) [{card}]")


def whitted_setup(v, n, device):
    """The Whitted scene: the sphere mesh (METAL, fuzz 0.05) over a ROUGH
    ground quad, camera (3, 0, 0.5) -> origin.  Returns (scene, materials,
    camera, raster-enabled MarchIntersector) on ``device``."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.70, 0.60, 0.50))
    qv, qn = quad((-6, -6, -1), (6, -6, -1), (6, 6, -1), (-6, 6, -1))
    scene = Scene(Spheres.empty(device),
                  Triangles.from_arrays(v, n, metal, device=device).concat(
                      Triangles.from_arrays(qv, qn, ground, device=device)))
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=device)
    return (scene, mb.build(device), cam,
            make_march_intersector(scene, raster=True))


def whitted(device, card: str):
    """Phase 4: the main path.  A 64x64 frame on the card is first held
    against the same call on CPU tensors (the plain versions); then the
    full frame runs with the launch counts zeroed just before it.  Returns
    the counts and the frame (scene, materials, camera, marcher, seed,
    image, albedo, normal, sRGB frame) for phases 8 and 9."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    sv, sn = sphere_with_n_triangles(2500)
    small = {}
    for dev in (device, torch.device("cpu")):
        sc, mats, cam, it = whitted_setup(sv, sn, dev)
        small[dev.type] = wavefront.render(sc, mats, cam, 64, 64, spp=SPP,
                                           seed=3, intersector=it)[0].cpu()
    diff = (small["cuda"] - small["cpu"]).abs()
    within = float((diff.amax(-1) <= 1e-4).float().mean())
    print(f"[whitted] 64x64 reference check vs the CPU plain path: mean "
          f"|diff| {float(diff.mean()):.3g}, {within:.4f} of pixels within "
          f"1e-4")
    if float(diff.mean()) > 1e-5 or within < 0.999:
        raise AssertionError("Whitted frame on the card disagrees with the "
                             "CPU plain path")

    v, n = sphere_with_n_triangles(N_TRIS)
    scene, mats, cam, inter = whitted_setup(v, n, device)
    for k in _lib.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with calls_of(bm, "probe_call") as live:
        img, alb, nrm = wavefront.render(scene, mats, cam, WIDTH, HEIGHT,
                                         spp=SPP, seed=1, max_depth=DEPTH,
                                         intersector=inter)
    torch.cuda.synchronize()
    s_frame = time.perf_counter() - t0
    launches = {k.name: k.launches for k in (K["A"], K["B"], K["C"])}
    print(f"[whitted] {WIDTH}x{HEIGHT} spp={SPP} depth {DEPTH}: "
          f"{s_frame:.3f} s/frame (first frame) [{card}]; launches "
          f"{launches}; live share of bounce waves 1-{DEPTH - 1}: "
          f"{shares(live)}")
    if not (torch.isfinite(img).all() and torch.isfinite(alb).all()
            and torch.isfinite(nrm).all()):
        raise AssertionError("Whitted frame has non-finite values")
    rgba = color_to_uint8(img)
    if tuple(rgba[0, 0, :3].tolist()) != SKY:
        raise AssertionError(f"sky pixel {rgba[0, 0, :3].tolist()} != {SKY}")
    sky = int((rgba[..., :3] == torch.tensor(SKY, device=device,
                                             dtype=torch.uint8)).all(-1)
              .sum())
    print(f"[whitted] frame finite; {sky} sky pixels equal {SKY}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    t0 = time.perf_counter()
    wavefront.render(scene, mats, cam, WIDTH, HEIGHT, spp=SPP, seed=2,
                     max_depth=DEPTH, intersector=inter)
    torch.cuda.synchronize()
    print(f"[whitted] {time.perf_counter() - t0:.3f} s/frame (second "
          f"frame) [{card}]")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    write_png(OUT_DIR / "whitted.png", rgba)
    print(f"[whitted] wrote {OUT_DIR / 'whitted.png'}")
    return launches, SimpleNamespace(scene=scene, mats=mats, cam=cam,
                                     inter=inter, seed=1, img=img, alb=alb,
                                     nrm=nrm, rgba=rgba)


def time_once(fn):
    """(result, ms) of one call by CUDA events (the plain versions, too
    slow to repeat)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def time_host(fn):
    """(result, ms) of one call on the host clock (CPU work)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def time_setup(device) -> SimpleNamespace:
    """Phase 5: the Time scene.  A DEM pile of P unit-sphere particles
    (shape ids and quaternions as tools/tlas_bench.py draws them, positions
    uniform in [-15, 15]^3), a second quaternion set and velocities that
    move them between frames 0 and 1, ROUGH / METAL by particle, over a
    static 80x80 ROUGH ground quad at z = -16; the TLAS library, and the
    flatten route's frame-0 scene and cluster build."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import (
        quad, sphere_with_n_triangles,
    )
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    from optix_ray_tracer_tpu_torch.ops.instanced import (
        build_instanced_library,
    )
    from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, ShapeLibrary, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    shapes = ShapeLibrary.from_meshes(
        [sphere_with_n_triangles(s) for s in TIME_LIBRARY], device)
    library = build_instanced_library(shapes.vertices.cpu().numpy(),
                                      shapes.offsets, shapes.counts, device)
    gen = np.random.default_rng(7)
    sid = gen.integers(0, len(TIME_LIBRARY), N_PARTICLES)
    q = gen.normal(size=(N_PARTICLES, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = gen.uniform(-15.0, 15.0, (N_PARTICLES, 3))
    q_next = gen.normal(size=(N_PARTICLES, 4))
    q_next /= np.linalg.norm(q_next, axis=1, keepdims=True)
    vel = gen.normal(size=(N_PARTICLES, 3)) * 0.5
    mb = MaterialBuilder()
    rough = mb.add_rough((0.65, 0.30, 0.20))
    metal = mb.add_metal((0.80, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.70, 0.60, 0.50))
    pmat = np.where(np.arange(N_PARTICLES) % 2 == 0, rough, metal)
    valid = np.ones(N_PARTICLES, bool)
    tri_lib, tri_inst, tri_ok = rt.packing_tables(shapes, sid[None],
                                                  valid[None])

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    poses = dict(positions=dev(pos), quats=dev(q), quats_next=dev(q_next),
                 velocities=dev(vel))
    qv, qn = quad((-40, -40, -16), (40, -40, -16), (40, 40, -16),
                  (-40, 40, -16))
    static = Scene(Spheres.empty(device),
                   Triangles.from_arrays(qv, qn, ground, device=device))
    # look_at's view spans +-1 at its target: a target TIME_FOCAL units
    # along the axis toward the origin frames the pile and some sky
    eye = np.asarray(TIME_EYE, np.float32)
    axis = -eye / np.linalg.norm(eye)
    cam = Camera.look_at(tuple(eye), tuple(eye + TIME_FOCAL * axis),
                         (0.0, 0.0, 1.0), device=device)
    t = SimpleNamespace(
        shapes=shapes, library=library, sid=sid, valid=valid,
        tri=(dev(tri_lib[0], torch.int32), dev(tri_inst[0], torch.int32),
             dev(tri_ok[0], torch.bool)),
        pmat=dev(pmat, torch.int32), poses=poses, static=static,
        mats=mb.build(device), cam=cam, device=device)

    v, n, mat = rt._frame_triangles(
        shapes.vertices, shapes.normals, *t.tri, poses["positions"],
        poses["quats"], poses["quats_next"], poses["velocities"], t.pmat,
        TIME_DURATION, 0.0, 1.0 / (TIME_FRAMES - 1), 1.0 / TIME_FRAMES,
        (0.0, 0.0, 0.0), 1.0, False)
    t.flat = Scene(Spheres.empty(device),
                   Triangles(v, n, mat).concat(static.triangles))
    t0 = time.perf_counter()
    t.finter = make_march_intersector(t.flat, raster=True)
    C = t.finter.clusters.num_clusters
    tlas0 = time_frame(t, 0)
    n_pairs = tlas0.tlas.pair_min.shape[0]
    print(f"[time] {N_PARTICLES} particles, library "
          f"{shapes.counts.tolist()} triangles in "
          f"{library.woop_t.shape[0]} clusters; {n_pairs} TLAS pairs; "
          f"flatten route: {t.flat.triangle_count} triangles, {C} clusters "
          f"(host SAH build {time.perf_counter() - t0:.2f} s)")
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    if n_pairs > bm.MAX_CLUSTERS:
        raise AssertionError(f"{n_pairs} pairs exceed {bm.MAX_CLUSTERS}")
    if C < bm.HIER_MIN_CLUSTERS:
        raise AssertionError(f"{C} clusters: coherent waves would not take "
                             f"kernel F (>= {bm.HIER_MIN_CLUSTERS})")
    t.o, t.d = (raster.to_tiles(x.reshape(-1, 3), 1, HEIGHT, WIDTH, TILE,
                                TILE) for x in t.cam.generate_rays(WIDTH,
                                                                   HEIGHT))
    R = t.o.shape[0]
    t.tmin = torch.full((R,), 1e-3, device=device)
    t.tmax = torch.full((R,), 1e16, device=device)
    # the camera wave's pair count; the frames' waves merge SPP samples,
    # SPP times the tiles, so their capacity is SPP times as large
    t.pc1 = ri.measure_instanced_pair_count(tlas0.tlas, t.o, t.d, t.tmin,
                                            t.tmax, "origin", t.o[0])
    t.pc_max1 = raster.round_pc_max(SPP * t.pc1)
    print(f"[calibrate] TLAS camera wave: {t.pc1} pairs -> the frames' "
          f"pc_max {t.pc_max1} ({SPP} samples per wave)")
    return t


def time_frame(t: SimpleNamespace, k: int, pc_max: int | None = None):
    """Frame k's TLASSceneIntersector (the refit for its poses)."""
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt
    return rt.tlas_frame_intersector(
        t.library, t.shapes, t.sid, t.valid, t.tri[0], t.tri[1], t.pmat,
        **t.poses, duration=TIME_DURATION, frame_idx=float(k),
        n_frames=TIME_FRAMES, pc_max=pc_max)


@contextlib.contextmanager
def calls_of(module, name: str):
    """Within the block, every call of ``module.name`` (called with
    keyword arguments) appends those arguments to the yielded list."""
    seen = []
    real = getattr(module, name)

    def record(**kw):
        seen.append(kw)
        return real(**kw)

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def shares(calls) -> str:
    """The live share (t_max > t_min) of each wave of ``calls``, the
    arguments that :func:`calls_of` recorded."""
    rays = [kw["rays"] for kw in calls]
    return ", ".join(f"{int((r[7] > r[6]).sum()) / r.shape[1]:.4f}"
                     for r in rays)


def bounce_wave(scene, mats, cam, inter, module, name: str) -> dict:
    """The keyword arguments of the first call of ``module.name`` at
    bounce 1 of a frame (seed 1, as phases 4 and 7 render it) rendered to
    depth 2: the frame's own first bounce wave."""
    from optix_ray_tracer_tpu_torch.render import wavefront
    with calls_of(module, name) as seen:
        wavefront.render(scene, mats, cam, WIDTH, HEIGHT, spp=SPP, seed=1,
                         max_depth=2, intersector=inter)
    return seen[-1]


def tlas_bounce_wave(t: SimpleNamespace) -> dict:
    """The ``march_instanced_call`` arguments (any_hit aside) of the TLAS
    frame's first bounce wave: the camera wave goes through kernel D,
    bounce 1 through E."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    kw = bounce_wave(t.static, t.mats, t.cam, time_frame(t, 0, t.pc_max1),
                     bm, "march_instanced_call")
    return {k: v for k, v in kw.items() if k != "any_hit"}


def flatten_bounce_wave(t: SimpleNamespace) -> dict:
    """The ``probe_call`` arguments of the flatten frame's first bounce
    wave (the camera wave goes through kernel F, bounce 1 through C to
    sort it, then B)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    return bounce_wave(t.flat, t.mats, t.cam, t.finter, bm, "probe_call")


def tlas_shadow_wave(t: SimpleNamespace, inter):
    """(light, (o, d, t_min, t_max)): the point-light shadow wave from the
    hit points of the Time camera wave through ``inter`` (an
    InstancedMarchIntersector), flipped to start at the light as
    intersect_from traces occlusion waves; it keeps the camera wave's
    tile order."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    light = torch.tensor(TIME_LIGHT, device=t.device)
    h0, _ = inter.intersect_from(t.o, t.d, point=t.o[0],
                                 pc_max=raster.round_pc_max(t.pc1))
    p0 = torch.where(h0.is_hit[:, None], t.o + h0.t[:, None] * t.d, t.o)
    dist0 = torch.linalg.norm(light - p0, dim=-1)
    wl0 = (light - p0) / torch.clamp(dist0[:, None], min=1e-6)
    d0 = ((light - (p0 + wl0 * 1e-3)) * wl0).sum(-1)
    return light, (light.expand(t.o.shape[0], 3).contiguous(), -wl0,
                   d0 - dist0, d0 - 1e-3)


def check_time_kernels(t: SimpleNamespace) -> dict:
    """Phase 6: kernels D, E and F against their plain versions at the Time
    scene's full-size waves (compared on subsets), with both full-wave
    times, and F beside B on the same coherent wave.  Returns {name: JSON
    row (see :func:`row`)}."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys

    dev = t.device
    R = t.o.shape[0]
    tlas = time_frame(t, 0)
    inter = tlas.tlas
    W = TILE * TILE
    rows = {}
    print(f"[time kernels vs plain] hit rule, no exceptions [D on the "
          f"whole waves; E, F on {SUBSET_TIME} rays or fewer where the plain "
          f"version is slow]")

    def keys(slot):
        """(instance << 16) + library triangle of TLAS slots."""
        pos = slot.clamp(min=0).long()
        pair = pos // 256
        lib_slot = inter.pair_shape.long()[pair] * 256 + pos % 256
        key = (inter.pair_inst.long()[pair] << 16) \
            + inter.library.prim_index.long()[lib_slot]
        return torch.where(slot < 0, -1, key)

    # D: the frame's camera wave (nearest) and a point-light shadow wave
    # (any-hit, flipped to the light), each at its calibrated capacity
    light, shadow = tlas_shadow_wave(t, inter)
    pc1 = t.pc1
    pc2 = ri.measure_instanced_pair_count(inter, *shadow, "origin", light)
    print(f"[calibrate] TLAS shadow wave: {pc2} pairs")
    d_rows = []
    for label, wave, point, pc, any_hit in (
            ("camera wave", (t.o, t.d, t.tmin, t.tmax), t.o[0], pc1, False),
            ("shadow wave", shadow, light, pc2, True)):
        S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, *wave,
                                      "origin", point, W,
                                      raster.round_pc_max(pc))
        if int(S["pc_total"]) > raster.round_pc_max(pc):
            raise AssertionError(f"D {label}: the schedule overflowed")
        d_rows.append(raster_wave(
            f"D {label}", tr.raster_instanced_call, tr.raster_instanced_plain,
            ri.instanced_schedule_inputs(inter, S), W, any_hit, keys, t.card))
    rows["tile_raster_instanced"] = dict(d_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in d_rows))

    # E: 1M incoherent rays inside the particle cloud, and the frame's
    # first bounce wave
    print(f"  E: {bm.march_occupancy(True)} resident warps per SM "
          f"(occupancy; any-hit {bm.march_occupancy(True, True)})")

    def e_case(label, inp, any_hit, pick, nearest=None):
        """E on the wave ``inp`` (timed whole) against its plain version
        on the rays ``pick``; returns (JSON row of the whole wave, plain
        (t, slot))."""
        full = bm.march_instanced_call(**inp, any_hit=any_hit)
        sub_rays = inp["rays"][:, pick].contiguous()
        reps = REPS if inp["rays"].shape[1] <= R else 2
        full_ms = time_ms(lambda: bm.march_instanced_call(
            **inp, any_hit=any_hit), reps)
        sub = dict(inp, rays=sub_rays)
        kern = bm.march_instanced_call(**sub, any_hit=any_hit)
        plain, p_ms = time_once(lambda: bm.march_instanced_plain(
            **{k: v for k, v in sub.items() if k != "w"}, any_hit=any_hit))
        err = compare(f"E {label}", keys, kern, plain, any_hit)
        ms = time_ms(lambda: bm.march_instanced_call(**sub, any_hit=any_hit),
                     REPS)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms on "
              f"{sub_rays.shape[1]} rays; full wave "
              f"({inp['rays'].shape[1]} rays, {inp['n_pairs']} pairs) "
              f"{full_ms:.3f} ms [{t.card}], "
              f"{full[2].float().mean().item() / CHUNK:.2f} cluster-"
              f"equivalent visits per warp")
        # an occlusion wave is counted to its nearest hit in the segment:
        # an upper estimate, as an exact any-hit march may stop at any hit
        near = plain if nearest is None else nearest
        seg = (near[1] >= 0) & (near[0] < sub_rays[7])
        work = bm.needed_work(
            sub_rays, torch.where(seg, near[0], sub_rays[7]),
            torch.where(seg, near[1], -1), inp["boxes"], inp["sub_boxes"],
            inp["n_pairs"], inp["sub_boxes"].shape[1], instanced=True)
        march_work(f"{label} subset" + (
            " (needed: an upper estimate, to the nearest hit)" if any_hit
            else ""), kern[2], work)
        return (wave_row(f"E {label}", err, full_ms, p_ms,
                         tensor_bytes(inp, full), work, sub_rays.shape[1],
                         inp["rays"].shape[1]), plain)

    e_rows = []
    nearest = None
    for any_hit, inp in e_waves(t, inter).items():
        label = "incoherent " + ("any-hit" if any_hit else "nearest")
        pick = warp_rays(inp["rays"].shape[1], SUBSET_E).to(dev)
        e_row, plain = e_case(label, inp, any_hit, pick, nearest)
        if nearest is None:
            nearest = plain
        e_rows.append(e_row)
    inp = tlas_bounce_wave(t)
    pick = warp_rays(inp["rays"].shape[1], SUBSET_E).to(dev)
    e_rows.append(e_case("TLAS frame bounce 1 nearest", inp, False,
                         pick)[0])
    rows["block_march_instanced"] = dict(e_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in e_rows))

    # F: the flatten route's Morton-sorted camera wave, through
    # block_march's routing, against the plain F and beside flat B
    cs = t.finter.clusters
    perm = torch.argsort(ray_sort_keys(t.o, t.d, t.finter.scene_lo,
                                       t.finter.scene_hi), stable=True)
    fo, fd = t.o[perm], t.d[perm]

    prims = prim_keys(cs)
    f_rows, f_near = [], None
    for any_hit in (False, True):
        tmax = torch.full((R,), 40.0 if any_hit else 1e16, device=dev)
        before = (K["F"].launches, K["B"].launches)
        routed = bm.block_march(cs, fo, fd, t.tmin, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        if (K["F"].launches - before[0], K["B"].launches - before[1]) \
                != (1, 0):
            raise AssertionError("block_march did not route the coherent "
                                 "wave to kernel F")
        inp = bm.hier_inputs(cs, fo, fd, t.tmin, tmax)
        kern_full = bm.march_hier_call(**inp, any_hit=any_hit)
        if not torch.equal(kern_full[1][:R], routed[1]):
            raise AssertionError("F through block_march differs from F")
        full_ms = time_ms(lambda: bm.march_hier_call(**inp, any_hit=any_hit),
                          REPS)
        b_inp = bm.march_inputs(cs, fo, fd, t.tmin, tmax, True)
        b_ms = time_ms(lambda: bm.march_call(**b_inp, any_hit=any_hit),
                       REPS)
        flat = bm.march_call(**b_inp, any_hit=any_hit)
        label = "any-hit" if any_hit else "nearest"
        compare(f"F vs B camera {label} (full wave)", prims, kern_full, flat,
                any_hit)
        pick = warp_rays(R, SUBSET_TIME).to(dev)
        sub = dict(inp, rays=inp["rays"][:, pick].contiguous())
        kern = bm.march_hier_call(**sub, any_hit=any_hit)
        plain, p_ms = time_once(lambda: bm.march_hier_plain(
            **{k: v for k, v in sub.items() if k != "w"}, any_hit=any_hit))
        err = compare(f"F camera {label}", prims, kern, plain, any_hit)
        ms = time_ms(lambda: bm.march_hier_call(**sub, any_hit=any_hit),
                     REPS)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms on "
              f"{SUBSET_TIME} rays; full wave ({R} rays, "
              f"{cs.num_clusters} clusters): F {full_ms:.3f} ms "
              f"(W={inp['w']}, {kern_full[2].float().mean().item():.2f} "
              f"cluster visits per block) vs B {b_ms:.3f} ms "
              f"(W={b_inp['w']}, "
              f"{flat[2].float().mean().item() / CHUNK:.2f} cluster-"
              f"equivalent visits per warp) [{t.card}]")
        if f_near is None:
            f_near = plain
        near, rays = f_near, sub["rays"]
        seg = (near[1] >= 0) & (near[0] < rays[7])
        work = bm.needed_work(
            rays, torch.where(seg, near[0], rays[7]),
            torch.where(seg, near[1], -1), inp["boxes"], inp["sub_boxes"],
            cs.num_clusters, inp["n_subs"], sup_boxes=inp["sup_boxes"])
        print(f"    {label}: needed on the subset: Woop tests "
              f"{work['woop']}, slab tests {work['slab']}")
        f_rows.append(wave_row(f"F camera {label}", err, full_ms, p_ms,
                               tensor_bytes(inp, kern_full), work,
                               SUBSET_TIME, R))
    rows["block_march_hier"] = dict(f_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in f_rows))

    # C: the flatten frame's own first bounce wave (3,368 clusters)
    rows["probe_first_cluster"] = probe_case(
        "C flatten frame bounce 1", flatten_bounce_wave(t), t.card)
    return rows


def time_frames(t: SimpleNamespace, card: str) -> dict:
    """Phase 7, the slice's main path: the camera wave's primary hits on
    both routes (counts zeroed before, read after: D and F), then frames 0
    and 1 through the TLAS route and frame 0 through the flatten route at
    1024x1024, spp 4, depth 5 (counts zeroed before the TLAS frames, read
    after: D and E).  Returns the launch counts of D, E and F."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.instanced import refit_instanced
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    launches = {}
    tlas0 = time_frame(t, 0, t.pc_max1)
    for k in _lib.KERNELS:
        k.launches = 0
    h_t = tlas0.intersect_from(t.static, t.o, t.d, point=t.o[0])
    h_f = t.finter.intersect(t.flat, t.o, t.d)
    torch.cuda.synchronize()
    launches["block_march_hier"] = K["F"].launches
    bad = hit_mismatches(h_t.prim_id, h_t.t, h_f.prim_id, h_f.t)
    R = t.o.shape[0]
    print(f"[time frame] primary hits, TLAS (D) vs flatten (F): {bad} of "
          f"{R} rays differ under the hit rule (silhouette grazes), "
          f"{int(h_t.is_hit.sum())} hits; launches D "
          f"{K['D'].launches}, F {K['F'].launches}")
    if bad > 1e-4 * R:
        raise AssertionError(f"TLAS and flatten primary hits differ on "
                             f"{bad} rays")
    if min(K["D"].launches, K["F"].launches) == 0:
        raise AssertionError("the primary-hit phase missed kernel D or F")

    live = {}

    def render(inter, scene, seed, counted=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with calls_of(bm, counted or "march_instanced_call") as n:
            out = wavefront.render(scene, t.mats, t.cam, WIDTH, HEIGHT,
                                   spp=SPP, seed=seed, max_depth=DEPTH,
                                   intersector=inter)
        torch.cuda.synchronize()
        live.setdefault(counted or "tlas", n)
        return out, time.perf_counter() - t0

    for k in _lib.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tlas0 = time_frame(t, 0, t.pc_max1)
    torch.cuda.synchronize()
    build0 = time.perf_counter() - t0
    img0, s0 = render(tlas0, t.static, 1)
    t0 = time.perf_counter()
    tlas1 = time_frame(t, 1, t.pc_max1)
    torch.cuda.synchronize()
    build1 = time.perf_counter() - t0
    img1, s1 = render(tlas1, t.static, 2)
    torch.cuda.synchronize()
    launches["tile_raster_instanced"] = K["D"].launches
    launches["block_march_instanced"] = K["E"].launches
    print(f"[time frame] TLAS route {WIDTH}x{HEIGHT} spp={SPP} depth "
          f"{DEPTH}: frame 0 {s0:.3f} s, frame 1 {s1:.3f} s (frame "
          f"builds {build0 * 1e3:.1f} / {build1 * 1e3:.1f} ms) [{card}]; "
          f"launches {({k.name: k.launches for k in _lib.KERNELS})}")
    if min(K["D"].launches, K["E"].launches) == 0:
        raise AssertionError("the TLAS frames missed kernel D or E")
    tl = tlas1.tlas
    valid = torch.as_tensor(t.valid, device=t.device)
    refit_ms = time_ms(lambda: refit_instanced(
        t.library, tl.pair_shape, tl.pair_inst, tlas1.rot,
        tl.inst_rows[:, 9:12], 1.0, valid), REPS)
    print(f"[time frame] refit {refit_ms:.3f} ms ({tl.pair_min.shape[0]} "
          f"pairs, CUDA events) [{card}]")

    imgf, sf = render(t.finter, t.flat, 1, "probe_call")
    print(f"[time frame] flatten route frame 0: {sf:.3f} s [{card}]")
    print(f"[time frame] live share of bounce waves 1-{DEPTH - 1}: TLAS "
          f"frame 0 {shares(live['tlas'])}; flatten frame 0 "
          f"{shares(live['probe_call'])}")
    rgba = []
    for name, out in (("tlas_frame0", img0), ("tlas_frame1", img1),
                      ("flatten_frame0", imgf)):
        if not all(bool(torch.isfinite(x).all()) for x in out):
            raise AssertionError(f"{name} has non-finite values")
        rgba.append(color_to_uint8(out[0]))
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        write_png(OUT_DIR / f"{name}.png", rgba[-1])
    diff = (rgba[0].int() - rgba[2].int()).abs()
    over2 = float((diff > 2).float().mean())
    over6 = float((diff > 6).float().mean())
    sky = (rgba[0][..., :3] == torch.tensor(SKY, device=t.device,
                                            dtype=torch.uint8)).all(-1)
    sky_f = (rgba[2][..., :3] == torch.tensor(SKY, device=t.device,
                                              dtype=torch.uint8)).all(-1)
    print(f"[time frame] TLAS vs flatten frame 0: max {int(diff.max())} "
          f"LSB, {over2:.6f} of channels > 2 LSB, {over6:.6f} > 6 LSB, mean "
          f"{float(diff.float().mean()):.4f} LSB; {int(sky.sum())} sky "
          f"pixels equal {SKY} (flatten {int(sky_f.sum())}); wrote "
          f"{OUT_DIR}/tlas_frame0.png, tlas_frame1.png, flatten_frame0.png")
    # the two routes round each hit differently (object-space vs baked
    # triangles); after a few bounces between convex mirrors a rare path
    # sample diverges, which moves its pixel by up to 1/SPP of its range
    # (more in sRGB where the pixel is dark): no bound on the maximum, 6
    # LSB on all but 0.5% of the channels
    if over2 >= 0.01 or over6 >= 5e-3:
        raise AssertionError("TLAS and flatten frames disagree")
    if int(sky.sum()) == 0:
        raise AssertionError("no sky pixel in the TLAS frame")
    return launches


def first_pass_blocks(clusters, o, d):
    """The leaf sweep's arguments (woop, starts, o, d, t_min, best) in the
    first pass of a sweep query over the wave (o, d), as the pass builds
    them: every group's rays padded to whole 128-ray blocks."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import sweep as sw
    from optix_ray_tracer_tpu_torch.ops.kernels import leaf_sweep as ls
    seen = []
    real = ls.window_sweep_call

    def record(*args):
        seen.append(args)
        return real(*args)

    ls.window_sweep_call = record
    try:
        R = o.shape[0]
        state = sw._initial_state(o, torch.full((R,), 1e16, device=o.device))
        sw._sweep_pass(clusters, o, d, torch.full((R,), 1e-3,
                                                  device=o.device), **state)
    finally:
        ls.window_sweep_call = real
    return seen[0]


def sweep_phase(b: SimpleNamespace, f: SimpleNamespace, card: str):
    """Phase 8: kernel G against its plain version on the first pass's
    blocks of the camera and incoherent waves; SweepIntersector on both
    full waves against the marcher; phase 4's frame through the sweep,
    with the launch counts zeroed just before it.  Returns (G's JSON row,
    G's launches in the frame)."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import sweep as sw
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import leaf_sweep as ls
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    waves = {"camera": (b.o, b.d), "incoherent": (b.oi, b.di)}
    print(f"[sweep kernels vs plain] G on the first pass's blocks, "
          f"{SUBSET}-ray subsets spread over the windows, exact equality")
    g_rows = []
    for label, (o, d) in waves.items():
        args = first_pass_blocks(b.cs, o, d)
        nb = args[1].shape[0]
        full = ls.window_sweep_call(*args)
        full_ms = time_ms(lambda: ls.window_sweep_call(*args), REPS)
        pick = torch.linspace(0, nb - 1, SUBSET // 128,
                              device=o.device).round().long()
        sub = (args[0],) + tuple(x[pick].contiguous() for x in args[1:5]) \
            + (tuple(x[pick].contiguous() for x in args[5]),)
        kern = ls.window_sweep_call(*sub)
        plain, p_ms = time_once(lambda: ls.window_sweep_plain(*sub))
        bad = int((kern[1] != plain[1]).sum())
        errs = [float((kern[i] - plain[i]).abs().max()) for i in (0, 2, 3)]
        ms = time_ms(lambda: ls.window_sweep_call(*sub), REPS)
        print(f"  G {label}: {bad} slot mismatches of {SUBSET} rays "
              f"({int((kern[1] >= 0).sum())} hits), max |dt| {errs[0]:.3g}, "
              f"|du| {errs[1]:.3g}, |dv| {errs[2]:.3g}; kernel {ms:.3f} ms vs "
              f"plain {p_ms:.1f} ms; the full pass ({nb} blocks) "
              f"{full_ms:.3f} ms [{card}]")
        if bad or max(errs) > 0:
            raise AssertionError(f"G {label}: kernel disagrees with its plain "
                                 f"version")
        # G tests every (ray, row) of its blocks' windows: the pass needs
        # all of them
        g_rows.append(row(max(errs), full_ms, p_ms, tensor_bytes(args, full),
                          nb * 128 * CHUNK * WOOP_OPS))
        print(f"    G {label}: full-pass bound {g_rows[-1]['bound_ms']:.4f} "
              f"ms by {g_rows[-1]['bound_by']}, "
              f"{100 * g_rows[-1]['bound_ms'] / full_ms:.2f}% of the pass")

    si = sw.SweepIntersector(clusters=b.cs, log=[])
    marcher = {
        "camera": b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                         point=b.o[0], pc_max=b.pc_max1),
        "incoherent": b.inter.for_incoherent().intersect(b.scene, b.oi,
                                                         b.di)}

    def keys(h):
        return torch.where(h.is_hit, h.prim_id, -1)

    for label, (o, d) in waves.items():
        si.log.clear()
        h, ms = time_once(lambda: si.intersect(b.scene, o, d))
        st = si.log[0]
        ref = marcher[label]
        bad = hit_mismatches(keys(h), h.t, keys(ref), ref.t)
        print(f"[sweep] {label} wave ({b.R} rays): {st.passes} passes, live "
              f"rays per pass {st.live}, {ms:.1f} ms by CUDA events "
              f"[{card}]; {bad} rays differ from the marcher under the hit "
              f"rule; " + ("a ray was still active at the cap"
                           if st.unfinished else "no ray active at the cap"))
        if st.unfinished:
            raise AssertionError(f"sweep {label}: rays active at the cap")
        if bad > SWEEP_HIT_EXCEPTIONS * b.R:
            raise AssertionError(f"sweep {label}: {bad} rays differ from the "
                                 f"marcher")

    si = sw.SweepIntersector(clusters=f.inter.clusters, log=[])
    for k in _lib.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, alb, nrm = wavefront.render(f.scene, f.mats, f.cam, WIDTH, HEIGHT,
                                     spp=SPP, seed=f.seed, max_depth=DEPTH,
                                     intersector=si)
    torch.cuda.synchronize()
    s_frame = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _lib.KERNELS}
    passes = [st.passes for st in si.log]
    print(f"[sweep frame] {WIDTH}x{HEIGHT} spp={SPP} depth {DEPTH} through "
          f"SweepIntersector: {s_frame:.3f} s/frame [{card}]; launches "
          f"{launches}; passes per wave {passes}")
    if K["G"].launches == 0:
        raise AssertionError("the sweep frame never launched kernel G")
    if any(st.unfinished for st in si.log):
        raise AssertionError("sweep frame: rays active at the cap")
    if not all(bool(torch.isfinite(x).all()) for x in (img, alb, nrm)):
        raise AssertionError("sweep frame has non-finite values")
    rgba = color_to_uint8(img)
    if tuple(rgba[0, 0, :3].tolist()) != SKY:
        raise AssertionError(f"sweep frame sky pixel {rgba[0, 0, :3]}")
    sky = int((rgba[..., :3] == torch.tensor(SKY, device=rgba.device,
                                             dtype=torch.uint8)).all(-1)
              .sum())
    diff = (rgba.int() - f.rgba.int()).abs()
    over2 = float((diff > 2).float().mean())
    print(f"[sweep frame] finite; {sky} sky pixels equal {SKY}; vs phase "
          f"4's marcher frame: max {int(diff.max())} LSB, {over2:.6f} of "
          f"channels > 2 LSB, mean {float(diff.float().mean()):.4f} LSB")
    if over2 >= 0.01:
        raise AssertionError("sweep and marcher frames disagree")
    write_png(OUT_DIR / "whitted_sweep.png", rgba)
    return g_rows[0], K["G"].launches


def tail_config(denoiser: str) -> SimpleNamespace:
    """The frame step's config (read by attribute, as render_frame reads
    the JAX package's RendererConfig)."""
    return SimpleNamespace(integrator="whitted", background=(0.7, 0.8, 0.9),
                           max_depth=DEPTH, sampler="pcg", denoise=True,
                           denoiser=denoiser)


def tail_setup(f: SimpleNamespace, denoiser: str):
    """The denoiser tail on phase 4's frame, as a callable."""
    from optix_ray_tracer_tpu_torch.models.common import apply_denoiser
    cfg = tail_config(denoiser)
    return lambda: apply_denoiser(f.img, f.alb, f.nrm, cfg)


def frame_tail(f: SimpleNamespace, card: str) -> None:
    """Phase 9: render_frame with each denoiser; each denoiser on phase
    4's frame timed, and held to the same call on the frame's CPU copy;
    the 4 samples accumulated into a Film and written as PNGs."""
    import torch

    from optix_ray_tracer_tpu_torch.models.common import (
        apply_denoiser, render_frame, resolve_denoiser,
    )
    from optix_ray_tracer_tpu_torch.render.film import Film

    cpu = [x.cpu() for x in (f.img, f.alb, f.nrm)]
    for name in ("atrous", "neural"):
        cfg = tail_config(name)
        if resolve_denoiser(cfg) != name:
            raise AssertionError(f"resolve_denoiser gave "
                                 f"{resolve_denoiser(cfg)} for {name}")
        img, alb, nrm = render_frame(cfg, f.scene, f.mats, f.cam, WIDTH,
                                     HEIGHT, SPP, f.seed, f.inter)
        if not all(bool(torch.isfinite(x).all()) for x in (img, alb, nrm)):
            raise AssertionError(f"render_frame ({name}) is not finite")
        ms = time_ms(tail_setup(f, name), REPS)
        card_out = tail_setup(f, name)()
        cpu_out, cpu_ms = time_host(lambda: apply_denoiser(*cpu, cfg))
        rel = (card_out.cpu() - cpu_out).abs() / cpu_out.abs()
        err = float(torch.nan_to_num(rel, nan=0.0).max())
        film = Film.create(WIDTH, HEIGHT, img.device).add(img, alb, nrm,
                                                          samples=SPP)
        path = OUT_DIR / f"whitted_denoised_{name}.png"
        film.save(str(path))
        print(f"[tail] {name}: {ms:.3f} ms per {WIDTH}x{HEIGHT} frame on "
              f"the card (CUDA events) [{card}], {cpu_ms:.0f} ms on the "
              f"host CPU; card vs CPU max |diff| / |cpu| {err:.3g} "
              f"(tolerance {DENOISE_RTOL[name]}); film spp {film.spp}; "
              f"wrote {path}")
        if film.spp != SPP:
            raise AssertionError("the film did not accumulate the samples")
        if not err <= DENOISE_RTOL[name]:
            raise AssertionError(f"{name}: card and CPU disagree by {err}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    import optix_ray_tracer_tpu_torch  # noqa: F401  (fails outside the repo)
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    K.update(A=_lib.TILE_RASTER, B=_lib.BLOCK_MARCH, C=_lib.PROBE,
             D=_lib.TILE_RASTER_INSTANCED, E=_lib.BLOCK_MARCH_INSTANCED,
             F=_lib.BLOCK_MARCH_HIER, G=_lib.LEAF_SWEEP)
    card = card_line()
    print(card)      # name and power limit, as nvidia-smi reports them
    device = torch.device("cuda", 0)
    build_kernels()
    b = bench_setup(device)
    b.card = card
    rows = check_kernels(b)
    bench(b, card)
    launches, frame = whitted(device, card)
    t = time_setup(device)
    t.card = card
    rows.update(check_time_kernels(t))
    launches.update(time_frames(t, card))
    rows["leaf_sweep"], launches["leaf_sweep"] = sweep_phase(b, frame, card)
    frame_tail(frame, card)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **rows[k.name]} for k in _lib.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
