#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (optix_ray_tracer_tpu_torch) on
one NVIDIA GPU.  From the repository root:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to the plain versions):

1. build the CUDA kernels from optix_ray_tracer_tpu_torch/csrc into
   build/kernels/;
2. check each hit-path kernel against its plain PyTorch version at the
   main path's shapes: A (tile raster) on the bench camera wave (g=4) and
   the flipped point-light shadow wave (g=2); B (block march) and C
   (cluster probe) on 1M random rays and on the camera wave.  Comparisons
   run on the first 65,536 rays (64 tiles) where the plain version is slow,
   with the hit rule (prim ids equal, or |dt| <= 1e-5 |t| + 1e-6) and no
   exceptions;
3. the bench step of bench.py: a 1024x1024 camera wave plus a point-light
   shadow wave over a 100k-triangle sphere, per-wave calibrated pair
   capacities, both exactness guards, timed with CUDA events (best of 5
   runs, each the mean of 5 back-to-back steps), and the incoherent
   1M-ray metric;
4. a 1024x1024, spp=4, depth-5 Whitted frame through wavefront.render with
   a raster-enabled MarchIntersector; the launch counts of A, B and C are
   zeroed just before and read just after it, and each must be > 0.

The last two lines of standard output are the kernels' JSON object and
the device JSON object.  ``tools/prof_port.py`` profiles the same cells
through :func:`bench_setup`, :func:`bench_step` and :func:`whitted_setup`.
"""

from __future__ import annotations

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


def tile_order(x, h: int, w: int):
    """(h, w, 3) pixel rows -> 32x32 tiles, row-major (a pure reshape)."""
    return (x.reshape(h // TILE, TILE, w // TILE, TILE, 3).transpose(1, 2)
            .reshape(-1, 3))


def compare(name: str, clusters, kern, plain, any_hit: bool) -> float:
    """Hold a kernel's (t, slot) against its plain version's: hit/miss for
    occlusion waves, the hit rule otherwise.  Returns max |dt| over rays
    both hit (0 for occlusion waves, whose t is the -INF hit marker)."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    tk, sk = kern[0].reshape(-1), kern[1].reshape(-1)
    tp, sp = plain[0].reshape(-1), plain[1].reshape(-1)
    if any_hit:
        bad = int(((sk >= 0) != (sp >= 0)).sum())
        err = 0.0
    else:
        def prims(s):
            return torch.where(s < 0, -1,
                               clusters.prim_index[s.clamp(min=0).long()])
        bad = hit_mismatches(prims(sk), tk, prims(sp), tp)
        both = (sk >= 0) & (sp >= 0)
        err = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    same = int((sk == sp).sum())
    print(f"  {name}: {bad} mismatches of {sk.numel()} rays "
          f"(slots identical on {same}), max |dt| {err:.3g}")
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
    scene = Scene(Spheres.empty(), Triangles.from_arrays(v, n)).to(device)
    t0 = time.perf_counter()
    inter = make_march_intersector(scene, raster=True)
    print(f"[scene] {scene.triangle_count} triangles, "
          f"{inter.clusters.num_clusters} clusters (host SAH build "
          f"{time.perf_counter() - t0:.2f} s)")
    cs = inter.clusters
    cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                         (0.0, 0.0, 1.0)).to(device)
    o, d = cam.generate_rays(WIDTH, HEIGHT)
    o, d = tile_order(o, HEIGHT, WIDTH), tile_order(d, HEIGHT, WIDTH)
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
    shadowed = b.inter.any_hit_from(
        b.scene, point + wl * 1e-3, wl, mode="target", point=b.light,
        t_max=dist[:, 0], pc_max=b.pc_max2)
    return hit.t, shadowed


def check_kernels(b: SimpleNamespace) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns {name: (max_abs_err, ms, plain_ms)}."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY, ray_probe_keys,
    )
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys

    print("[kernels vs plain] hit rule, no exceptions; first "
          f"{SUBSET} rays where the plain version is slow")
    cs, R = b.cs, b.R
    W = TILE * TILE
    nbs = SUBSET // W
    rows = {}

    def raster_case(label, S, g, any_hit):
        inp = raster.schedule_inputs(cs, S, S["nb"], g)
        full_ms = time_ms(lambda: tr.raster_cluster_call(
            **inp, w=W, any_hit=any_hit, common="origin"), REPS)
        k = int((inp["pair_tiles"] < nbs).sum())
        sub = dict(inp, pair_tiles=inp["pair_tiles"][:k].contiguous(),
                   pair_clusters=inp["pair_clusters"][:k].contiguous(),
                   rays_t_ext=inp["rays_t_ext"][:, :(nbs + 1) * W
                                                ].contiguous(),
                   n_blocks=nbs)
        args = dict(sub, w=W, any_hit=any_hit, common="origin")
        kern = tr.raster_cluster_call(**args)
        plain = tr.raster_cluster_plain(**args)
        err = compare(f"A {label}", cs, kern, plain, any_hit)
        if not any_hit:
            du = float((kern[2] - plain[2]).abs().max())
            dv = float((kern[3] - plain[3]).abs().max())
            print(f"    max |du| {du:.3g}, |dv| {dv:.3g}")
            if max(du, dv) > 1e-5:
                raise AssertionError(f"A {label}: u/v differ by "
                                     f"{max(du, dv)}")
        ms = time_ms(lambda: tr.raster_cluster_call(**args), REPS)
        p_ms = time_ms(lambda: tr.raster_cluster_plain(**args), 1)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms "
              f"on {nbs * W} rays; kernel on the full wave ({R} rays, "
              f"{int(S['pc_total'])} pairs) {full_ms:.3f} ms")
        return err, ms, p_ms

    G, GS = DEFAULT_GRANULARITY, DEFAULT_ANYHIT_GRANULARITY
    S1 = raster._coarse_stage(b.inter.raster, cs, b.o, b.d, b.tmin0,
                              b.tmax_inf, "origin", b.o[0], W, b.pc_max1, G)
    S2 = raster._coarse_stage(b.inter.raster, cs, *b.shadow, "origin",
                              b.light, W, b.pc_max2, GS)
    e1, ms_a, plain_a = raster_case("camera wave", S1, G, False)
    e2, _, _ = raster_case("shadow wave", S2, GS, True)
    rows["tile_raster"] = (max(e1, e2), ms_a, plain_a)

    waves = {
        "incoherent": (b.oi, b.di, ray_probe_keys(cs, b.oi, b.di, b.tmin0,
                                                  b.tmax_inf), False),
        "camera": (b.o, b.d, ray_sort_keys(b.o, b.d, b.inter.scene_lo,
                                           b.inter.scene_hi), True)}
    march_rows, probe_rows = [], []
    for label, (wo, wd, keys, coherent) in waves.items():
        perm = torch.argsort(keys, stable=True)
        inp = bm.march_inputs(cs, wo[perm], wd[perm], b.tmin0, b.tmax_inf,
                              coherent)
        visits = bm.march_call(**inp)[2].float().mean().item()
        full_ms = time_ms(lambda: bm.march_call(**inp), REPS)
        sub = dict(inp, rays=inp["rays"][:, :SUBSET].contiguous())
        plain_args = {k: v for k, v in sub.items() if k != "w"}
        err = compare(f"B {label}", cs, bm.march_call(**sub),
                      bm.march_plain(**plain_args, any_hit=False), False)
        ms = time_ms(lambda: bm.march_call(**sub), REPS)
        p_ms = time_ms(lambda: bm.march_plain(**plain_args,
                                               any_hit=False), 1)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms "
              f"on {SUBSET} rays; full wave ({R} rays, W={inp['w']}, "
              f"n_subs={inp['n_subs']}) {full_ms:.3f} ms, mean "
              f"{visits:.2f} cluster visits per block (nearest-first order)")
        march_rows.append((err, ms, p_ms))

        pin = bm.probe_inputs(cs, wo, wd, b.tmin0, b.tmax_inf)
        psub = dict(pin, rays=pin["rays"][:, :SUBSET].contiguous())
        ids_k, ids_p = bm.probe_call(**psub), bm.probe_plain(**psub)
        bad = int((ids_k != ids_p).sum())
        print(f"  C {label}: {bad} id mismatches of {SUBSET} rays")
        if bad:
            raise AssertionError(f"C {label}: {bad} ids differ")
        full_ms = time_ms(lambda: bm.probe_call(**pin), REPS)
        ms = time_ms(lambda: bm.probe_call(**psub), REPS)
        p_ms = time_ms(lambda: bm.probe_plain(**psub), 1)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms "
              f"on {SUBSET} rays; full wave ({R} rays) {full_ms:.3f} ms")
        probe_rows.append((0.0, ms, p_ms))
    rows["block_march"] = (max(r[0] for r in march_rows),) + march_rows[0][1:]
    rows["probe_first_cluster"] = probe_rows[0]
    return rows


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
    scene = Scene(Spheres.empty(), Triangles.from_arrays(v, n, metal)
                  .concat(Triangles.from_arrays(qv, qn, ground))).to(device)
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0),
                         (0.0, 0.0, 1.0)).to(device)
    return (scene, mb.build().to(device), cam,
            make_march_intersector(scene, raster=True))


def whitted(device, card: str) -> dict:
    """Phase 4: the main path.  A 64x64 frame on the card is first held
    against the same call on CPU tensors (the plain versions); then the
    full frame runs with the launch counts zeroed just before it.  Returns
    the counts."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
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
    img, alb, nrm = wavefront.render(scene, mats, cam, WIDTH, HEIGHT,
                                     spp=SPP, seed=1, max_depth=DEPTH,
                                     intersector=inter)
    torch.cuda.synchronize()
    s_frame = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _lib.KERNELS}
    print(f"[whitted] {WIDTH}x{HEIGHT} spp={SPP} depth {DEPTH}: "
          f"{s_frame:.3f} s/frame (first frame) [{card}]; launches "
          f"{launches}")
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
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    import optix_ray_tracer_tpu_torch  # noqa: F401  (fails outside the repo)
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    card = card_line()
    print(card)      # name and power limit, as nvidia-smi reports them
    device = torch.device("cuda", 0)
    build_kernels()
    b = bench_setup(device)
    rows = check_kernels(b)
    bench(b, card)
    launches = whitted(device, card)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": rows[k.name][0], "ms": rows[k.name][1],
         "plain_ms": rows[k.name][2]} for k in _lib.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
