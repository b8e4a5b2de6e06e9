"""Hand-written kernels on their main-path waves, timed by CUDA events on
one NVIDIA GPU, so that two checkouts can be compared in one call on one
card.

Usage, from the repository root (needs CUDA):

    python3 tools/kernel_bench.py [--tree DIR ...] [--waves TEXT ...]

The waves are set up once by this checkout, as chip_smoke.py sets them up
(capacities from the measured pair counts), and saved under
``build/kernel_bench/``.  Then each ``--tree`` (default: this checkout;
repeat it for parent, change, change, parent, with the parent a ``git
archive`` unpacked under ``build/``) times its own kernels on those same
waves, in a process of its own that imports the port from DIR and builds
DIR's kernel sources.  The wrappers are called with the keyword arguments
they have taken since the kernels were ported, so an older checkout times
the same work.  ``--waves`` keeps the waves whose name holds one of the
given texts.  Prints, per tree and wave, the mean ms of ``REPS`` launches
after a warm-up, twice (and, once every tree ran, which outputs of A and
D each tree gives bit for bit as the first tree does); then, per tree and entry of ``BINNING`` (also
kept by ``--waves``), kernels S, T or U of the raster binning: their
device ms per launch (``chip_smoke.device_ms``, a profiler trace) and
their wrapper's ms per call (CUDA events, host work included), and for
S the whole of the device work and the host ms of one call with the
projection basis it needs (a checkout whose S takes the basis as an
argument computes it in eager torch first, as its stages do); then,
per tree, five readings of the mean ms of ``REPS`` bench steps
(chip_smoke.py's camera + shadow waves through the tree's own
intersector, host-bound, so its wall spreads from run to run).

A wave is an entry of ``WAVES``: its name, the wrapper (module under
``optix_ray_tracer_tpu_torch/ops/kernels``, function) and a function of
this checkout's setups that returns the wrapper's keyword arguments.

``--routes [TEXT ...]`` instead compares, with this checkout only, the
two exact routes of NEE shadow segments on the waves of ``ROUTES``: the
bundle engine (``raster.bundle_stage``'s binning, then kernel A on its
schedule) against the probe-sorted marcher (C, then B).  Per wave it
prints the pairs against the heuristic capacity, the live rays, and the
mean ms of ``REPS`` calls of the binning, of A on the whole schedule, of
the bundle query at the capacity the pairs need and of the marcher, and
checks that both routes find the same occlusion.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
WAVE_FILE = ROOT / "build" / "kernel_bench" / "waves.pt"
PAIRS_FILE = ROOT / "build" / "kernel_bench" / "tlas_pairs.pt"
REPS = 10


def _a_wave(e, wave, point, pc_max, g, any_hit):
    """Kernel A's schedule of a bench-scene common-point wave."""
    from optix_ray_tracer_tpu_torch.ops import raster
    W = e.cs.TILE * e.cs.TILE
    S = raster._coarse_stage(e.b.inter.raster, e.b.cs, *wave, "origin",
                             point, W, pc_max, g)
    return dict(raster.schedule_inputs(e.b.cs, S, S["nb"], g), w=W,
                any_hit=any_hit, common="origin")


def _d_wave(e, wave, point, any_hit):
    """Kernel D's schedule of a Time-scene common-point wave."""
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    W = e.cs.TILE * e.cs.TILE
    pc = ri.measure_instanced_pair_count(e.tlas, *wave, "origin", point)
    S = ri.instanced_coarse_stage(e.tlas.pair_min, e.tlas.pair_max, *wave,
                                  "origin", point, W,
                                  raster.round_pc_max(pc), e.tlas.pair_shape,
                                  e.tlas.pair_inst)
    return dict(ri.instanced_schedule_inputs(e.tlas, S), w=W,
                any_hit=any_hit, common="origin")


def _rows(e, x):
    """A camera wave in ``raster.to_tiles`` order with each tile's rays
    row-major instead, so that a warp's 32 rays are a 32-pixel row: the
    layout that ``to_tiles`` is measured against."""
    from optix_ray_tracer_tpu_torch.ops import raster
    T, H, W = e.cs.TILE, e.cs.HEIGHT, e.cs.WIDTH
    img = raster.from_tiles(x, 1, H, W, T, T)
    return (img.reshape((H // T, T, W // T, T) + x.shape[1:]).transpose(1, 2)
            .reshape(x.shape))


def _bench_camera(e, layout=lambda x: x):
    return (layout(e.b.o), layout(e.b.d), e.b.tmin0, e.b.tmax_inf)


def _time_camera(e, layout=lambda x: x):
    return (layout(e.t.o), layout(e.t.d), e.t.tmin, e.t.tmax)


def _march(e, inter, wave, hier, any_hit=False):
    """Kernel F's (``hier``) or B's arguments on a camera wave sorted as
    the marcher sorts it; occlusion waves end at ``F_SEGMENT``."""
    import torch
    o, d, tmin, tmax = wave
    if any_hit:
        tmax = torch.full_like(tmax, e.cs.F_SEGMENT)
    return dict(e.cs.coherent_wave(inter, o, d, tmin, tmax, hier),
                any_hit=any_hit)


def _bench_nee(e):
    """NEE shadow segments on the bench scene, built as
    ``tools/bundle_bench.py`` builds its NEE wave (the JAX package's
    measured case for the bundle route): from the camera wave's hits
    (offset 1e-3 along the geometric normal, facing the camera) toward
    points jittered about (2, 2, 2.5) by 0.2 N(0, 1) (seed 3, after that
    tool's two bounce draws), ending 2e-3 short; dead where the camera ray
    missed.  Returns (o, d, t_min, t_max) in the camera wave's tile
    order."""
    import numpy as np
    import torch
    b = e.b
    hit = b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                 point=b.o[0], pc_max=b.pc_max1)
    live = hit.is_hit
    p = b.o + torch.where(live, hit.t, 0.0)[:, None] * b.d
    tri = b.scene.triangles.vertices[hit.prim_id.clamp(min=0).long()]
    nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-12)
    nrm = torch.where(((nrm * b.d).sum(-1) < 0)[:, None], nrm, -nrm)
    gen = np.random.default_rng(3)
    gen.random(b.R), gen.random(b.R)
    lp = torch.as_tensor(np.float32([2.0, 2.0, 2.5]) + 0.2 * gen
                         .standard_normal((b.R, 3)).astype(np.float32),
                         device=p.device)
    wl = lp - p
    dist = torch.linalg.norm(wl, dim=-1)
    wl = wl / torch.clamp(dist, min=1e-6)[:, None]
    up = torch.tensor([0.0, 0.0, 1.0], device=p.device)
    o = torch.where(live[:, None], p + 1e-3 * nrm, 0.0)
    d = torch.where(live[:, None], wl, up)
    return (o, d, torch.full_like(dist, 1e-3),
            torch.where(live, dist - 2e-3, 0.0))


def _bundle_schedule(clusters, wave, W):
    """(bundle_stage's schedule of ``wave`` in W-ray blocks at the
    capacity its pairs need, the heuristic capacity)."""
    from optix_ray_tracer_tpu_torch.ops import raster
    nb = -(-wave[0].shape[0] // W)
    cap = raster.default_bundle_pc_max(nb, clusters.num_clusters)
    S = raster.bundle_stage(clusters, *wave, W, cap)
    if int(S["pc_total"]) > cap:
        S = raster.bundle_stage(clusters, *wave, W,
                                raster.round_pc_max(int(S["pc_total"])))
    return S, cap


def _a_bundle(e, wave, W=1024):
    """Kernel A's bundle schedule (any-hit, full-width dots) of a wave."""
    from optix_ray_tracer_tpu_torch.ops import raster
    S, _ = _bundle_schedule(e.b.cs, wave, W)
    return dict(raster.schedule_inputs(e.b.cs, S, S["nb"]), w=W,
                any_hit=True, common=None)


def _a_sun(e, any_hit):
    """Kernel A's "dir" schedule of the bench scene's sun wave
    (chip_smoke.py phase 11 (d))."""
    from optix_ray_tracer_tpu_torch.ops import raster
    b, W = e.b, e.cs.TILE * e.cs.TILE
    g = (e.march.DEFAULT_ANYHIT_GRANULARITY if any_hit
         else e.march.DEFAULT_GRANULARITY)
    hit = b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                 point=b.o[0], pc_max=b.pc_max1)
    wave = e.cs.sun_wave(b.o, b.d, hit)
    pc = raster.round_pc_max(raster.measure_pair_count(
        b.inter.raster, b.cs, *wave, "ortho", granularity=g))
    S = raster._coarse_stage(b.inter.raster, b.cs, *wave, "ortho", None, W,
                             pc, g)
    return dict(raster.schedule_inputs(b.cs, S, S["nb"], g), w=W,
                any_hit=any_hit, common="dir")


def _d_sun(e, any_hit):
    """Kernel D's "dir" schedule of the Time scene's sun wave (chip_smoke.py
    phase 11 (d))."""
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    t, tlas, W = e.t, e.tlas, e.cs.TILE * e.cs.TILE
    hit, _ = tlas.intersect_from(t.o, t.d, point=t.o[0],
                                 pc_max=raster.round_pc_max(t.pc1))
    wave = e.cs.sun_wave(t.o, t.d, hit)
    pc = raster.round_pc_max(ri.measure_instanced_pair_count(
        tlas, *wave, "ortho", None))
    S = ri.instanced_coarse_stage(tlas.pair_min, tlas.pair_max, *wave,
                                  "ortho", None, W, pc, tlas.pair_shape,
                                  tlas.pair_inst)
    return dict(ri.instanced_schedule_inputs(tlas, S), w=W, any_hit=any_hit,
                common="dir")


def _a_pile_bundle(e):
    """Kernel A's bundle schedule (any-hit, full-width dots) of the path
    pile's first NEE wave (:func:`_pile_nee`, bounce 0), at the capacity
    its pairs need."""
    from optix_ray_tracer_tpu_torch.ops import raster
    _, clusters, _, _, wave, W = _pile_nee(e)[0]
    S, _ = _bundle_schedule(clusters, wave, W)
    return dict(raster.schedule_inputs(clusters, S, S["nb"]), w=W,
                any_hit=True, common=None)


def _sweep(e, o, d):
    """Kernel G's arguments in the first sweep pass of the wave (o, d)."""
    return dict(zip(("woop", "starts", "o", "d", "t_min", "best"),
                    e.cs.first_pass_blocks(e.b.cs, o, d)))


WAVES = {
    "A bench camera": ("tile_raster", "raster_cluster_call", lambda e: _a_wave(
        e, _bench_camera(e), e.b.o[0], e.b.pc_max1,
        e.march.DEFAULT_GRANULARITY, False)),
    "A bench shadow": ("tile_raster", "raster_cluster_call", lambda e: _a_wave(
        e, e.b.shadow, e.b.light, e.b.pc_max2,
        e.march.DEFAULT_ANYHIT_GRANULARITY, True)),
    "A bench camera, row-major tiles": (
        "tile_raster", "raster_cluster_call", lambda e: _a_wave(
            e, _bench_camera(e, lambda x: _rows(e, x)), e.b.o[0],
            e.b.pc_max1, e.march.DEFAULT_GRANULARITY, False)),
    "D TLAS camera": ("tile_raster", "raster_instanced_call",
                      lambda e: _d_wave(e, _time_camera(e), e.t.o[0], False)),
    "D TLAS camera, row-major tiles": (
        "tile_raster", "raster_instanced_call", lambda e: _d_wave(
            e, _time_camera(e, lambda x: _rows(e, x)), e.t.o[0], False)),
    "D TLAS shadow": ("tile_raster", "raster_instanced_call",
                      lambda e: _d_wave(e, e.shadow[1], e.shadow[0], True)),
    "C incoherent 1M (bench scene)": (
        "block_march", "probe_call", lambda e: e.bm.probe_inputs(
            e.b.cs, e.b.oi, e.b.di, e.b.tmin0, e.b.tmax_inf)),
    "C flatten frame bounce 1": ("block_march", "probe_call",
                                 lambda e: e.cs.flatten_bounce_wave(e.t)),
    "B incoherent 1M (bench scene)": (
        "block_march", "march_call",
        lambda e: e.cs.b_waves(e.b)["incoherent"][0]),
    "E incoherent 1M (Time scene)": (
        "block_march", "march_instanced_call",
        lambda e: dict(e.cs.e_waves(e.t, e.tlas)[False], any_hit=False)),
    "E incoherent 1M any-hit (Time scene)": (
        "block_march", "march_instanced_call",
        lambda e: dict(e.cs.e_waves(e.t, e.tlas)[True], any_hit=True)),
    "F flatten camera": ("block_march", "march_hier_call", lambda e: _march(
        e, e.t.finter, _time_camera(e), True)),
    "F flatten camera any-hit": (
        "block_march", "march_hier_call", lambda e: _march(
            e, e.t.finter, _time_camera(e), True, any_hit=True)),
    # the B/F crossover: both on the same coherent waves
    "B flatten camera (3,368 clusters)": (
        "block_march", "march_call", lambda e: _march(
            e, e.t.finter, _time_camera(e), False)),
    "F bench camera (388 clusters)": (
        "block_march", "march_hier_call", lambda e: _march(
            e, e.b.inter, _bench_camera(e), True)),
    "B bench camera (388 clusters)": (
        "block_march", "march_call", lambda e: _march(
            e, e.b.inter, _bench_camera(e), False)),
    "A bench NEE bundle": ("tile_raster", "raster_cluster_call",
                           lambda e: _a_bundle(e, _bench_nee(e))),
    "A dir bench sun": ("tile_raster", "raster_cluster_call",
                        lambda e: _a_sun(e, False)),
    "A dir bench sun any-hit": ("tile_raster", "raster_cluster_call",
                                lambda e: _a_sun(e, True)),
    "D dir pile sun": ("tile_raster", "raster_instanced_call",
                       lambda e: _d_sun(e, False)),
    "D dir pile sun any-hit": ("tile_raster", "raster_instanced_call",
                               lambda e: _d_sun(e, True)),
    "A pile NEE bundle": ("tile_raster", "raster_cluster_call",
                          lambda e: _a_pile_bundle(e)),
    "G camera first pass": ("leaf_sweep", "window_sweep_call",
                            lambda e: _sweep(e, e.b.o, e.b.d)),
    "G incoherent first pass": ("leaf_sweep", "window_sweep_call",
                                lambda e: _sweep(e, e.b.oi, e.b.di)),
}


def _pile_nee(e):
    """The NEE waves of frame 0 of chip_smoke.py phase 11 (c) (the path
    pile, 4x4 panel; bounces 0 to DEPTH - 1), captured through
    ``raster.BUNDLE_OBSERVERS`` from one frame of the CLI, with a
    probe-sorted marcher over the same clusters.  Returns [(label,
    clusters, marcher, scene, wave, W)]."""
    import tempfile

    import torch

    from optix_ray_tracer_tpu_torch.ops.march import MarchIntersector
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )
    cs = e.cs
    waves, log = [], []
    with tempfile.TemporaryDirectory(prefix="routes_") as tmp:
        config = cs.path_pile_configs(Path(tmp))
        with cs.bundle_log(log, waves, cs.DEPTH):
            cs.run_cli(["--config", config("path.json", cs.ANIM_LIGHT[1]),
                        "--output", Path(tmp) / "out", "--frames", 1])
    out = []
    for bounce, (args, _) in enumerate(waves):
        clusters = args[0]
        dev = clusters.woop_t.device
        # the probe sort reads no scene bounds; the scene holds no spheres
        inc = MarchIntersector(
            clusters=clusters, scene_lo=torch.zeros(3, device=dev),
            scene_hi=torch.ones(3, device=dev),
            num_tris=int((clusters.prim_index >= 0).sum()),
            sort_mode="probe")
        scene = Scene(Spheres.empty(dev), Triangles.empty(dev))
        out.append((f"path pile NEE, bounce {bounce}", clusters, inc,
                    scene, args[1:5], args[5]))
    return out


def _bench_routes(e):
    """The bench scene's NEE wave, its own intersector."""
    return [("bench NEE (tools/bundle_bench.py's wave)", e.b.cs,
             e.b.inter.for_incoherent(), e.b.scene, _bench_nee(e), 1024)]


def _binning_bench_camera(e):
    """The bench camera wave's binning at g 4, as chip_smoke.py's phase 16
    bins it."""
    from optix_ray_tracer_tpu_torch.ops import march, raster
    W = e.cs.TILE * e.cs.TILE
    return lambda: raster._coarse_stage(
        e.b.inter.raster, e.b.cs, *_bench_camera(e), "origin", e.b.o[0], W,
        e.b.pc_max1, march.DEFAULT_GRANULARITY)


def _binning_pile_nee(e):
    """The binning of the path pile's first bundle NEE wave (bounce 0 of
    :func:`_pile_nee`, 8 direction octants) at its heuristic capacity."""
    from optix_ray_tracer_tpu_torch.ops import raster
    _, clusters, _, _, wave, W = _pile_nee(e)[0]
    cap = raster.default_bundle_pc_max(-(-wave[0].shape[0] // W),
                                       clusters.num_clusters)
    return lambda: raster.bundle_stage(clusters, *wave, W, cap)


def _binning_tlas_camera(e):
    """The TLAS pairs' binning (chip_smoke.py's Time scene, frame 0: 5,495
    pairs) of the first 1,024 rays of its camera wave, from the saved
    :func:`build_pairs`: S's inputs do not depend on the wave."""
    import torch
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    pmin, pmax, o, d, point = torch.load(PAIRS_FILE, map_location="cuda:0",
                                         weights_only=True)
    tmin = torch.full((o.shape[0],), 1e-3, device=o.device)
    tmax = torch.full((o.shape[0],), 1e16, device=o.device)
    return lambda: ri.instanced_coarse_stage(pmin, pmax, o, d, tmin, tmax,
                                             "origin", point, 1024, 1 << 14)


#: binning waves: name -> (function of a tree's setups returning the
#: stage, the kernels timed on it).  Each tree builds its own stage and
#: takes the kernels' arguments from it (``chip_smoke.binning_calls``):
#: T's and U's changed when U came to read T's hit mask, S's when it came
#: to compute the projection basis.
BINNING = {"T, U bench camera": (_binning_bench_camera, "TU"),
           "T, U path pile NEE, bounce 0": (_binning_pile_nee, "TU"),
           "S: bench camera (clusters)": (_binning_bench_camera, "S"),
           "S: TLAS camera (pairs)": (_binning_tlas_camera, "S"),
           "S: path pile NEE, bounce 0 (boxes)": (_binning_pile_nee, "S")}


def _eager_basis(raster, source: int, a, b, point):
    """The projection basis as the stages computed it in eager torch
    before S took it over (the centroid, its fallback and
    ``raster._basis_from``), for a checkout whose S takes a basis."""
    import torch
    dev = a.device
    p = torch.as_tensor(point, dtype=torch.float32, device=dev)
    q = (a + b) * 0.5 - p if source == 1 else a.reshape(-1, 3) - p
    mask = torch.isnan(q[:, 0])
    qsum = torch.where(mask[:, None], torch.zeros_like(q), q).sum(0)
    cnt = torch.clamp((~mask).sum(), min=1).to(torch.float32)
    wvec = qsum / cnt
    wvec = torch.where(torch.linalg.norm(wvec) > 1e-12, wvec,
                       torch.tensor([0.0, 0.0, 1.0], device=dev))
    return raster._basis_from(wvec)


def _s_with_basis(a, k):
    """One S call (its dispatcher's captured arguments ``a``, ``k``) with
    the basis it needs: the call itself where S computes it, else the
    eager basis then S."""
    import inspect

    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    params = inspect.signature(binning.bin_rects).parameters
    if "basis" not in params or a[0] == 2:
        return lambda: binning.bin_rects(*a, **k)
    bound = inspect.signature(binning.bin_rects).bind(*a, **k).arguments
    source, geo, b = bound["source"], bound["a"], bound.get("b")
    point, g = bound.get("point"), bound.get("granularity", 1)
    return lambda: binning.bin_rects(
        source, geo, b, _eager_basis(raster, source, geo, b, point), point, g)


def _device_work(cs, fn) -> tuple:
    """(device ms, device operations, {event name: ms}) per call of
    ``fn``: every kernel, memcpy and memset event of a profiler trace of
    REPS calls."""
    import json

    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace = cs.OUT_DIR / "trace_s_with_basis.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict = {}
    for e in events:
        m = re.search(r"(\w+)(?:<[^>(]*>)?\(", e["name"])
        name = m.group(1) if m else e["name"]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / REPS / 1e3
    return (sum(e["dur"] for e in events) / REPS / 1e3, len(events) / REPS,
            by_name)


def _host_ms(fn) -> float:
    """Host ms per call of ``fn`` over REPS calls (the device catches up
    at the end)."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e3 / REPS


def time_binning(e, name: str, tree: str, card: str) -> None:
    """The device ms and wrapper ms of the kernels of ``BINNING`` entry
    ``name`` on its stage, with checkout ``tree``'s code."""
    import torch
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib, binning
    cs = e.cs
    cs.K.update(S=_lib.BIN_RECTS, T=_lib.BIN_COUNT, U=_lib.BIN_EMIT)
    make, letters = BINNING[name]
    stage = make(e)
    S = stage()
    cnt = S["cnt_b"].long()
    keep = torch.clamp(torch.minimum(
        cnt, S["b_i"].shape[0] - (torch.cumsum(cnt, 0) - cnt)), min=0)
    print(f"[binning] {tree}: {name}: {S['n']} rays in {S['nb']} blocks, "
          f"{int(S['pc_total'])} pairs, capacity {S['b_i'].shape[0]}, "
          f"longest row {int(cnt.max())}, rows keeping over 128 pairs "
          f"{int((keep > 128).sum())}", flush=True)
    calls = cs.binning_calls(stage)
    for letter in letters:
        fn = getattr(binning, {"S": "bin_rects", "T": "bin_count",
                               "U": "bin_emit"}[letter])
        a, k = calls[letter][0]
        ms = cs.device_ms(lambda: fn(*a, **k), cs.BIN_KERNELS[letter],
                          letter, REPS)
        # (ms, method) since the method is recorded; a float before
        ms, by = ms if isinstance(ms, tuple) else (ms, "profiler trace")
        call_ms = cs.time_ms(lambda: fn(*a, **k), REPS)
        print(f"[binning] {tree}: {name}: {letter} device {ms:.4f} ms "
              f"({by}), wrapper call {call_ms:.4f} ms [{card}]", flush=True)
        if letter == "S":
            run = _s_with_basis(a, k)
            work_ms, ops, by_name = _device_work(cs, run)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            print(f"[binning] {tree}: {name}: S with its basis: device "
                  f"{work_ms:.4f} ms in {ops:g} device operations, host "
                  f"{_host_ms(run):.4f} ms a call [{card}]; heaviest: "
                  + "; ".join(f"{n[:40]} {ms:.4f}" for n, ms in top),
                  flush=True)


#: route comparisons: name -> function of the setups returning [(label,
#: clusters, incoherent intersector, scene, (o, d, t_min, t_max), W)]
ROUTES = {"bench NEE": _bench_routes, "path pile NEE": _pile_nee}


def run_routes(names: list) -> None:
    """The bundle route against the marcher on each wave of ``ROUTES``
    whose name holds one of ``names`` (all if empty)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    device = torch.device("cuda", 0)
    cs.build_kernels()
    card = cs.card_line()
    e = SimpleNamespace(cs=cs, b=cs.bench_setup(device))
    for name, make in ROUTES.items():
        if names and not any(x in name for x in names):
            continue
        for label, clusters, inc, scene, wave, W in make(e):
            o, d, t_min, t_max = wave
            S, cap = _bundle_schedule(clusters, wave, W)
            pc = int(S["pc_total"])
            run_pc = max(cap, raster.round_pc_max(pc))
            inp = raster.schedule_inputs(clusters, S, S["nb"])
            a_ms = cs.time_ms(lambda: tr.raster_cluster_call(
                **inp, w=W, any_hit=True, common=None), REPS)
            stage_ms = cs.time_ms(lambda: raster.bundle_stage(
                clusters, *wave, W, run_pc), REPS)
            query_ms = cs.time_ms(lambda: raster.bundle_query(
                clusters, *wave, any_hit=True, block_rays=W,
                pc_max=run_pc), REPS)
            march_ms = cs.time_ms(lambda: inc.any_hit(scene, *wave), REPS)
            _, slot, _, _, ok = raster.bundle_query(
                clusters, *wave, any_hit=True, block_rays=W, pc_max=run_pc)
            occ = inc.any_hit(scene, *wave)
            if not ok or not torch.equal(slot >= 0, occ):
                raise AssertionError(f"{label}: the bundle route and the "
                                     f"marcher disagree")
            print(f"[route] {label}: {int((t_max > t_min).sum())} live of "
                  f"{o.shape[0]} rays, {pc} pairs in {S['nb']} blocks of "
                  f"{W} (heuristic capacity {cap}: "
                  f"{'fits' if pc <= cap else 'overflows'}); binning "
                  f"{stage_ms:.3f} ms, A {a_ms:.3f} ms, bundle query "
                  f"{query_ms:.3f} ms, marcher {march_ms:.3f} ms; the "
                  f"same occlusion [{card}]", flush=True)


def build_waves(names: list) -> None:
    """Set the waves up with this checkout and save their arguments."""
    import torch
    waves = {}
    if names:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs
        from optix_ray_tracer_tpu_torch.ops import march
        from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
        device = torch.device("cuda", 0)
        cs.build_kernels()
        b, t = cs.bench_setup(device), cs.time_setup(device)
        tlas = cs.time_frame(t, 0).tlas
        e = SimpleNamespace(cs=cs, b=b, t=t, tlas=tlas, march=march, bm=bm,
                            shadow=cs.tlas_shadow_wave(t, tlas))
    for name in names:
        module, fn, make = WAVES[name]
        kw = make(e)
        rays = kw.get("rays_t_ext", kw.get("rays"))
        n = rays.shape[1] if rays is not None else kw["t_min"].numel()
        print(f"[wave] {name}: {n} rays (with padding)")
        waves[name] = (module, fn, kw)
    WAVE_FILE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(waves, WAVE_FILE)


def build_pairs(names: list) -> None:
    """Save the TLAS pairs (and 1,024 camera rays) that the binning entry
    "S: TLAS camera (pairs)" bins, set up with this checkout, when it is
    among ``names``."""
    import torch
    if not any("pairs" in n for n in names):
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    device = torch.device("cuda", 0)
    cs.build_kernels()
    t = cs.time_setup(device)
    tlas = cs.time_frame(t, 0).tlas
    PAIRS_FILE.parent.mkdir(parents=True, exist_ok=True)
    torch.save((tlas.pair_min, tlas.pair_max, t.o[:1024].contiguous(),
                t.d[:1024].contiguous(), t.o[0].clone()), PAIRS_FILE)
    print(f"[pairs] {tlas.pair_min.shape[0]} TLAS pairs saved", flush=True)


def time_tree(tree: str, binning: list) -> None:
    """Time the kernels of checkout ``tree`` on the saved waves, then S,
    T or U on the ``BINNING`` entries named in ``binning``, then its bench
    step."""
    import importlib
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import torch
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    for mod in (cs, _lib):
        if not str(Path(mod.__file__).resolve()).startswith(tree):
            raise SystemExit(f"kernel_bench: imported {mod.__file__}, not "
                             f"from {tree}")
    card = cs.card_line()
    _lib.load()
    waves = torch.load(WAVE_FILE, map_location="cuda:0", weights_only=True)
    outs = {}
    for name, (module, fn, kw) in waves.items():
        call = getattr(importlib.import_module(
            f"optix_ray_tracer_tpu_torch.ops.kernels.{module}"), fn)
        ms = [cs.time_ms(lambda: call(**kw), REPS) for _ in range(2)]
        print(f"[bench] {tree}: {name}: {ms[0]:.3f} ms, {ms[1]:.3f} ms "
              f"[{card}]", flush=True)
        if module == "tile_raster":
            outs[name] = [x.cpu() for x in call(**kw, visits=True)]
    torch.save(outs, _out_file(tree))
    del waves
    b = cs.bench_setup(torch.device("cuda", 0))
    e = SimpleNamespace(cs=cs, b=b)
    for name in binning:
        time_binning(e, name, tree, card)
    steps = [cs.time_ms(lambda: cs.bench_step(b), REPS) for _ in range(5)]
    print(f"[bench] {tree}: bench step: "
          f"{', '.join(f'{x:.3f}' for x in steps)} ms [{card}]", flush=True)


def _out_file(tree: str) -> Path:
    """Where ``time_tree`` keeps a tree's raster outputs."""
    tag = str(Path(tree).resolve()).strip("/").replace("/", "_")
    return WAVE_FILE.parent / f"out_{tag}.pt"


def compare_outputs(trees: list) -> None:
    """Print, per raster wave, which outputs (t, slot, u, v, Woop-tested
    rows) of each tree equal the first tree's bit for bit (NaN equal to
    NaN)."""
    import torch
    runs = [torch.load(_out_file(t), weights_only=True) for t in trees]
    for name, ref in runs[0].items():
        for tree, run in zip(trees[1:], runs[1:]):
            same = []
            for label, a, b in zip(("t", "slot", "u", "v", "rows"), ref,
                                   run[name]):
                eq = a.shape == b.shape and bool(
                    ((a == b) | (a != a) & (b != b)).all())
                same.append(f"{label} {'equal' if eq else 'DIFFER'}")
            print(f"[same] {name}: {tree} against {trees[0]}: "
                  + ", ".join(same), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append")
    ap.add_argument("--waves", nargs="+")
    ap.add_argument("--routes", nargs="*")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    ap.add_argument("--binning", nargs="*", default=[],
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree:
        time_tree(args.time_tree, args.binning)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    if args.routes is not None:
        run_routes(args.routes)
        return
    names, binning = ([n for n in table
                       if not args.waves or any(x in n for x in args.waves)]
                      for table in (WAVES, BINNING))
    build_waves(names)
    build_pairs(binning)
    trees = [str(Path(t).resolve()) for t in args.tree or [str(ROOT)]]
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--time-tree", tree,
                        "--binning", *binning], check=True)
    compare_outputs(list(dict.fromkeys(trees)))


if __name__ == "__main__":
    main()
