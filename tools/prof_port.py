"""Device-time breakdown of the PyTorch + CUDA port's cells on one NVIDIA
GPU: the bench step (camera wave + point-light shadow wave), the
incoherent 1M-ray wave, the 1024x1024 spp-4 depth-5 Whitted frame
through the marcher and through the sweep intersector (kernel G), the
frame's denoiser tail (a-trous and neural, 1024x1024), and frame 0 of the
4,096-particle Time scene through the TLAS route and through the flatten
route (same size), set up exactly as chip_smoke.py sets them up; and the
path tracer's cells of chip_smoke.py's phase 11: a config-5 frame
(1920x1088, spp 4, depth 6), a config-4 Cornell frame at spp 1 (1024x1024,
depth 8) and frame 0 of the pile flattened under phase 11's area light
at 1200x800, spp 1, depth 5 (the NEE segments on the bundle engine);
and the same pile frame through ReSTIR DI (``"integrator": "restir"``:
``render_restir_progressive`` at spp 1, 16 candidates, 2 spatial taps,
one primary and one shadow wave).

Usage: python3 tools/prof_port.py [CELL ...]  (from the repository root;
needs CUDA; the named cells only, default all).

For each cell, in this one process: the wall per iteration by CUDA
events with the profiler off (mean of the iterations after a warm-up),
then ``torch.profiler`` over the same number of iterations.  The device
time is the sum of the kernel, memcpy and memset events of the exported
trace (everything runs on one stream, so the events do not overlap);
idle share = 1 - device time / wall.  Prints, per cell, one summary line,
the time per group of kernels (A-U, cuDNN, the torch kernels by kind),
the heaviest int64 elementwise kernels by their functors and the
heaviest kernels by name; for the path tracer's cells, the device ms,
ops and heaviest groups of each ``path.*`` range of ``trace_path``
(:func:`range_split`); for the
three frames through the marchers, the live share (t_max > t_min) of
each bounce wave, counted in one more frame after the profile.  Traces
go to build/prof_port/.
"""

from __future__ import annotations

import json
import re
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke  # noqa: E402

OUT = Path("build") / "prof_port"
ITERS = {"bench_step": 10, "incoherent_wave": 5, "whitted_frame": 2,
         "sweep_frame": 1, "atrous_tail": 5, "neural_tail": 5,
         "tlas_frame": 2, "flatten_frame": 2, "sponza_frame": 2,
         "cornell_frame": 2, "path_pile_frame": 2, "restir_pile_frame": 2}


def _template_args(name: str, kernel: str) -> list[int]:
    """The bool and int template arguments of ``kernel`` in a demangled
    (``kernel<true, 2, false>``) or mangled (``kernelILb1ELi2ELb0E``)
    name, as ints."""
    if f"{kernel}<" in name:
        args = name.split(f"{kernel}<", 1)[1].split(">", 1)[0].split(",")
        words = {"true": 1, "false": 0}
        return [words[a.strip()] if a.strip() in words
                else int(a.strip().rstrip("u")) for a in args]
    m = re.search(kernel + r"I((?:L[bi]\d+E)+)", name)
    return [int(x) for x in re.findall(r"L[bi](\d+)E", m.group(1))] \
        if m else []


def group(name: str, cat: str) -> str:
    """The breakdown's group of one device event."""
    if cat != "kernel":
        return "memcpy/memset"
    if "warp_raster_kernel" in name:   # <ANY_HIT, COMMON, INST>
        args = _template_args(name, "warp_raster_kernel")
        return "D tile_raster_inst" if args and args[-1] else "A tile_raster"
    if "bundle_raster_kernel" in name:   # A with no common origin or dir
        return "A tile_raster"
    if "warp_march_kernel" in name:    # <ANY_HIT, INST, HIER>
        args = _template_args(name, "warp_march_kernel") or [False] * 3
        return ("F block_march_hier" if args[2] else
                "E block_march_inst" if args[1] else "B block_march")
    if "probe_kernel" in name:
        return "C probe"
    if "leaf_sweep_kernel" in name:
        return "G leaf_sweep"
    if "pcg4d_kernel" in name:
        return "H pcg4d"
    if "sobol_owen4_kernel" in name:
        return "I sobol_owen4"
    if "whitted_scatter_kernel" in name:
        return "J whitted_scatter"
    if "path_bsdf_kernel" in name:
        return "K path_bsdf"
    if "path_nee_sample_kernel" in name:
        return "L path_nee_sample"
    if "path_nee_add_kernel" in name:
        return "M path_nee_add"
    if "path_hit_radiance_kernel" in name:
        return "N path_hit_radiance"
    if "march_keys_kernel" in name:
        return "O march_keys"
    if "gather_rays_kernel" in name:
        return "P gather_rays"
    if "finish_hits_kernel" in name:
        return "Q finish_hits"
    if "shading_frame_kernel" in name:
        return "R shading_frame"
    if "bin_rects_kernel" in name:
        return "S bin_rects"
    if "bin_count_kernel" in name:
        return "T bin_count"
    if "bin_emit_kernel" in name:
        return "U bin_emit"
    if any(k in name.lower() for k in ("conv", "xmma", "implicit", "gemm",
                                        "winograd", "cudnn")):
        return "convolution (cuDNN)"
    if "sort" in name.lower():
        return "sort"
    if any(k in name for k in ("gather", "index", "scatter")):
        return "gather/index/scatter"
    if "reduce" in name.lower() or "scan" in name.lower():
        return "reductions/scans"
    if "elementwise" in name and "long" in name:
        return "int64 elementwise"
    if any(k in name for k in ("elementwise", "Cat", "copy", "fill")):
        return "other elementwise, cat, copies"
    return "other"


def profile(name: str, fn, iters: int, card: str) -> None:
    wall = chip_smoke.time_ms(fn, iters)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    OUT.mkdir(parents=True, exist_ok=True)
    trace = OUT / f"trace_{name}.json"
    prof.export_chrome_trace(str(trace))
    trace_events = json.loads(trace.read_text())["traceEvents"]
    events = [e for e in trace_events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    groups: dict[str, float] = defaultdict(float)
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in events:
        ms = e["dur"] / 1e3 / iters
        groups[group(e["name"], e["cat"])] += ms
        kernels[e["name"]][0] += ms
        kernels[e["name"]][1] += 1
    busy = sum(groups.values())
    print(f"=== {name}: wall {wall:.3f} ms/iter (profiler off), device "
          f"{busy:.3f} ms/iter, idle share {1 - busy / wall:.3f}, "
          f"{len(events) / iters:.0f} device ops/iter, {iters} iters "
          f"[{card}]")
    for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {label}")
    int64 = sorted(((ms, name) for name, (ms, _) in kernels.items()
                    if group(name, "kernel") == "int64 elementwise"),
                   reverse=True)[:4]
    if int64:
        print("  heaviest int64 elementwise kernels (their functors):")
        for ms, kname in int64:
            ops = dict.fromkeys(re.findall(r"\w*(?:Functor|_kernel_cuda)\w*",
                                           kname))
            print(f"    {ms:9.3f} ms  {', '.join(ops) or kname[:90]}")
    print("  heaviest kernels:")
    for kname, (ms, count) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms  x {count / iters:6.1f}  {kname[:90]}")
    ranges = range_split(trace_events, events, iters)
    if ranges:
        print("  trace_path ranges (device ms, ops per iter; the five "
              "heaviest groups):")
        for label, (ms, ops, by_group) in sorted(ranges.items(),
                                                 key=lambda kv: -kv[1][0]):
            top = sorted(by_group.items(), key=lambda kv: -kv[1])[:5]
            print(f"    {ms:9.3f} ms  {ops:8.0f} ops  {label}: " + "; ".join(
                f"{g} {g_ms:.3f}" for g, g_ms in top))


def range_split(trace_events: list, device_events: list, iters: int):
    """Device ms, device ops and ms per group of each ``record_function``
    range named ``path.*`` (``render/pathtracer.trace_path``'s sections;
    ``path.area_nee.query`` and ``path.env_nee.query`` its NEE shadow
    queries), per iteration: a device event belongs to the innermost
    range around the host call that launched it (matched by CUPTI
    correlation id), or to
    "(outside the ranges)"."""
    import bisect
    ranges: dict[int, list] = defaultdict(list)
    for e in trace_events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("path.")):
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                     e["name"]))
    if not ranges:
        return {}
    for rs in ranges.values():
        rs.sort()
    launch = {e["args"]["correlation"]: e for e in trace_events
              if e.get("ph") == "X"
              and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out: dict[str, list] = {}
    for e in device_events:
        host = launch.get(e.get("args", {}).get("correlation"))
        label = "(outside the ranges)"
        if host is not None:
            rs = ranges.get(host["tid"], [])
            k = bisect.bisect_right(rs, (host["ts"], float("inf"), "")) - 1
            # the innermost range that holds the launch: the latest start
            # before it whose end lies after it (ranges nest)
            while k >= 0 and not rs[k][0] <= host["ts"] <= rs[k][1]:
                k -= 1
            if k >= 0:
                label = rs[k][2]
        ms = e["dur"] / 1e3 / iters
        cell = out.setdefault(label, [0.0, 0.0, defaultdict(float)])
        cell[0] += ms
        cell[1] += 1 / iters
        cell[2][group(e["name"], e["cat"])] += ms
    return {k: tuple(v) for k, v in out.items()}


def path_cells(t, device):
    """Callables of the path tracer's cells: config 5 and config 4 (spp 1)
    through ``benchmarks.run``, and frame 0 of the Time scene's flatten
    route with phase 11's area light over the pile (``render_path``,
    1200x800, spp 1, depth 5), and the same frame through ReSTIR DI."""
    from optix_ray_tracer_tpu_torch.models import benchmarks
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    from optix_ray_tracer_tpu_torch.render import pathtracer, restir

    c5 = benchmarks.config5_sponza_class(device=device)
    i5 = choose_intersector(c5["scene"])
    c4 = benchmarks.config4_cornell(device=device)
    i4 = choose_intersector(c4["scene"])
    scene, mats, lights, inter = chip_smoke.path_pile_scene(t)
    w, h = chip_smoke.ANIM_WIDTH, chip_smoke.ANIM_HEIGHT
    return (lambda: benchmarks.run(c5, intersector=i5),
            lambda: benchmarks.run(c4, spp=1, intersector=i4),
            lambda: pathtracer.render_path(
                scene, mats, lights, t.cam, w, h, spp=1, seed=1,
                max_depth=chip_smoke.DEPTH, intersector=inter),
            lambda: restir.render_restir_progressive(
                scene, mats, lights, t.cam, w, h, spp=1, seed=1,
                intersector=inter))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prof_port: no CUDA device")
    from types import SimpleNamespace

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops.sweep import SweepIntersector
    from optix_ray_tracer_tpu_torch.render import wavefront

    card = chip_smoke.card_line()
    print(card)
    device = torch.device("cuda", 0)
    chip_smoke.build_kernels()
    b = chip_smoke.bench_setup(device)
    inc = b.inter.for_incoherent()
    v, n = sphere_with_n_triangles(chip_smoke.N_TRIS)
    scene, mats, cam, inter = chip_smoke.whitted_setup(v, n, device)
    t = chip_smoke.time_setup(device)
    tlas = chip_smoke.time_frame(t, 0, t.pc_max1)
    sponza, cornell, pile, restir_pile = path_cells(t, device)

    def frame(scene_, mats_, cam_, inter_):
        return lambda: wavefront.render(
            scene_, mats_, cam_, chip_smoke.WIDTH, chip_smoke.HEIGHT,
            spp=chip_smoke.SPP, seed=1, max_depth=chip_smoke.DEPTH,
            intersector=inter_)

    img, alb, nrm = frame(scene, mats, cam, inter)()
    tail = SimpleNamespace(img=img, alb=alb, nrm=nrm)
    cells = {
        "bench_step": lambda: chip_smoke.bench_step(b),
        "incoherent_wave": lambda: inc.intersect(b.scene, b.oi, b.di),
        "whitted_frame": frame(scene, mats, cam, inter),
        "sweep_frame": frame(scene, mats, cam,
                             SweepIntersector(clusters=inter.clusters)),
        "atrous_tail": chip_smoke.tail_setup(tail, "atrous"),
        "neural_tail": chip_smoke.tail_setup(tail, "neural"),
        "tlas_frame": frame(t.static, t.mats, t.cam, tlas),
        "flatten_frame": frame(t.flat, t.mats, t.cam, t.finter),
        "sponza_frame": sponza, "cornell_frame": cornell,
        "path_pile_frame": pile, "restir_pile_frame": restir_pile}
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    counted = {"whitted_frame": "probe_call", "flatten_frame": "probe_call",
               "tlas_frame": "march_instanced_call"}
    only = sys.argv[1:]
    unknown = set(only) - set(cells)
    if unknown:
        raise SystemExit(f"prof_port: unknown cells {sorted(unknown)}; "
                         f"cells: {', '.join(cells)}")
    for name, fn in cells.items():
        if only and name not in only:
            continue
        profile(name, fn, ITERS[name], card)
        if name in counted:
            with chip_smoke.calls_of(bm, counted[name]) as live:
                fn()
            print(f"  live share of bounce waves 1-{chip_smoke.DEPTH - 1}: "
                  f"{chip_smoke.shares(live)}")


if __name__ == "__main__":
    main()
