"""Device-time breakdown of the PyTorch + CUDA port's cells on one NVIDIA
GPU: the bench step (camera wave + point-light shadow wave), the
incoherent 1M-ray wave, the 1024x1024 spp-4 depth-5 Whitted frame
through the marcher and through the sweep intersector (kernel G), the
frame's denoiser tail (a-trous and neural, 1024x1024), and frame 0 of the
4,096-particle Time scene through the TLAS route and through the flatten
route (same size), set up exactly as chip_smoke.py sets them up.

Usage: python3 tools/prof_port.py  (from the repository root; needs CUDA).

For each cell, in this one process: the wall per iteration by CUDA
events with the profiler off (mean of the iterations after a warm-up),
then ``torch.profiler`` over the same number of iterations.  The device
time is the sum of the kernel, memcpy and memset events of the exported
trace (everything runs on one stream, so the events do not overlap);
idle share = 1 - device time / wall.  Prints, per cell, one summary line,
the time per group of kernels and the heaviest kernels by name; for the
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
         "tlas_frame": 2, "flatten_frame": 2}


def _template_args(name: str, kernel: str) -> list[bool]:
    """The bool template arguments of ``kernel`` in a demangled
    (``kernel<true, false>``) or mangled (``kernelILb1ELb0E``) name."""
    if f"{kernel}<" in name:
        args = name.split(f"{kernel}<", 1)[1].split(">", 1)[0]
        return [a.strip() == "true" for a in args.split(",")]
    m = re.search(kernel + r"I((?:Lb[01]E)+)", name)
    return [b == "1" for b in re.findall(r"Lb([01])E", m.group(1))] \
        if m else []


def group(name: str, cat: str) -> str:
    """The breakdown's group of one device event."""
    if cat != "kernel":
        return "memcpy/memset"
    if "warp_raster_kernel" in name:   # <ANY_HIT, COMMON_ORIGIN, INST>
        args = _template_args(name, "warp_raster_kernel")
        return "D tile_raster_inst" if args and args[-1] else "A tile_raster"
    if "warp_march_kernel" in name:    # <ANY_HIT, INST, HIER>
        args = _template_args(name, "warp_march_kernel") or [False] * 3
        return ("F block_march_hier" if args[2] else
                "E block_march_inst" if args[1] else "B block_march")
    if "probe_kernel" in name:
        return "C probe"
    if "leaf_sweep_kernel" in name:
        return "G leaf_sweep"
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
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"
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
    print("  heaviest kernels:")
    for kname, (ms, count) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms  x {count / iters:6.1f}  {kname[:90]}")


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
        "flatten_frame": frame(t.flat, t.mats, t.cam, t.finter)}
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    counted = {"whitted_frame": "probe_call", "flatten_frame": "probe_call",
               "tlas_frame": "march_instanced_call"}
    for name, fn in cells.items():
        profile(name, fn, ITERS[name], card)
        if name in counted:
            with chip_smoke.calls_of(bm, counted[name]) as live:
                fn()
            print(f"  live share of bounce waves 1-{chip_smoke.DEPTH - 1}: "
                  f"{chip_smoke.shares(live)}")


if __name__ == "__main__":
    main()
