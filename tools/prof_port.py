"""Device-time breakdown of the PyTorch + CUDA port's cells on one NVIDIA
GPU: the bench step (camera wave + point-light shadow wave), the
incoherent 1M-ray wave and the 1024x1024 spp-4 depth-5 Whitted frame,
set up exactly as chip_smoke.py sets them up.

Usage: python3 tools/prof_port.py  (from the repository root; needs CUDA).

For each cell, in this one process: the wall per iteration by CUDA
events with the profiler off (mean of the iterations after a warm-up),
then ``torch.profiler`` over the same number of iterations.  The device
time is the sum of the kernel, memcpy and memset events of the exported
trace (everything runs on one stream, so the events do not overlap);
idle share = 1 - device time / wall.  Prints, per cell, one summary line,
the time per group of kernels and the heaviest kernels by name.  Traces
go to build/prof_port/.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke  # noqa: E402

OUT = Path("build") / "prof_port"
ITERS = {"bench_step": 10, "incoherent_wave": 5, "whitted_frame": 2}


def group(name: str, cat: str) -> str:
    """The breakdown's group of one device event."""
    if cat != "kernel":
        return "memcpy/memset"
    for kernel, label in (("tile_raster_kernel", "A tile_raster"),
                          ("block_march_kernel", "B block_march"),
                          ("probe_kernel", "C probe")):
        if kernel in name:
            return label
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
    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.render import wavefront

    card = chip_smoke.card_line()
    print(card)
    device = torch.device("cuda", 0)
    chip_smoke.build_kernels()
    b = chip_smoke.bench_setup(device)
    inc = b.inter.for_incoherent()
    v, n = sphere_with_n_triangles(chip_smoke.N_TRIS)
    scene, mats, cam, inter = chip_smoke.whitted_setup(v, n, device)
    cells = {
        "bench_step": lambda: chip_smoke.bench_step(b),
        "incoherent_wave": lambda: inc.intersect(b.scene, b.oi, b.di),
        "whitted_frame": lambda: wavefront.render(
            scene, mats, cam, chip_smoke.WIDTH, chip_smoke.HEIGHT,
            spp=chip_smoke.SPP, seed=1, max_depth=chip_smoke.DEPTH,
            intersector=inter)}
    for name, fn in cells.items():
        profile(name, fn, ITERS[name], card)


if __name__ == "__main__":
    main()
