"""The path tracer's frames of two or more checkouts, timed in one call on
one NVIDIA GPU: the wall per frame, the device time, ops and idle share,
the host time of each ``path.*`` range of ``trace_path`` and the host
cost of each bounce-step dispatcher per call.

Usage, from the repository root (needs CUDA):

    python3 tools/path_ab.py [--tree DIR ...] [--cells NAME ...]

Each ``--tree`` (default: this checkout; repeat it for parent, change,
change, parent, with the parent a ``git archive`` unpacked under
``build/``) runs in a process of its own that imports the port and
``chip_smoke.py`` from DIR and builds DIR's kernel sources.  The cells
are ``benchmarks.run`` of ``config4_cornell`` at spp 1 ("cornell",
1024x1024, depth 8) and of ``config5_sponza_class`` ("sponza", 1920x1088,
spp 4, depth 6), set up as ``tools/prof_port.py`` sets them up.  Per tree
and cell it prints:

- the wall per frame by CUDA events with the profiler off, three
  readings, each the mean of ``ITERS`` frames after a warm-up;
- with ``torch.profiler`` over ``PROF_ITERS`` frames: the device ms and
  ops per frame (kernel, memcpy and memset events) and the idle share
  against the first wall reading; the host ms per frame of each
  ``path.*`` range (its ``record_function`` span on the host; the
  profiler adds its own cost to every op inside, so these overstate a
  range that launches many ops);
- with the profiler off, the mean host ms per call of each of
  ``pathtracer``'s dispatchers ``bsdf_step``, ``nee_sample``,
  ``nee_add`` and ``hit_radiance`` that the tree has (from entry to
  return: argument checks and launches, no synchronisation).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "path_ab"
ITERS = {"cornell": 20, "sponza": 5}
PROF_ITERS = {"cornell": 5, "sponza": 2}
STEPS = ("bsdf_step", "nee_sample", "nee_add", "hit_radiance")


def cell(name: str, device):
    """A callable that renders one frame of the cell."""
    from optix_ray_tracer_tpu_torch.models import benchmarks
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    if name == "cornell":
        cfg = benchmarks.config4_cornell(device=device)
        inter = choose_intersector(cfg["scene"])
        return lambda: benchmarks.run(cfg, spp=1, intersector=inter)
    cfg = benchmarks.config5_sponza_class(device=device)
    inter = choose_intersector(cfg["scene"])
    return lambda: benchmarks.run(cfg, intersector=inter)


def profile_split(fn, iters: int, trace: Path) -> tuple:
    """(device ms, ops, {range: host ms}) per frame over ``iters``
    frames."""
    import torch
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ranges: dict[str, float] = defaultdict(float)
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("path.")):
            ranges[e["name"]] += e["dur"] / 1e3 / iters
    return (sum(e["dur"] for e in device) / 1e3 / iters,
            len(device) / iters, dict(ranges))


def step_host_ms(fn) -> dict:
    """Mean host ms per call of each dispatcher of ``STEPS`` that the
    tree's ``pathtracer`` has, over one frame."""
    import torch

    from optix_ray_tracer_tpu_torch.render import pathtracer
    spent: dict[str, list] = {}
    real = {name: getattr(pathtracer, name) for name in STEPS
            if hasattr(pathtracer, name)}

    def timed(name, f):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = f(*a, **k)
            spent.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    for name, f in real.items():
        setattr(pathtracer, name, timed(name, f))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, f in real.items():
            setattr(pathtracer, name, f)
    return {name: (1e3 * sum(ts) / len(ts), len(ts))
            for name, ts in spent.items()}


def time_tree(tree: str, cells: list[str]) -> None:
    """Time the cells with checkout ``tree``'s port."""
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import torch

    import optix_ray_tracer_tpu_torch as port
    for mod in (cs, port):
        if not str(Path(mod.__file__).resolve()).startswith(tree):
            raise SystemExit(f"path_ab: imported {mod.__file__}, not from "
                             f"{tree}")
    card = cs.card_line()
    cs.build_kernels()
    device = torch.device("cuda", 0)
    tag = Path(tree).name
    for name in cells:
        fn = cell(name, device)
        walls = [cs.time_ms(fn, ITERS[name]) for _ in range(3)]
        busy, ops, ranges = profile_split(
            fn, PROF_ITERS[name], OUT / f"trace_{tag}_{name}.json")
        steps = step_host_ms(fn)
        print(f"[path_ab] {tree}: {name}: wall "
              f"{', '.join(f'{w:.3f}' for w in walls)} ms/frame (profiler "
              f"off, {ITERS[name]} frames each), device {busy:.3f} ms/frame, "
              f"{ops:.0f} ops/frame, idle share {1 - busy / walls[0]:.3f} "
              f"[{card}]", flush=True)
        print(f"[path_ab] {tree}: {name}: host ms/frame by range "
              f"(profiler on): " + "; ".join(
                  f"{k} {v:.3f}" for k, v in sorted(ranges.items())),
              flush=True)
        print(f"[path_ab] {tree}: {name}: host ms per dispatcher call "
              f"(profiler off): " + "; ".join(
                  f"{k} {ms:.4f} x {n}" for k, (ms, n) in steps.items()),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append")
    ap.add_argument("--cells", nargs="+", default=list(ITERS),
                    choices=list(ITERS))
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree:
        time_tree(args.time_tree, args.cells)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("path_ab: no CUDA device")
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--time-tree",
                        str(Path(tree).resolve()), "--cells", *args.cells],
                       check=True)


if __name__ == "__main__":
    main()
