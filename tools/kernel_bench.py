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
after a warm-up, twice; then, per tree, five readings of the mean ms of
``REPS`` bench steps (chip_smoke.py's camera + shadow waves through the
tree's own intersector, host-bound, so its wall spreads from run to
run).

A wave is an entry of ``WAVES``: its name, the wrapper (module under
``optix_ray_tracer_tpu_torch/ops/kernels``, function) and a function of
this checkout's setups that returns the wrapper's keyword arguments.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
WAVE_FILE = ROOT / "build" / "kernel_bench" / "waves.pt"
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
                                  raster.round_pc_max(pc))
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
}


def build_waves(names: list) -> None:
    """Set the waves up with this checkout and save their arguments."""
    import torch
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
    waves = {}
    for name in names:
        module, fn, make = WAVES[name]
        kw = make(e)
        rays = kw.get("rays_t_ext", kw.get("rays"))
        print(f"[wave] {name}: {rays.shape[1]} rays (with padding)")
        waves[name] = (module, fn, kw)
    WAVE_FILE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(waves, WAVE_FILE)


def time_tree(tree: str) -> None:
    """Time the kernels of checkout ``tree`` on the saved waves, then its
    bench step."""
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
    for name, (module, fn, kw) in waves.items():
        call = getattr(importlib.import_module(
            f"optix_ray_tracer_tpu_torch.ops.kernels.{module}"), fn)
        ms = [cs.time_ms(lambda: call(**kw), REPS) for _ in range(2)]
        print(f"[bench] {tree}: {name}: {ms[0]:.3f} ms, {ms[1]:.3f} ms "
              f"[{card}]", flush=True)
    del waves
    b = cs.bench_setup(torch.device("cuda", 0))
    steps = [cs.time_ms(lambda: cs.bench_step(b), REPS) for _ in range(5)]
    print(f"[bench] {tree}: bench step: "
          f"{', '.join(f'{x:.3f}' for x in steps)} ms [{card}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append")
    ap.add_argument("--waves", nargs="+")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree:
        time_tree(args.time_tree)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    names = [n for n in WAVES
             if not args.waves or any(x in n for x in args.waves)]
    build_waves(names)
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--time-tree",
                        str(Path(tree).resolve())], check=True)


if __name__ == "__main__":
    main()
