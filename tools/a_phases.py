"""Where kernel A's time goes on a bundle wave: the CTAs of its bundle
walk on the path pile's first NEE wave (chip_smoke.py phase 11 (c), frame
0, bounce 0, any-hit, full-width dots), read from the device's global
timer.

Usage, from the repository root (needs CUDA and nvcc):
python3 tools/a_phases.py

Captures the wave as ``tools/kernel_bench.py``'s ``_pile_nee`` does (one
CLI frame), bins it at the capacity its pairs need, then builds
``csrc/tile_raster.cu`` alone with ``ORT_A_PHASES`` defined into
``build/a_phases/`` (``A_STAMP`` in the source; the library the port
loads has no stamps), routes the raster wrapper to it, times the call by
CUDA events (the port's build and the stamped one) and prints, over the
CTAs that ran (the units): the span, when the units ended, the units by
live lanes and by pairs, the SMs' busy time, the last units to end, and
how many Woop tests were on rays that entered the part themselves and on
rays whose search was still open; before that, the port's ms a call
and its Woop tests run against the ones the answers need
(``needed_raster_work``).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import kernel_bench  # noqa: E402
from optix_ray_tracer_tpu_torch.ops import raster  # noqa: E402
from optix_ray_tracer_tpu_torch.ops.kernels import _lib  # noqa: E402
from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr  # noqa: E402,E501

OUT = ROOT / "build" / "a_phases"
UNITS, SLOTS = 65536, 10        # csrc/tile_raster.cu kPhaseUnits, kPhaseSlots
START, END, TILE, GROUP, PAIRS, LIVE, TESTS, SM, OWN, OPEN = range(10)


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libtile_raster_phases.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-DORT_A_PHASES",
                    "-shared", "-o", str(so),
                    str(_lib.CSRC / "tile_raster.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for kernel in (_lib.TILE_RASTER, _lib.TILE_RASTER_INSTANCED):
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    lib.ort_a_phases.argtypes = [ctypes.c_void_p]
    lib.ort_a_phases.restype = ctypes.c_int
    return lib


def wave() -> tuple:
    """(raster_cluster_call's arguments, W, the schedule) of the pile's
    first NEE wave."""
    e = SimpleNamespace(cs=chip_smoke)
    _, clusters, _, _, rays, W = kernel_bench._pile_nee(e)[0]
    S, _ = kernel_bench._bundle_schedule(clusters, rays, W)
    inp = raster.schedule_inputs(clusters, S, S["nb"])
    return dict(inp, w=W, any_hit=True, common=None), W, S


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("a_phases: no CUDA device")
    card = chip_smoke.card_line()
    chip_smoke.build_kernels()
    kw, W, S = wave()
    cnt = S["cnt_b"].long()
    live = int((S["tmax_p"] > S["tmin_p"]).sum())
    print(f"[a_phases] wave: {S['n']} rays, {live} live, {S['nb']} tiles of "
          f"{W}, {int(cnt.sum())} pairs, mean row {cnt.float().mean():.1f}, "
          f"longest {int(cnt.max())}, tiles with no pair "
          f"{int((cnt == 0).sum())}")
    call = lambda: tr.raster_cluster_call(**kw)   # noqa: E731
    inp = {k: v for k, v in kw.items() if k not in ("w", "any_hit", "common")}
    port_ms = chip_smoke.time_ms(call, chip_smoke.REPS)
    out = tr.raster_cluster_call(**kw, visits=True)
    needed = tr.needed_raster_work(inp, W, out[0], out[1],
                                   any_hit=kw["any_hit"])["woop"]
    run = int(out[4].sum())              # the bundle walk counts its tests
    print(f"[a_phases] {port_ms:.4f} ms a call (CUDA events); Woop tests "
          f"run {run}, needed {needed} ({run / max(needed, 1):.2f}x) "
          f"[{card}]", flush=True)
    port_lib = _lib._lib
    try:
        lib = _lib._lib = build()
        stamped_ms = chip_smoke.time_ms(call, chip_smoke.REPS)
        buf = np.zeros((UNITS, SLOTS), np.uint64)
        if lib.ort_a_phases(buf.ctypes.data):
            raise RuntimeError("a_phases: reading the stamps failed")
        call()
        torch.cuda.synchronize()
        if lib.ort_a_phases(buf.ctypes.data):
            raise RuntimeError("a_phases: reading the stamps failed")
        print(f"[a_phases] {stamped_ms:.4f} ms a call stamped [{card}]")
        report(buf)
    finally:
        _lib._lib = port_lib


def _us(x) -> str:
    return f"{x / 1e3:9.2f}"


def report(buf) -> None:
    rows = buf[buf[:, START] != 0].astype(np.int64)
    if rows.shape[0] == 0:
        print("[a_phases] no unit stamped")
        return
    t0 = rows[:, START].min()
    start, end = rows[:, START] - t0, rows[:, END] - t0
    dur = end - start
    print(f"[a_phases] {rows.shape[0]} units on {len(set(rows[:, SM]))} "
          f"SMs; span {end.max() / 1e3:.2f} us after the first start")
    q = np.percentile(end, [50, 90, 99, 100])
    print("  units ended by (us): 50% " + ", 90% ".join(
        f"{x / 1e3:.2f}" for x in q[:2]) + f", 99% {q[2] / 1e3:.2f}, "
        f"all {q[3] / 1e3:.2f}")
    run = int(rows[:, TESTS].sum())
    if rows[:, OWN].any():
        own, open_ = int(rows[:, OWN].sum()), int(rows[:, OPEN].sum())
        print(f"  Woop tests run {run}: the lane's own entry passed {own} "
              f"({own / run:.3f}), its search still open {open_} "
              f"({open_ / run:.3f})")
    live = rows[:, LIVE]
    for name, m in (("no live lane", live == 0), ("live lanes", live > 0)):
        if m.any():
            print(f"  {name}: {int(m.sum())} units, duration mean "
                  f"{dur[m].mean() / 1e3:.2f} us, sum {dur[m].sum() / 1e6:.3f}"
                  f" ms, Woop tests {int(rows[m, TESTS].sum())}")
    pairs = rows[:, PAIRS]
    for lo, hi in ((0, 0), (1, 32), (33, 128), (129, 512), (513, 1 << 30)):
        m = (pairs >= lo) & (pairs <= hi)
        if m.any():
            print(f"  pairs {lo}-{min(hi, int(pairs.max()))}: {int(m.sum())} "
                  f"units, duration mean {dur[m].mean() / 1e3:.2f} us, max "
                  f"{dur[m].max() / 1e3:.2f}, last end {end[m].max() / 1e3:.2f}"
                  f" us; us a pair {np.median(dur[m] / np.maximum(pairs[m], 1)) / 1e3:.3f}")
    busy = np.zeros(int(rows[:, SM].max()) + 1)
    np.add.at(busy, rows[:, SM], dur)
    busy = busy[busy > 0]
    print(f"  unit-time per SM (us): min {busy.min() / 1e3:.1f}, median "
          f"{np.median(busy) / 1e3:.1f}, max {busy.max() / 1e3:.1f}")
    print("  last to end: tile group pairs live tests start end (us)")
    for i in np.argsort(-end)[:8]:
        r = rows[i]
        print(f"    {r[TILE]:6d} {r[GROUP]:4d} {r[PAIRS]:6d} {r[LIVE]:5d} "
              f"{r[TESTS]:7d} {_us(start[i])} {_us(end[i])}")


if __name__ == "__main__":
    main()
