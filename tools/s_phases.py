"""Where kernel S's time goes on the card: the phases of its CTAs on the
bench camera wave's S call (chip_smoke.py's bench scene, g 4, the camera
origin in device memory), read from the device's global timer.

Usage, from the repository root (needs CUDA and nvcc):
python3 tools/s_phases.py

Builds ``csrc/binning.cu`` alone with ``ORT_S_PHASES`` defined into
``build/s_phases/`` (thread 0 of each CTA stamps each phase,
``S_PHASE`` in the source; the library the port loads has no stamps),
routes the binning wrapper to it, times the call by CUDA events
(stamped and, for comparison, the port's own build), and prints for
each phase, over the CTAs that reached it, the first, median and last
time after the first CTA started: 0 start, 1 arrived (after its share,
for a sum role), 2 the thread's rows summed (the sum roles), 3 the CTA's
partial posted, 8 the columns summed and 4 the basis folded (the last
CTA to arrive), 5 the basis read, 6 the CTA's (last) cluster staged, 7
rects stored.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from optix_ray_tracer_tpu_torch.ops.kernels import _lib, binning  # noqa: E402

OUT = Path("build") / "s_phases"
PHASES = ("start", "arrived", "rows summed", "partial posted",
          "basis folded", "basis read", "geometry staged", "rects stored",
          "columns summed")
CTAS, SLOTS = 8192, 10          # csrc/binning.cu kPhaseCtas, kPhaseSlots


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libbinning_phases.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-DORT_S_PHASES",
                    "-shared", "-o", str(so), str(_lib.CSRC / "binning.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.ort_bin_rects.argtypes = _lib.BIN_RECTS.argtypes + [ctypes.c_void_p]
    lib.ort_bin_rects.restype = ctypes.c_int
    lib.ort_s_phases.argtypes = [ctypes.c_void_p]
    lib.ort_s_phases.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("s_phases: no CUDA device")
    card = chip_smoke.card_line()
    device = torch.device("cuda", 0)
    chip_smoke.build_kernels()
    b = chip_smoke.bench_setup(device)
    call = lambda: binning.bin_rects_call(     # noqa: E731
        binning.RECTS_CLUSTER, b.inter.raster.verts, point=b.o[0],
        granularity=4)
    port_ms = chip_smoke.time_ms(call, chip_smoke.REPS)
    lib = build()
    port_lib = _lib._lib
    _lib._lib = lib                           # the wrapper launches from lib
    try:
        stamped_ms = chip_smoke.time_ms(call, chip_smoke.REPS)
        buf = np.zeros((CTAS, SLOTS), np.uint64)
        for _ in range(3):
            if lib.ort_s_phases(buf.ctypes.data):
                raise RuntimeError("s_phases: reading the stamps failed")
            call()
            torch.cuda.synchronize()
            if lib.ort_s_phases(buf.ctypes.data):
                raise RuntimeError("s_phases: reading the stamps failed")
            report(buf)
    finally:
        _lib._lib = port_lib
    print(f"[s_phases] the call by CUDA events: {port_ms:.4f} ms a call "
          f"(the port's build), {stamped_ms:.4f} ms stamped [{card}]")


def report(buf) -> None:
    rows = buf[buf[:, 0] != 0].astype(np.int64)
    t0 = rows[:, 0].min()
    print(f"[s_phases] {rows.shape[0]} CTAs on {len(set(rows[:, 9]))} SMs, "
          f"{int((rows[:, 2] != 0).sum())} sum roles; phase: first / "
          f"median / last us after the first start (CTAs)")
    for k, name in enumerate(PHASES):
        t = rows[:, k][rows[:, k] != 0] - t0
        if name is None or t.size == 0:
            continue
        print(f"  {k} {name:16s} {t.min() / 1e3:8.3f} "
              f"{np.median(t) / 1e3:8.3f} {t.max() / 1e3:8.3f} ({t.size})")


if __name__ == "__main__":
    main()
